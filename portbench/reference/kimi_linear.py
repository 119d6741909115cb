"""Plain reference of the ``tx`` classifier's ``kda_mla_moe`` block:
Kimi-Linear-48B-A3B's (Kimi Linear's hybrid of Kimi Delta Attention and
latent attention, with DeepSeek-V3's expert layer), in float32 ``torch``
operations on a batch of sequences. It imports nothing of the program.

The forward pass of a sequence of token ids:

- ``x = embed[tokens]``;
- each layer i: ``x += ATT(rms(x))``, then ``x += FFN(rms(x))``; ATT is
  latent attention where (i + 1) mod ``full_attn_every`` = 0 and Kimi
  Delta Attention elsewhere; FFN a SwiGLU MLP in the first
  ``first_k_dense_replace`` layers and the expert layer after them;
- Kimi Delta Attention (the Kimi Linear technical report,
  arXiv:2510.26692; flash-linear-attention's ``KimiDeltaAttention``),
  ``linear_num_heads`` heads of key and value width ``linear_head_dim``
  (e): ``q, k, v = silu(conv(x W))``, each projection through a causal
  depthwise convolution of width ``short_conv_kernel_size``; q and k
  L2-normalised per head (ε = 1e-6); ``β = sigmoid(x W_b)`` a head;
  ``g = −exp(A_log) · softplus(x W_f1 W_f2 + dt_bias)`` a key channel;
  token by token ``S_t = (I − β_t k_t k_tᵀ) Diag(exp g_t) S_{t−1} + β_t
  k_t v_tᵀ`` from ``S_0 = 0`` and ``o_t = S_tᵀ q_t / sqrt(e)``; the
  output ``W_o [rms(o_t) ⊙ sigmoid(x W_g1 W_g2 + b_g)]`` over the heads,
  the norm over a head's e values with one scale all heads share;
- latent attention without positions (``mla_use_nope``): ``q = x W_q``
  per head (``qk_nope_head_dim + qk_rope_head_dim`` wide), ``[c, k_pe] =
  x W_kva``, ``c = rms(c)``, ``[k_nope, v] = c W_kvb`` per head, scores
  ``q · [k_nope, k_pe]`` (``k_pe`` shared by the heads, not rotated)
  scaled by 1/sqrt of that width, causal, softmax, the heads'
  ``v_head_dim``-wide outputs through ``W_o``;
- the expert layer: ``s = sigmoid(x W_r)`` over all ``n_routed_experts``,
  the token's experts the top ``num_experts_per_tok`` of ``s + b`` (``b``
  the correction bias, for selection only), gates the chosen ``s`` over
  their sum times ``routed_scaling_factor``; of the routed experts only
  the share ``[expert_share · held, (expert_share + 1) · held)`` is held
  (``experts_held``; 0 holds all), and the output is ``shared(x) + Σ
  g_i E_i(x)`` over the chosen experts held, every expert a SwiGLU;
- the head: ``rms(x)``, mean over the sequence, ``W_h``, ``b_h``.

The loss of a batch is the mean over its sequences of the cross-entropy
plus α times each expert layer's sequence-wise balance loss ``Σ_i f_i
P_i`` over all experts (``f_i`` = E / (K·T) times the sequence's tokens
choosing expert i, ``P_i`` the sequence's mean of ``s_i / Σ_j s_j``).
Gradients come by autograd of that loss, summed over the batch's
sequences. A step is Adam (optax's order, written out), then ``b_i += γ ·
sign(mean − load_i)`` with the loads over the batch.

Departures from the published model:

- the head is the ``tx`` family's mean-pooled classifier over the final
  norm's output, in place of the LM head over the vocabulary;
- the optimizer is Adam, in place of Muon;
- the layers alternate by period, layer i full attention where (i + 1)
  mod ``full_attn_every`` = 0: the published list (4, 8, …, 24 and 27,
  counted from 1) agrees on layers 1–26;
- the leaves are laid out as the ``tx`` family's flat dict (``q_proj``
  (d, H, e), ``q_conv`` (H, e, K), ``f_a`` (d, e), ``f_b`` (e, H, e),
  ``o_proj`` (H, e, d), ``wq`` (d, H, n + R), ``wkv_b`` (r, H, n + v),
  ``wo`` (H, v, d), experts stacked (held, d, I)), the transposes of the
  modeling code's ``nn.Linear`` weights;
- parameters are drawn from one seeded generator, leaf by leaf in
  ``leaf_shapes`` order: ``a_log`` = log A with A ~ U(0, 16) a head;
  ``dt_bias`` = dt + log(−expm1(−dt)) with dt = exp(U(log 1e-3, log
  1e-1)) floored at 1e-4 a channel (flash-linear-attention's gated-delta
  init); ones for a norm's scale; zeros for the correction bias, the
  output gate's bias and the head's bias; normal with std 0.02 for every
  matrix and convolution weight.

Computed in blocks where asked: a batch's sequences together, but for
the attention, one sequence at a time with its scores a key chunk at a
time in two passes (the query's maximum, then the exponentials and their
sums) and, with a gradient, recomputed in the backward pass; the
recurrence, every sequence's heads in one batch of small products, in
segments of ``segment`` tokens whose steps the backward pass recomputes
(so 8,192 tokens fit); and each layer recomputed in the backward pass
where ``remat`` is set. The recomputations are ``torch.utils.checkpoint``'s
reentrant form: the first pass runs without a gradient, so the
recurrence's thousands of small steps keep no graph and call no hook
(gradients reach the parameters through ``backward``).
``dtype`` runs the forward pass in a lower precision (the weights cast
at their use, the gradients and Adam in float32): the control of the
comparison.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
INIT_STD = 0.02
L2_EPS = 1e-6


@dataclass(frozen=True)
class Config:
    vocab: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    n_classes: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    n_routed_experts: int
    n_shared_experts: int
    num_experts_per_tok: int
    moe_intermediate_size: int
    first_k_dense_replace: int
    routed_scaling_factor: float
    rms_norm_eps: float
    linear_num_heads: int
    linear_head_dim: int
    short_conv_kernel_size: int
    full_attn_every: int
    experts_held: int = 0
    expert_share: int = 0
    causal: bool = True
    #: DeepSeek-V3's technical report's balance-loss α and bias step γ.
    aux_loss_alpha: float = 1e-4
    bias_update_speed: float = 1e-3


def config(**kw) -> Config:
    """A Config from any mapping holding its fields (others ignored)."""
    return Config(**{f.name: kw[f.name] for f in fields(Config)
                     if f.name in kw})


def held_experts(cfg: Config) -> Tuple[int, int]:
    """(the first expert held, the number held)."""
    held = cfg.experts_held or cfg.n_routed_experts
    return cfg.expert_share * held, held


def full_attention(cfg: Config, i: int) -> bool:
    return (i + 1) % cfg.full_attn_every == 0


def leaf_shapes(cfg: Config) -> Dict[str, tuple]:
    """Every leaf's shape, in the order they are drawn."""
    d, H, E = cfg.d_model, cfg.n_heads, cfg.n_routed_experts
    r, R = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    n, dv, I = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.moe_intermediate_size
    Hl, e = cfg.linear_num_heads, cfg.linear_head_dim
    K = cfg.short_conv_kernel_size
    held = held_experts(cfg)[1]
    out = {"embed": (cfg.vocab, d), "final_norm": (d,),
           "head_w": (d, cfg.n_classes), "head_b": (cfg.n_classes,)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        out[p + "attn_norm"] = (d,)
        if full_attention(cfg, i):
            out.update({p + "wq": (d, H, n + R), p + "wkv_a": (d, r + R),
                        p + "kv_norm": (r,), p + "wkv_b": (r, H, n + dv),
                        p + "wo": (H, dv, d)})
        else:
            out.update({p + "q_proj": (d, Hl, e), p + "k_proj": (d, Hl, e),
                        p + "v_proj": (d, Hl, e), p + "q_conv": (Hl, e, K),
                        p + "k_conv": (Hl, e, K), p + "v_conv": (Hl, e, K),
                        p + "f_a": (d, e), p + "f_b": (e, Hl, e),
                        p + "dt_bias": (Hl, e), p + "a_log": (Hl,),
                        p + "b_proj": (d, Hl), p + "g_a": (d, e),
                        p + "g_b": (e, Hl, e), p + "g_bias": (Hl, e),
                        p + "o_norm": (e,), p + "o_proj": (Hl, e, d)})
        out[p + "ffn_norm"] = (d,)
        if i < cfg.first_k_dense_replace:
            out.update({p + "w1": (d, cfg.d_ff), p + "w3": (d, cfg.d_ff),
                        p + "w2": (cfg.d_ff, d)})
            continue
        out.update({p + "router": (d, E), p + "e_bias": (E,),
                    p + "experts_w1": (held, d, I),
                    p + "experts_w3": (held, d, I),
                    p + "experts_w2": (held, I, d)})
        if cfg.n_shared_experts:
            S = cfg.n_shared_experts * I
            out.update({p + "shared_w1": (d, S), p + "shared_w3": (d, S),
                        p + "shared_w2": (S, d)})
    return out


def trainable(name: str) -> bool:
    return not name.endswith(".e_bias")


def init_leaves(cfg: Config, seed: int,
                device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, leaf) in draw order, one generator seeded with ``seed`` on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for name, shape in leaf_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "a_log":
            yield name, torch.log(torch.rand(shape, generator=gen,
                                             device=device) * 16.0)
        elif leaf == "dt_bias":
            u = torch.rand(shape, generator=gen, device=device)
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(u * (hi - lo) + lo).clamp_(min=1e-4)
            yield name, dt + torch.log(-torch.expm1(-dt))
        elif leaf.endswith("_norm"):
            yield name, torch.ones(shape, dtype=torch.float32, device=device)
        elif leaf in ("e_bias", "g_bias", "head_b"):
            yield name, torch.zeros(shape, dtype=torch.float32,
                                    device=device)
        else:
            yield name, torch.randn(shape, generator=gen,
                                    dtype=torch.float32,
                                    device=device).mul_(INIT_STD)


def init_params(cfg: Config, seed: int, device) -> Dict[str, torch.Tensor]:
    return dict(init_leaves(cfg, seed, device))


# -- the forward pass of a batch of sequences --------------------------------

def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def l2_norm(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def causal_conv(y, w):
    """Each channel of ``y`` (B, T, H, e) convolved along T with its
    weights ``w`` (H, e, K): out_t = Σ_j w[..., j] y_{t−K+1+j}, zeros
    before the sequence."""
    K, T = w.shape[-1], y.shape[1]
    pad = F.pad(y, (0, 0, 0, 0, K - 1, 0))
    out = pad[:, :T] * w[..., 0]
    for j in range(1, K):
        out = out + pad[:, j:j + T] * w[..., j]
    return out


def _steps(S, q, k, bk, v, a):
    """The recurrence over a segment's tokens from the state ``S`` (N, e,
    ev), N the batch's heads, ``bk`` = β k: (the state after them, their
    outputs (t, N, ev)).
    A token: the decay, ``v − kᵀS``, the rank-one update, ``Sᵀq``. The
    inputs are split into tokens once (``unbind``), so the backward pass
    stacks their gradients once instead of filling a segment-sized
    gradient for each token."""
    outs = []
    for qt, kt, bkt, vt, at in zip(*(x.unbind(0)
                                      for x in (q, k, bk, v, a))):
        S = S * at[:, :, None]
        u = torch.baddbmm(vt[:, None, :], kt[:, None, :], S, alpha=-1.0)
        S = torch.baddbmm(S, bkt[:, :, None], u)
        outs.append(torch.bmm(qt[:, None, :], S))
    return S, torch.cat(outs, 1).transpose(0, 1)


def delta_recurrence(q, k, v, g, beta, segment: int):
    """``S_t = (I − β_t k_t k_tᵀ) Diag(exp g_t) S_{t−1} + β_t k_t v_tᵀ``
    and ``o_t = S_tᵀ q_t`` token by token: q, k, g (B, T, H, e), v (B,
    T, H, ev), beta (B, T, H), every sequence's heads stepped together.
    With a gradient, each segment of ``segment`` tokens runs without one
    and is run again in the backward pass."""
    B, T, H, e = k.shape
    ev = v.shape[-1]

    def tokens_first(x):  # (B, T, H, w) → (T, B·H, w)
        return x.transpose(0, 1).reshape(T, B * H, x.shape[-1])

    q, k, v, a = (tokens_first(x) for x in (q, k, v, torch.exp(g)))
    bk = tokens_first(beta[..., None]) * k
    S = q.new_zeros(B * H, e, ev)
    outs = []
    for part in zip(*(x.split(segment) for x in (q, k, bk, v, a))):
        if torch.is_grad_enabled() and segment < T:
            S, o = checkpoint(_steps, S, *part, use_reentrant=True)
        else:
            S, o = _steps(S, *part)
        outs.append(o)
    return torch.cat(outs).reshape(T, B, H, ev).transpose(0, 1)


def kda(x, p, cfg: Config, segment: int):
    h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    e = cfg.linear_head_dim

    def proj(name):
        y = torch.einsum("btd,dhe->bthe", h, p[name + "_proj"])
        return F.silu(causal_conv(y, p[name + "_conv"]))

    q = l2_norm(proj("q")) / math.sqrt(e)
    k = l2_norm(proj("k"))
    v = proj("v")
    beta = torch.sigmoid(h @ p["b_proj"])
    g = -torch.exp(p["a_log"])[:, None] * F.softplus(
        torch.einsum("btr,rhe->bthe", h @ p["f_a"], p["f_b"])
        + p["dt_bias"])
    o = delta_recurrence(q, k, v, g, beta, segment)
    gate = torch.sigmoid(torch.einsum("btr,rhe->bthe", h @ p["g_a"],
                                      p["g_b"]) + p["g_bias"])
    o = rms_norm(o, p["o_norm"], cfg.rms_norm_eps) * gate
    return torch.einsum("bthe,hed->btd", o, p["o_proj"])


def attention(q, k, v, causal: bool, key_block: int):
    """Softmax attention of one sequence: q, k (T, H, D), v (T, H, Dv).
    The scores a key chunk at a time: first each query's maximum, then
    the exponentials' sums and the weighted values."""
    T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qi = torch.arange(T, device=q.device)

    def scores(lo, hi):
        s = torch.einsum("qhd,khd->hqk", q, k[lo:hi]) * scale
        if causal:
            kj = torch.arange(lo, hi, device=q.device)
            s = s.masked_fill((kj[None, :] > qi[:, None])[None],
                              float("-inf"))
        return s

    with torch.no_grad():
        m = torch.full((H, T), float("-inf"), dtype=q.dtype, device=q.device)
        for lo in range(0, T, key_block):
            m = torch.maximum(m, scores(lo, min(T, lo + key_block)).amax(-1))
    num = torch.zeros((T, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    den = torch.zeros((H, T), dtype=q.dtype, device=q.device)
    for lo in range(0, T, key_block):
        hi = min(T, lo + key_block)
        p = torch.exp(scores(lo, hi) - m[..., None])
        den = den + p.sum(-1)
        num = num + torch.einsum("hqk,khv->qhv", p, v[lo:hi])
    return num / den.transpose(0, 1)[..., None]


def mla(x, p, cfg: Config, key_block: int):
    """Latent attention with no positions; with a gradient, each
    sequence's attention is recomputed in the backward pass, so that one
    sequence's scores are held at a time."""
    n, eps = cfg.qk_nope_head_dim, cfg.rms_norm_eps
    h = rms_norm(x, p["attn_norm"], eps)
    q = torch.einsum("btd,dhe->bthe", h, p["wq"])
    kv_a = h @ p["wkv_a"]
    c = rms_norm(kv_a[..., :cfg.kv_lora_rank], p["kv_norm"], eps)
    k_pe = kv_a[..., cfg.kv_lora_rank:]
    kv = torch.einsum("btc,che->bthe", c, p["wkv_b"])
    k_nope, v = kv[..., :n], kv[..., n:]
    H = q.shape[2]
    kf = torch.cat([k_nope, k_pe[:, :, None, :].expand(-1, -1, H, -1)],
                   dim=-1)
    one = []
    for b in range(x.shape[0]):
        if torch.is_grad_enabled():
            one.append(checkpoint(attention, q[b], kf[b], v[b], cfg.causal,
                                  key_block, use_reentrant=True))
        else:
            one.append(attention(q[b], kf[b], v[b], cfg.causal, key_block))
    return torch.einsum("bthe,hed->btd", torch.stack(one), p["wo"])


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def experts(x, p, cfg: Config):
    """The expert layer on a batch's normed rows x (B, T, d): (output,
    chosen experts (B·T, k), each sequence's balance loss Σ f_i P_i (B,),
    loads over the batch (E,)), the output over the held experts only."""
    B, T, d = x.shape
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    first, held = held_experts(cfg)
    x = x.reshape(B * T, d)
    s = torch.sigmoid(x @ p["router"])
    chosen = torch.topk(s.detach() + p["e_bias"], k, dim=-1).indices
    g = s.gather(1, chosen)
    g = g / (g.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    w1, w3, w2 = (p[n].unbind(0) for n in
                  ("experts_w1", "experts_w3", "experts_w2"))
    out = torch.zeros_like(x)
    for e in range(held):
        rows, slot = (chosen == first + e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], w1[e], w3[e], w2[e]) * g[rows, slot][:, None]
            out = out.index_add(0, rows, y)
    if cfg.n_shared_experts:
        out = out + swiglu(x, p["shared_w1"], p["shared_w3"], p["shared_w2"])
    seq = torch.arange(B, device=x.device).repeat_interleave(T * k) * E
    per_seq = torch.bincount(chosen.reshape(-1) + seq,
                             minlength=B * E).view(B, E)
    f = per_seq.to(s.dtype) * (E / (k * T))
    P = (s / s.sum(-1, keepdim=True)).view(B, T, E).mean(1)
    return (out.view(B, T, d), chosen, (f * P).sum(-1), per_seq.sum(0))


def layer(x, p, i: int, cfg: Config, key_block: int, segment: int):
    """(x, chosen, balance loss, loads); the last three None in a dense
    layer."""
    if full_attention(cfg, i):
        x = x + mla(x, p, cfg, key_block)
    else:
        x = x + kda(x, p, cfg, segment)
    h = rms_norm(x, p["ffn_norm"], cfg.rms_norm_eps)
    if i < cfg.first_k_dense_replace:
        return x + swiglu(h, p["w1"], p["w3"], p["w2"]), None, None, None
    out, chosen, bal, load = experts(h, p, cfg)
    return x + out, chosen, bal, load


def forward_batch(params, tokens, cfg: Config, *,
                  dtype=torch.float32, key_block: int = 1024,
                  segment: int = 256, remat: bool = False):
    """Sequences (B, T) of token ids → (logits (B, n_classes) in float32,
    [(layer, chosen, balance losses, loads)] of the expert layers)."""
    x = params["embed"].to(dtype)[tokens.long()]
    moe = []
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        p = {k[len(pre):]: v.to(dtype) for k, v in params.items()
             if k.startswith(pre)}
        if remat and torch.is_grad_enabled():
            x, chosen, bal, load = checkpoint(layer, x, p, i, cfg, key_block,
                                              segment, use_reentrant=True)
        else:
            x, chosen, bal, load = layer(x, p, i, cfg, key_block, segment)
        if chosen is not None:
            moe.append((i, chosen, bal, load))
    x = rms_norm(x, params["final_norm"].to(dtype), cfg.rms_norm_eps)
    logits = x.mean(1) @ params["head_w"].to(dtype) + params["head_b"].to(
        dtype)
    return logits.float(), moe


def forward(params, tokens, cfg: Config, **kw) -> torch.Tensor:
    """Logits (B, n_classes) of a batch of sequences, with no
    gradient."""
    with torch.no_grad():
        return forward_batch(params, tokens, cfg, **kw)[0]


def batch_loss(params, tokens, labels, cfg: Config, **kw):
    """A batch's loss: the mean over its sequences of each one's
    cross-entropy plus α Σ its balance losses; the cross-entropies (B,);
    the expert layers' records."""
    logits, moe = forward_batch(params, tokens, cfg, **kw)
    ce = -torch.log_softmax(logits, -1).gather(
        1, labels.long()[:, None])[:, 0]
    bal = sum((b.float() for _, _, b, _ in moe), torch.zeros_like(ce))
    return (ce + cfg.aux_loss_alpha * bal).mean(), ce, moe


# -- training -----------------------------------------------------------------

def adam_init(params):
    return {"mu": {k: torch.zeros_like(v) for k, v in params.items()
                   if trainable(k)},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()
                   if trainable(k)},
            "count": 0}


def adam_update(params, grads, state, lr: float) -> None:
    """optax's Adam in its order: moments, bias corrections in float32,
    ``mu_hat / (sqrt(nu_hat) + eps)``, times ``-lr``."""
    state["count"] += 1
    t = state["count"]
    bc1 = float(torch.tensor(1.0) - torch.tensor(ADAM_B1) ** t)
    bc2 = float(torch.tensor(1.0) - torch.tensor(ADAM_B2) ** t)
    for k, g in grads.items():
        mu = (1 - ADAM_B1) * g + ADAM_B1 * state["mu"][k]
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state["nu"][k]
        state["mu"][k], state["nu"][k] = mu, nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        params[k] = params[k] + u * (-lr)


def bias_update(params, loads: Dict[int, torch.Tensor], cfg: Config) -> None:
    """``b_i += γ · sign(mean − load_i)``, each expert layer's loads over
    the whole batch."""
    for i, load in loads.items():
        c = load.to(torch.float32)
        key = f"layers.{i}.e_bias"
        params[key] = params[key] + cfg.bias_update_speed * torch.sign(
            c.mean() - c)


def step(params, state, tokens, labels, cfg: Config, lr: float, *,
         observe: Optional[Callable] = None, **kw):
    """One training step on a batch (B, T): the loss (float), with
    ``params`` and ``state`` updated in place of their entries.
    ``observe(layer, chosen)`` sees each expert layer's (B·T, k)
    choices."""
    names = [k for k in params if trainable(k)]
    leaves = {k: params[k].detach().requires_grad_(True) for k in names}
    full = dict(params, **leaves)
    loss, _, moe = batch_loss(full, tokens, labels, cfg, **kw)
    loss.backward()
    if observe is not None:
        for i, ch, _, _ in moe:
            observe(i, ch)
    loads = {i: load for i, _, _, load in moe}
    grads = {k: leaves[k].grad for k in names}
    del leaves, full, moe
    with torch.no_grad():
        adam_update(params, grads, state, lr)
        bias_update(params, loads, cfg)
    return float(loss.detach())


def train(params, tokens, labels, batches: List, cfg: Config, lr: float, *,
          observe: Optional[Callable] = None, **kw) -> List[float]:
    """``len(batches)`` steps from ``params`` (updated in place of its
    entries); ``batches`` holds each step's row indices into ``tokens``
    and ``labels``. ``observe(step, layer, chosen)`` sees the routing.
    Returns the step losses."""
    state = adam_init(params)
    losses = []
    for t, rows in enumerate(batches):
        rows = torch.as_tensor(rows, device=tokens.device).long()
        obs = None if observe is None else (
            lambda i, ch, t=t: observe(t, i, ch))
        losses.append(step(params, state, tokens[rows], labels[rows], cfg,
                           lr, observe=obs, **kw))
    return losses
