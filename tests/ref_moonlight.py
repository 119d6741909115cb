"""Plain reference of the ``tx`` classifier's ``mla_moe`` block:
Moonlight-16B-A3B's (DeepSeek-V3's architecture), in float32 ``torch``
operations, one sequence at a time. It imports nothing of the program.

The forward pass of one sequence of token ids:

- ``x = embed[tokens]``;
- each layer: ``x += MLA(rms(x))``, then ``x += FFN(rms(x))``, the FFN a
  SwiGLU MLP in the first ``first_k_dense_replace`` layers and the expert
  layer after them;
- MLA (no query compression): ``q = x W_q`` per head, split into
  ``q_nope`` (``qk_nope_head_dim``) and ``q_pe`` (``qk_rope_head_dim``);
  ``[c, k_pe] = x W_kva``; ``c = rms(c)``; ``[k_nope, v] = c W_kvb`` per
  head; ``q_pe`` and the one ``k_pe`` rotated (RoPE, θ =
  ``rope_theta``); scores ``[q_nope, q_pe] · [k_nope, k_pe]`` scaled by
  1/sqrt(``qk_nope_head_dim + qk_rope_head_dim``), causal; softmax; the
  heads' ``v_head_dim``-wide outputs concatenated through ``W_o``;
- the expert layer: ``s = sigmoid(x W_r)``, the token's experts the top
  ``num_experts_per_tok`` of ``s + b`` (``b`` the correction bias, for
  selection only), gates the chosen ``s`` over their sum times
  ``routed_scaling_factor``, output ``shared(x) + Σ g_i E_i(x)``, every
  expert and the shared experts a SwiGLU;
- the head: ``rms(x)``, mean over the sequence, ``W_h``, ``b_h``.

The loss of a batch is the mean over its sequences of the cross-entropy
plus α times each expert layer's sequence-wise balance loss ``Σ_i f_i
P_i`` (``f_i`` = E / (K·T) times the sequence's tokens choosing expert
i, ``P_i`` the sequence's mean of ``s_i / Σ_j s_j``). Gradients come by
autograd of that loss, summed over the batch's sequences. A step is Adam
(optax's order, written out), then ``b_i += γ · sign(mean − load_i)``
with the loads over the batch.

Departures from DeepSeek-V3's published modeling code:

- the head is the ``tx`` family's mean-pooled classifier over the final
  norm's output, in place of the LM head over the vocabulary;
- the optimizer is Adam, in place of Moonlight's Muon;
- RoPE rotates interleaved pairs ``(2i, 2i + 1)`` and leaves them
  interleaved; the modeling code permutes them to halves first, which
  gives the same scores (queries and keys move alike);
- the leaves are laid out as the ``tx`` family's flat dict (``wq`` (d,
  H, n + R), ``wkv_b`` (r, H, n + v), ``wo`` (H, v, d), experts stacked
  (E, d, I)), the transposes of the modeling code's ``nn.Linear``
  weights;
- parameters are drawn from one seeded generator, leaf by leaf in
  ``leaf_shapes`` order: normal with std 0.02 for every matrix, ones for
  a norm's scale, zeros for the correction bias and the head's bias.

Computed in blocks where asked: sequences one at a time (``train``,
``forward``), the scores a key chunk at a time in two passes (the
query's maximum, then the exponentials and their sums), each layer
recomputed in the backward pass where ``remat`` is set. ``dtype`` runs
the forward pass in a lower precision (the weights cast at their use,
the gradients and Adam in float32): the control of the comparison.
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
    rope_theta: float
    n_routed_experts: int
    n_shared_experts: int
    num_experts_per_tok: int
    moe_intermediate_size: int
    first_k_dense_replace: int
    routed_scaling_factor: float
    rms_norm_eps: float
    causal: bool = True
    #: DeepSeek-V3's technical report's balance-loss α and bias step γ.
    aux_loss_alpha: float = 1e-4
    bias_update_speed: float = 1e-3


def config(**kw) -> Config:
    """A Config from any mapping holding its fields (others ignored)."""
    return Config(**{f.name: kw[f.name] for f in fields(Config)
                     if f.name in kw})


def leaf_shapes(cfg: Config) -> Dict[str, tuple]:
    """Every leaf's shape, in the order they are drawn."""
    d, H, E = cfg.d_model, cfg.n_heads, cfg.n_routed_experts
    r, R = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    n, dv, I = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.moe_intermediate_size
    out = {"embed": (cfg.vocab, d), "final_norm": (d,),
           "head_w": (d, cfg.n_classes), "head_b": (cfg.n_classes,)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        out.update({p + "attn_norm": (d,), p + "wq": (d, H, n + R),
                    p + "wkv_a": (d, r + R), p + "kv_norm": (r,),
                    p + "wkv_b": (r, H, n + dv), p + "wo": (H, dv, d),
                    p + "ffn_norm": (d,)})
        if i < cfg.first_k_dense_replace:
            out.update({p + "w1": (d, cfg.d_ff), p + "w3": (d, cfg.d_ff),
                        p + "w2": (cfg.d_ff, d)})
            continue
        out.update({p + "router": (d, E), p + "e_bias": (E,),
                    p + "experts_w1": (E, d, I), p + "experts_w3": (E, d, I),
                    p + "experts_w2": (E, I, d)})
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
        if leaf.endswith("_norm"):
            yield name, torch.ones(shape, dtype=torch.float32, device=device)
        elif leaf in ("e_bias", "head_b"):
            yield name, torch.zeros(shape, dtype=torch.float32,
                                    device=device)
        else:
            yield name, torch.randn(shape, generator=gen,
                                    dtype=torch.float32,
                                    device=device).mul_(INIT_STD)


def init_params(cfg: Config, seed: int, device) -> Dict[str, torch.Tensor]:
    return dict(init_leaves(cfg, seed, device))


# -- the forward pass of one sequence ----------------------------------------

def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotate(x, theta: float):
    """RoPE on the last axis of ``x`` (T, ..., R), position t = row t,
    pair i = (2i, 2i + 1) turned by t · θ^(-2i/R)."""
    T, R = x.shape[0], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, R, 2, dtype=torch.float32,
                                        device=x.device) / R))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    shape = (T,) + (1,) * (x.dim() - 2) + (R // 2,)
    cos = ang.cos().view(shape).to(x.dtype)
    sin = ang.sin().view(shape).to(x.dtype)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack((a * cos - b * sin, a * sin + b * cos),
                       dim=-1).flatten(-2)


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
    n, R, eps = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.rms_norm_eps
    h = rms_norm(x, p["attn_norm"], eps)
    q = torch.einsum("td,dhe->the", h, p["wq"])
    q_nope, q_pe = q[..., :n], q[..., n:]
    kv_a = h @ p["wkv_a"]
    c = rms_norm(kv_a[:, :cfg.kv_lora_rank], p["kv_norm"], eps)
    k_pe = rotate(kv_a[:, cfg.kv_lora_rank:], cfg.rope_theta)
    kv = torch.einsum("tc,che->the", c, p["wkv_b"])
    k_nope, v = kv[..., :n], kv[..., n:]
    H = q.shape[1]
    qf = torch.cat([q_nope, rotate(q_pe, cfg.rope_theta)], dim=-1)
    kf = torch.cat([k_nope, k_pe[:, None, :].expand(-1, H, R)], dim=-1)
    o = attention(qf, kf, v, cfg.causal, key_block)
    return torch.einsum("the,hed->td", o, p["wo"])


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def experts(x, p, cfg: Config):
    """The expert layer on one sequence's normed rows x (T, d): (output,
    chosen experts (T, k), balance loss Σ f_i P_i, loads (E,))."""
    T = x.shape[0]
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    s = torch.sigmoid(x @ p["router"])
    chosen = torch.topk(s.detach() + p["e_bias"], k, dim=-1).indices
    g = s.gather(1, chosen)
    g = g / (g.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    w1, w3, w2 = (p[n].unbind(0) for n in
                  ("experts_w1", "experts_w3", "experts_w2"))
    out = torch.zeros_like(x)
    for e in range(E):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], w1[e], w3[e], w2[e]) * g[rows, slot][:, None]
            out = out.index_add(0, rows, y)
    if cfg.n_shared_experts:
        out = out + swiglu(x, p["shared_w1"], p["shared_w3"], p["shared_w2"])
    load = torch.bincount(chosen.reshape(-1), minlength=E)
    f = load.to(s.dtype) * (E / (k * T))
    P = (s / s.sum(-1, keepdim=True)).mean(0)
    return out, chosen, (f * P).sum(), load


def layer(x, p, i: int, cfg: Config, key_block: int):
    """(x, chosen, balance loss, loads); the last three None in a dense
    layer."""
    x = x + mla(x, p, cfg, key_block)
    h = rms_norm(x, p["ffn_norm"], cfg.rms_norm_eps)
    if i < cfg.first_k_dense_replace:
        return x + swiglu(h, p["w1"], p["w3"], p["w2"]), None, None, None
    out, chosen, bal, load = experts(h, p, cfg)
    return x + out, chosen, bal, load


def forward_sequence(params, tokens, cfg: Config, *,
                     dtype=torch.float32, key_block: int = 1024,
                     remat: bool = False):
    """One sequence (T,) of token ids → (logits (n_classes,) in float32,
    [(layer, chosen, balance loss, loads)] of the expert layers)."""
    x = params["embed"].to(dtype)[tokens.long()]
    moe = []
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        p = {k[len(pre):]: v.to(dtype) for k, v in params.items()
             if k.startswith(pre)}
        if remat and torch.is_grad_enabled():
            x, chosen, bal, load = checkpoint(layer, x, p, i, cfg, key_block,
                                              use_reentrant=False)
        else:
            x, chosen, bal, load = layer(x, p, i, cfg, key_block)
        if chosen is not None:
            moe.append((i, chosen, bal, load))
    x = rms_norm(x, params["final_norm"].to(dtype), cfg.rms_norm_eps)
    logits = x.mean(0) @ params["head_w"].to(dtype) + params["head_b"].to(
        dtype)
    return logits.float(), moe


def forward(params, tokens, cfg: Config, **kw) -> torch.Tensor:
    """Logits (B, n_classes) of a batch of sequences, one at a time, with
    no gradient."""
    with torch.no_grad():
        return torch.stack([forward_sequence(params, t, cfg, **kw)[0]
                            for t in tokens])


def sequence_loss(params, tokens, label, cfg: Config, **kw):
    """One sequence's loss (cross-entropy plus α Σ balance losses), its
    cross-entropy, the expert layers' records."""
    logits, moe = forward_sequence(params, tokens, cfg, **kw)
    ce = -torch.log_softmax(logits, -1)[int(label)]
    bal = sum((b.float() for _, _, b, _ in moe), torch.zeros((),
              device=logits.device))
    return ce + cfg.aux_loss_alpha * bal, ce, moe


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
    B = tokens.shape[0]
    total, loads, chosen = 0.0, {}, {}
    for b in range(B):
        loss, _, moe = sequence_loss(full, tokens[b], labels[b], cfg, **kw)
        (loss / B).backward()
        total += float(loss.detach())
        for i, ch, _, load in moe:
            loads[i] = loads.get(i, 0) + load
            chosen.setdefault(i, []).append(ch)
    if observe is not None:
        for i, parts in chosen.items():
            observe(i, torch.cat(parts))
    grads = {k: leaves[k].grad for k in names}
    del leaves, full
    with torch.no_grad():
        adam_update(params, grads, state, lr)
        bias_update(params, loads, cfg)
    return total / B


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
