"""Kimi Delta Attention (KDA): the linear-attention layer of the ``tx``
family's ``kda_mla_moe`` block (Kimi Linear's: the Kimi Linear technical
report, arXiv:2510.26692, and flash-linear-attention's
``KimiDeltaAttention``).

For a token's normed hidden state ``x`` and each of ``linear_num_heads``
heads, key and value width ``linear_head_dim`` (``e``):

- ``q, k, v = silu(conv(x W_q))``, …: each projection through a causal
  depthwise convolution of width ``short_conv_kernel_size``, no bias;
- ``q̂, k̂``: q and k L2-normalised per head (``x / sqrt(Σx² + 1e-6)``);
- ``β = sigmoid(x W_b)``, one value a head;
- ``g = −exp(A_log) · softplus(x W_f1 W_f2 + dt_bias)``: a log-decay a key
  channel (``W_f1`` d → e, ``W_f2`` e → heads × e);
- ``S_t = (I − β_t k̂_t k̂_tᵀ) Diag(exp g_t) S_{t−1} + β_t k̂_t v_tᵀ``,
  ``S_0 = 0``, and ``o_t = S_tᵀ q̂_t / sqrt(e)``;
- the output ``W_o [rms_h(o_t) ⊙ sigmoid(x W_g1 W_g2 + b_g)]`` over the
  heads, ``rms_h`` an RMSNorm over a head's e values with one learned
  scale all heads share.

``delta_rule`` computes the recurrence as a chunked delta rule
(flash-linear-attention's chunk form): with ``G`` the log-decays summed
from the chunk's start, the state entering a chunk ``S₀`` and
``A_ts = Σ_c k_t k_s exp(G_t − G_s)`` (s < t), the chunk's corrected
values are ``U = (I + diag β A)⁻¹ diag β (V − (K ⊙ e^G) S₀)`` — one
triangular solve for ``Ũ`` and ``W̃`` before the chunks, one product a
chunk after — and its outputs ``(Q ⊙ e^G) S₀ + (Q K-decayed)ᵀ U``. A
chunk's summed log-decay reaches about −125 at the initial decays, far
past float32's range for ``exp(G)`` and ``exp(−G)`` taken apart, so every
decay between two tokens is taken as the exponential of a difference that
is at most 0: within each ``SUB``-token block directly (``_Diag``, which
recomputes those per-channel decays in its backward pass instead of
keeping them), between two blocks of a chunk through the earlier block's
last token, and from a chunk's tokens to its end.

On the model axis the heads split ``W_q``/``W_k``/``W_v``, the
convolutions, ``W_f2``, ``dt_bias``, ``A_log``, ``W_b``, ``W_g2`` and
``b_g``, and ``W_o`` by rows with one ``psum``; ``W_f1``, ``W_g1`` and the
norm's scale, which the heads share, are replicated.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from learningorchestra_tpu_torch.parallel.mesh import (
    MODEL_AXIS, ProcessMesh, psum, pvary)

#: Tokens a chunk of the chunked delta rule, and a block within it whose
#: decays are taken token pair by token pair.
CHUNK = 64
SUB = 16
#: Elements of the (blocks, t, s, e) decay tensor ``_Diag`` holds at once.
PIECE = 1 << 25
L2_EPS = 1e-6

#: A KDA layer's leaves in their fixed order (flash-linear-attention's
#: module names), and each split leaf's model-axis dimension.
LEAVES = ("q_proj", "k_proj", "v_proj", "q_conv", "k_conv", "v_conv",
          "f_a", "f_b", "dt_bias", "a_log", "b_proj", "g_a", "g_b",
          "g_bias", "o_norm", "o_proj")
SPLIT = {"q_proj": 1, "k_proj": 1, "v_proj": 1, "q_conv": 0, "k_conv": 0,
         "v_conv": 0, "f_b": 1, "dt_bias": 0, "a_log": 0, "b_proj": 1,
         "g_b": 1, "g_bias": 0, "o_proj": 0}
#: ``dt``'s range at init (flash-linear-attention's gated-delta init) and
#: ``A``'s: U(0, A_MAX) a head.
DT_MIN, DT_MAX, DT_FLOOR, A_MAX = 1e-3, 1e-1, 1e-4, 16.0


def shapes(cfg) -> dict:
    d, H = cfg.d_model, cfg.linear_num_heads
    e, K = cfg.linear_head_dim, cfg.short_conv_kernel_size
    return {"q_proj": (d, H, e), "k_proj": (d, H, e), "v_proj": (d, H, e),
            "q_conv": (H, e, K), "k_conv": (H, e, K), "v_conv": (H, e, K),
            "f_a": (d, e), "f_b": (e, H, e), "dt_bias": (H, e),
            "a_log": (H,), "b_proj": (d, H), "g_a": (d, e),
            "g_b": (e, H, e), "g_bias": (H, e), "o_norm": (e,),
            "o_proj": (H, e, d)}


def draw(leaf: str, shape, gen: torch.Generator):
    """The initial ``a_log`` (log A, A ~ U(0, 16) a head), ``dt_bias``
    (softplus⁻¹ of dt = exp(U(log 1e-3, log 1e-1)) floored at 1e-4, a
    channel) or ``g_bias`` (zeros), drawn from ``gen`` on its device;
    None for another leaf."""
    if leaf == "g_bias":
        return torch.zeros(shape, dtype=torch.float32, device=gen.device)
    if leaf == "a_log":
        return torch.log(torch.rand(shape, generator=gen,
                                    device=gen.device) * A_MAX)
    if leaf == "dt_bias":
        u = torch.rand(shape, generator=gen, device=gen.device)
        lo, hi = math.log(DT_MIN), math.log(DT_MAX)
        dt = torch.exp(u * (hi - lo) + lo).clamp_(min=DT_FLOOR)
        return dt + torch.log(-torch.expm1(-dt))
    return None


def short_conv(x, w):
    """Causal depthwise convolution along T: ``x`` (B, T, C), ``w`` (C, K);
    ``y_t = Σ_j w[:, j] x_{t−K+1+j}``, zeros before the sequence."""
    T, K = x.shape[1], w.shape[-1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = xp[:, :T] * w[:, 0]
    for j in range(1, K):
        y = y + xp[:, j:j + T] * w[:, j]
    return y


def l2norm(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def _decay(G):
    """(l, c, c, e): ``exp(G_t − G_s)`` for s ≤ t, 0 above the diagonal,
    from ``G`` (l, c, e) non-increasing along c."""
    c = G.shape[1]
    above = torch.ones(c, c, dtype=torch.bool, device=G.device).triu_(1)
    diff = G[:, :, None, :] - G[:, None, :, :]
    return diff.masked_fill_(above[None, :, :, None], float("-inf")).exp_()


class _Diag(torch.autograd.Function):
    """Within blocks of c tokens: ``Aqk[t, s] = Σ_e q_t k_s exp(G_t −
    G_s)`` for s ≤ t and ``Akk`` the same of k with k for s < t, from
    ``q``, ``k``, ``G`` (l, c, e). The (t, s, e) decays are made a piece
    of blocks at a time and made again in the backward pass."""

    @staticmethod
    def forward(ctx, q, k, G):
        ctx.save_for_backward(q, k, G)
        L, c, e = k.shape
        aqk, akk = k.new_empty(L, c, c), k.new_empty(L, c, c)
        step = max(1, PIECE // (c * c * e))
        for a in range(0, L, step):
            s = slice(a, a + step)
            w = _decay(G[s]).mul_(k[s, None])   # e^{G_t − G_s} k_s
            aqk[s] = (w @ q[s, :, :, None]).squeeze(-1)
            akk[s] = (w @ k[s, :, :, None]).squeeze(-1)
        return aqk, akk.tril_(-1)

    @staticmethod
    def backward(ctx, daqk, dakk):
        q, k, G = ctx.saved_tensors
        L, c, e = k.shape
        dakk = dakk.tril(-1)
        dq, dk, dG = (torch.empty_like(t) for t in (q, k, G))
        step = max(1, PIECE // (c * c * e))
        for a in range(0, L, step):
            s = slice(a, a + step)
            E = _decay(G[s])
            f1 = E * daqk[s, :, :, None]
            f2 = E.mul_(dakk[s, :, :, None])
            ks = k[s, None]
            dq[s] = (f1 * ks).sum(2)
            m = f1.mul_(q[s, :, None]).add_(f2 * k[s, :, None])
            dk[s] = (f2.mul_(ks)).sum(2) + m.sum(1)
            m.mul_(ks)
            dG[s] = m.sum(2) - m.sum(1)
        return dq, dk, dG


def _intra(q, k, G, sub: int):
    """A chunk's ``Aqk`` (s ≤ t) and ``Akk`` (s < t), (BH, N, C, C), from
    ``q``, ``k``, ``G`` (BH, N, C, e): blocks of ``sub`` tokens on the
    diagonal by ``_Diag``; below it, block i's rows against block j's
    through the last token of block j (both exponents at most 0)."""
    BH, N, C, e = k.shape
    n = C // sub
    qb, kb, Gb = (t.reshape(BH, N, n, sub, e) for t in (q, k, G))
    dq, dk = _Diag.apply(qb.reshape(-1, sub, e), kb.reshape(-1, sub, e),
                         Gb.reshape(-1, sub, e))
    aqk = q.new_zeros(BH, N, n, n, sub, sub)
    akk = q.new_zeros(BH, N, n, n, sub, sub)
    d = torch.arange(n, device=q.device)
    aqk[:, :, d, d] = dq.view(BH, N, n, sub, sub)
    akk[:, :, d, d] = dk.view(BH, N, n, sub, sub)
    if n > 1:
        i, j = torch.tril_indices(n, n, -1, device=q.device)
        last = Gb[:, :, :, -1:]                       # (BH, N, n, 1, e)
        right = (kb * torch.exp(last - Gb))[:, :, j].transpose(-1, -2)
        left = torch.exp(Gb[:, :, i] - last[:, :, j])
        aqk[:, :, i, j] = (qb[:, :, i] * left) @ right
        akk[:, :, i, j] = (kb[:, :, i] * left) @ right
    return (aqk.transpose(3, 4).reshape(BH, N, C, C),
            akk.transpose(3, 4).reshape(BH, N, C, C))


def delta_rule(q, k, v, g, beta, *, chunk: int = CHUNK, sub: int = SUB):
    """The outputs ``o_t = S_tᵀ q_t`` (B, T, H, e_v) of the recurrence
    ``S_t = (I − β_t k_t k_tᵀ) Diag(exp g_t) S_{t−1} + β_t k_t v_tᵀ``,
    ``S_0 = 0``, in chunks of ``chunk`` tokens (``sub`` divides it):
    ``q``, ``k``, ``g`` (B, T, H, e), ``v`` (B, T, H, e_v), ``beta`` (B, T,
    H), ``g`` ≤ 0. T is padded to whole chunks with tokens that change
    nothing (β = 0, g = 0)."""
    B, T, H, e = k.shape
    ev = v.shape[-1]
    N = -(-T // chunk)
    pad = N * chunk - T

    def lay(x):
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
        return x.permute(0, 2, 1, 3).reshape(B * H, N, chunk, x.shape[-1])

    q, k, v, g = lay(q), lay(k), lay(v), lay(g)
    beta = lay(beta[..., None])
    G = g.cumsum(2)
    aqk, akk = _intra(q, k, G, sub)
    gam = G.exp()
    sol = torch.linalg.solve_triangular(
        akk * beta, beta * torch.cat([v, k * gam], -1), upper=False,
        unitriangular=True)
    u0, w0 = sol.split([ev, e], -1)
    last = G[:, :, -1:]
    kd = (k * torch.exp(last - G)).transpose(-1, -2)  # to the chunk's end
    decay = last.exp().transpose(-1, -2)              # (BH, N, e, 1)
    S = q.new_zeros(B * H, e, ev)
    states, us = [], []
    # Split into chunks once: the backward pass then stacks each input's
    # gradient once, where indexing a chunk would fill a whole-sized
    # gradient for every chunk.
    for u0n, w0n, dn, kdn in zip(*(t.unbind(1)
                                   for t in (u0, w0, decay, kd))):
        states.append(S)
        u = torch.baddbmm(u0n, w0n, S, alpha=-1.0)
        us.append(u)
        S = torch.baddbmm(dn * S, kdn, u)
    o = (q * gam) @ torch.stack(states, 1) + aqk @ torch.stack(us, 1)
    return o.reshape(B, H, N * chunk, ev)[:, :, :T].permute(0, 2, 1, 3)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def attention(h, lyr, *, cfg, mesh: ProcessMesh):
    """KDA on this rank's heads of the normed rows ``h`` (B, T, d),
    replicated over the model axis; the output is whole over it."""
    B, T, _ = h.shape
    e = cfg.linear_head_dim
    # Replicated: the low-rank widths and the norm's scale the heads share.
    hf, hg = h @ lyr["f_a"], h @ lyr["g_a"]
    h, hf, hg, o_norm = (pvary(t, mesh, MODEL_AXIS)
                         for t in (h, hf, hg, lyr["o_norm"]))

    def proj(w, conv):
        x = torch.einsum("btd,dhe->bthe", h, w)
        H = x.shape[2]
        x = short_conv(x.reshape(B, T, H * e), conv.reshape(H * e, -1))
        return F.silu(x).view(B, T, H, e)

    q = l2norm(proj(lyr["q_proj"], lyr["q_conv"])) * e ** -0.5
    k = l2norm(proj(lyr["k_proj"], lyr["k_conv"]))
    v = proj(lyr["v_proj"], lyr["v_conv"])
    beta = torch.sigmoid(h @ lyr["b_proj"])
    g = -torch.exp(lyr["a_log"])[:, None] * F.softplus(
        torch.einsum("btr,rhe->bthe", hf, lyr["f_b"]) + lyr["dt_bias"])
    o = delta_rule(q, k, v, g, beta)
    gate = torch.sigmoid(torch.einsum("btr,rhe->bthe", hg, lyr["g_b"])
                         + lyr["g_bias"])
    o = _rms(o, o_norm, cfg.rms_norm_eps) * gate
    return psum(torch.einsum("bthe,hed->btd", o, lyr["o_proj"]), mesh,
                MODEL_AXIS)


def token_floats(cfg) -> int:
    """A token's float32 values at once in a no-grad KDA layer: the
    residual and norms, the projections before and after their
    convolutions, and the chunk form's laid-out copies, decays, solves
    and score rows (``_Diag``'s pieces are bounded apart)."""
    He = cfg.linear_num_heads * cfg.linear_head_dim
    return 6 * cfg.d_model + 16 * He + 4 * cfg.linear_num_heads * CHUNK
