"""Ring attention — sequence/context parallelism over the mesh ``seq`` axis.

The port of the JAX package's ``parallel/ring_attention.py``: sequences
longer than one device's memory shard their *length* across the ``seq``
axis of the process mesh (parallel/mesh.py), and exact attention runs as
a ring — each rank keeps its Q shard while K/V blocks rotate one hop per
step (``ppermute_next``, point-to-point sends), folding into the
numerically-stable m/l/o online softmax. After ``seq`` steps every Q
block has seen every K/V block: exact attention with O(T/P) memory a
rank.

Causal masking uses global positions, so rotation order never changes
results: the block arriving at step ``t`` came from ring position
``(my_index − t) mod P`` and its keys carry that offset.

Everything is float32 (the JAX ``qf`` casts). The chunk folds and the ring
steps are checkpointed (``torch.utils.checkpoint``, non-reentrant) where
the JAX package wraps them in ``jax.checkpoint``: the backward pass
recomputes a chunk's scores instead of keeping them, and reruns a step's
hop. The fold is the reference's own arithmetic, not a fused attention
call: the tests hold its numbers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from learningorchestra_tpu_torch.parallel.mesh import (
    SEQ_AXIS, ProcessMesh, ppermute_next)


def _scale(d: int) -> float:
    """1/sqrt(d) rounded as the JAX package rounds it (float32 sqrt, then
    a float32 divide)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _online_block(q, k_blk, v_blk, o, m, l, mask):
    """Fold one K/V block into the (o, m, l) online-softmax accumulators.

    q: (B, Tq, H, D); k_blk/v_blk: (B, Tk, H, D); o: (B, Tq, H, D);
    m, l: (B, Tq, H); mask: (Tq, Tk) additive (0 or -inf) or None.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * _scale(q.shape[-1])
    if mask is not None:
        s = s + mask[None, None, :, :]
    m_blk = s.amax(dim=-1)                                  # (B, H, Tq)
    m_new = torch.maximum(m, m_blk.permute(0, 2, 1))        # (B, Tq, H)
    # exp shift factors; rows that have seen only -inf stay zeroed via l.
    alpha = torch.exp(m - m_new)                            # (B, Tq, H)
    p = torch.exp(s - m_new.permute(0, 2, 1)[..., None])    # (B, H, Tq, Tk)
    l = l * alpha + p.sum(dim=-1).permute(0, 2, 1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk)
    o = o * alpha[..., None] + pv
    return o, m_new, l


#: Keys/values processed per online-softmax fold. Bounds the score
#: transient at (B, H, T_local, KV_BLOCK) regardless of sequence length.
KV_BLOCK = 1024


def _mask(q_pos, k_pos, k_local, Tk: int, ragged: bool, causal: bool):
    """The additive mask of one chunk, (Tq, chunk) or (1, chunk): padded
    keys (local index ≥ Tk, only in a ``ragged`` chunk) and, causally,
    keys after the query; None if neither."""
    mask = None
    if ragged:
        mask = torch.where(k_local[None, :] >= Tk, -torch.inf,
                           0.0).to(torch.float32)
    if causal:
        cm = torch.where(k_pos[None, :] > q_pos[:, None], -torch.inf,
                         0.0).to(torch.float32)
        mask = cm if mask is None else mask + cm
    return mask


def ring_attention(q, k, v, *, mesh: Optional[ProcessMesh] = None,
                   axis: str = SEQ_AXIS, causal: bool = False,
                   kv_block: int = KV_BLOCK):
    """Exact multi-head attention with sequence sharded over ``axis``.

    Per-rank shapes: q, k, v — (B, T_local, H, D). Returns (B, T_local,
    H, D). With a size-1 axis (or no mesh) this is blockwise single-device
    attention: each block folds through the online softmax in
    ``kv_block``-sized chunks, so memory stays O(T·kv_block) at any length
    (ragged tails pad the block and mask the padded keys).
    """
    size = mesh.size(axis) if mesh is not None else 1
    my_idx = mesh.index(axis) if mesh is not None else 0
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    dev = q.device
    grad = torch.is_grad_enabled()

    qf = q.to(torch.float32)
    o = torch.zeros_like(qf)
    m = torch.full((B, Tq, H), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Tq, H), dtype=torch.float32, device=dev)

    q_pos = my_idx * Tq + torch.arange(Tq, device=dev)
    chunk = min(kv_block, Tk)
    n_chunks = -(-Tk // chunk)
    Tk_pad = n_chunks * chunk  # ragged tails pad; padded keys are masked

    def fold_chunk(o, m, l, k_blk, v_blk, src: int, ci: int):
        kc = k_blk[:, ci * chunk:(ci + 1) * chunk]
        vc = v_blk[:, ci * chunk:(ci + 1) * chunk]
        k_local = ci * chunk + torch.arange(chunk, device=dev)
        # The JAX package adds an all-zero mask to a chunk with no padded
        # keys; s + 0 is s, so only the ragged last chunk gets one.
        mask = _mask(q_pos, src * Tk + k_local, k_local, Tk,
                     (ci + 1) * chunk > Tk, causal)
        return _online_block(qf, kc.to(torch.float32),
                             vc.to(torch.float32), o, m, l, mask)

    def fold(o, m, l, k_blk, v_blk, t: int):
        # The block held at step t originated at ring position
        # (my_idx - t) mod P; its keys carry that global offset.
        src = (my_idx - t) % size
        if Tk_pad != Tk:
            pad = (0, 0, 0, 0, 0, Tk_pad - Tk)
            k_blk = torch.nn.functional.pad(k_blk, pad)
            v_blk = torch.nn.functional.pad(v_blk, pad)
        # Chunks ascending: a row's first fold (own block, chunk 0) sees
        # an unmasked key, so m never stays -inf into exp(m - m_new).
        for ci in range(n_chunks):
            if n_chunks == 1 or not grad:
                o, m, l = fold_chunk(o, m, l, k_blk, v_blk, src, ci)
            else:
                o, m, l = checkpoint(fold_chunk, o, m, l, k_blk, v_blk,
                                     src, ci, use_reentrant=False)
        return o, m, l

    def step(o, m, l, k_blk, v_blk, t: int):
        k_blk = ppermute_next(k_blk, mesh, axis)
        v_blk = ppermute_next(v_blk, mesh, axis)
        o, m, l = fold(o, m, l, k_blk, v_blk, t)
        return o, m, l, k_blk, v_blk

    # Own block first, then rotate-then-fold for the remaining P-1 hops —
    # no wasted final hop whose result would be discarded.
    o, m, l = fold(o, m, l, k, v, 0)
    k_blk, v_blk = k, v
    for t in range(1, size):
        if grad:
            o, m, l, k_blk, v_blk = checkpoint(step, o, m, l, k_blk, v_blk,
                                               t, use_reentrant=False)
        else:
            o, m, l, k_blk, v_blk = step(o, m, l, k_blk, v_blk, t)
    # Fully-masked rows (can't happen causally: a row always sees itself)
    # would have l == 0; guard anyway.
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def reference_attention(q, k, v, *, causal: bool = False):
    """Unsharded full attention — the numerics oracle for tests, and the
    predictor's attention (it holds the whole (B, H, T, T) scores)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * _scale(q.shape[-1])
    if causal:
        T = q.shape[1]
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.float32)).to(q.dtype)
