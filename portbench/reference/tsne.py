"""Plain t-SNE (van der Maaten 2008 and 2014): affinities from the
nearest neighbours, and one step of the exact-gradient descent.

- Affinities: PCA to ``pca_dims`` when the data is wider (float64 Gram
  matrix, eigenvectors), the ``k = 3 · perplexity`` nearest neighbours of
  every row by squared distance, per-row Gaussian precisions bisected in
  float64 until each row's conditional distribution has the target
  perplexity, and the symmetric joint affinity of i and j:
  (p_j|i + p_i|j) / (2 n), held as a sparse (n, n) matrix.
- A step: exact repulsion over every pair of rows, q_ij = 1 / (1 +
  |y_i - y_j|²), Z = Σ q_ij, attraction Σ_j P_ij · exaggeration · q_ij ·
  (y_i - y_j), gradient 4 (attraction - repulsion / Z), then the
  per-coordinate gains (+0.2 where the gradient's sign differs from the
  velocity's, ×0.8 where it agrees, at least 0.01) and momentum.

``dtype`` and ``tf32`` set the arithmetic: float64 for the reference; a
lower precision for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _matmul_precision(tf32: bool):
    class _Ctx:
        def __enter__(self):
            self.old = (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32

        def __exit__(self, *exc):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self.old
    return _Ctx()


def affinities(X: np.ndarray, *, perplexity: float, pca_dims: int,
               device, dtype=torch.float64, tf32: bool = False,
               block: int = 1024) -> torch.Tensor:
    """The (n, n) sparse symmetric joint affinities, coalesced."""
    dev = torch.device(device)
    with _matmul_precision(tf32):
        Xd = torch.from_numpy(np.asarray(X)).to(dev, dtype)
        n, d = Xd.shape
        if d > pca_dims:
            Xc = Xd - Xd.double().mean(0).to(dtype)
            gram = (Xc.double().T @ Xc.double()) / n
            _, vecs = torch.linalg.eigh(gram)
            Xd = Xc @ vecs.flip(1)[:, :pca_dims].to(dtype)
        k = min(int(3 * perplexity), n - 1)
        sq = (Xd * Xd).sum(1)
        d2k = torch.empty((n, k), dtype=dtype, device=dev)
        idx = torch.empty((n, k), dtype=torch.long, device=dev)
        for a in range(0, n, block):
            b = min(a + block, n)
            d2 = sq[a:b, None] + sq[None, :] - 2.0 * (Xd[a:b] @ Xd.T)
            d2[torch.arange(b - a, device=dev),
               torch.arange(a, b, device=dev)] = math.inf
            neg, nn = torch.topk(-d2, k, dim=1)
            d2k[a:b], idx[a:b] = -neg, nn
    P = _conditional(d2k, perplexity)
    rows = torch.arange(n, device=dev).repeat_interleave(k)
    cols = idx.reshape(-1)
    w = (P.reshape(-1) / (2.0 * n)).double()
    return torch.sparse_coo_tensor(
        torch.stack([torch.cat([rows, cols]), torch.cat([cols, rows])]),
        torch.cat([w, w]), (n, n), check_invariants=True).coalesce()


def _conditional(d2k: torch.Tensor, perplexity: float,
                 steps: int = 64) -> torch.Tensor:
    """Row-normalized Gaussian affinities over each row's neighbours, the
    precision of each row bisected to the target perplexity."""
    dtype = d2k.dtype
    d2 = d2k - d2k[:, :1]
    target = math.log(perplexity)
    n = d2.shape[0]
    lo = torch.zeros(n, dtype=dtype, device=d2.device)
    hi = torch.full((n,), math.inf, dtype=dtype, device=d2.device)
    beta = torch.ones(n, dtype=dtype, device=d2.device)

    def entropy(beta):
        w = torch.exp(-d2 * beta[:, None])
        s = w.sum(1)
        return torch.log(s) + beta * (d2 * w).sum(1) / s, w / s[:, None]

    for _ in range(steps):
        h, _ = entropy(beta)
        high = h > target
        lo = torch.where(high, beta, lo)
        hi = torch.where(high, hi, beta)
        beta = torch.where(torch.isinf(hi), lo * 2.0, (lo + hi) / 2.0)
    return entropy(beta)[1]


def table_affinities(sym_idx, sym_w, ov_src, ov_dst, ov_w,
                     n_valid: int) -> torch.Tensor:
    """The joint affinities a padded gather table and its overflow edges
    hold (row i's entries pull i toward their columns), as a coalesced
    sparse (n_valid, n_valid) matrix. Zero-weight entries are dropped."""
    K = sym_idx.shape[1]
    rows = torch.arange(sym_idx.shape[0], device=sym_idx.device
                        ).repeat_interleave(K)
    cols = sym_idx.reshape(-1).long()
    w = sym_w.reshape(-1).double()
    rows = torch.cat([rows, ov_dst.long()])
    cols = torch.cat([cols, ov_src.long()])
    w = torch.cat([w, ov_w.double()])
    keep = w != 0
    if bool(((rows[keep] >= n_valid) | (cols[keep] >= n_valid)).any()):
        raise ValueError("a padding row holds a nonzero affinity")
    return torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols[keep]]), w[keep],
        (n_valid, n_valid), check_invariants=True).coalesce()


def affinity_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Σ |P_prog - P_ref| / Σ P_ref over the sparse entries."""
    diff = torch.sparse_coo_tensor(
        torch.cat([prog.indices(), ref.indices()], dim=1),
        torch.cat([prog.values(), -ref.values()]), ref.shape,
        check_invariants=True).coalesce()
    return float(diff.values().abs().sum() / ref.values().abs().sum())


def repulsion(Y: torch.Tensor, block: int = 512) -> tuple:
    """(Z, F): Z = Σ_{i≠j} q_ij, F_i = Σ_j q_ij² (y_i - y_j)."""
    n = Y.shape[0]
    Z = torch.zeros((), dtype=Y.dtype, device=Y.device)
    F = torch.empty_like(Y)
    for a in range(0, n, block):
        b = min(a + block, n)
        diff = Y[a:b, None, :] - Y[None, :, :]
        q = 1.0 / (1.0 + (diff * diff).sum(-1))
        q[torch.arange(b - a, device=Y.device),
          torch.arange(a, b, device=Y.device)] = 0.0
        Z = Z + q.sum()
        F[a:b] = ((q * q)[..., None] * diff).sum(1)
    return Z, F


def step(Y, vel, gains, P: torch.Tensor, *, exaggeration: float,
         eta: float, momentum: float, dtype=torch.float64):
    """One descent step over the valid rows; returns (Y, vel, gains)."""
    Y, vel, gains = (t.to(dtype) for t in (Y, vel, gains))
    Z, Frep = repulsion(Y)
    Z = torch.clamp(Z, min=1e-12)
    rows, cols = P.indices()
    diff = Y[rows] - Y[cols]
    q = 1.0 / (1.0 + (diff * diff).sum(-1))
    pull = (P.values().to(dtype) * exaggeration * q)[:, None] * diff
    Fattr = torch.zeros_like(Y).index_add_(0, rows, pull)
    grad = 4.0 * (Fattr - Frep / Z)
    same = torch.sign(grad) == torch.sign(vel)
    gains = torch.clamp(torch.where(same, gains * 0.8, gains + 0.2),
                        min=0.01)
    vel = momentum * vel - eta * gains * grad
    return Y + vel, vel, gains


def step_gap(state, prog_out, ref_out) -> float:
    """The larger, over the embedding and the velocity, of |Δ_prog -
    Δ_ref| / |Δ_ref|: a step's moves from ``state`` (Euclidean over all
    coordinates)."""
    gap = 0.0
    for x, a, b in list(zip(state, prog_out, ref_out))[:2]:
        d_prog = a.double() - x.double()
        d_ref = b.double() - x.double()
        gap = max(gap, float(torch.linalg.norm(d_prog - d_ref)
                             / torch.clamp(torch.linalg.norm(d_ref),
                                           min=1e-300)))
    return gap


def gain_flips(prog_gains, ref_gains) -> float:
    """The share of coordinates whose gain differs from the reference's by
    more than rounding: a gain moves by at least 0.2 times itself a
    step, so a sign of the gradient read otherwise shows whole."""
    ref = ref_gains.double()
    diff = (prog_gains.double() - ref).abs()
    return float((diff > 1e-3 * ref.abs() + 1e-6).double().mean())
