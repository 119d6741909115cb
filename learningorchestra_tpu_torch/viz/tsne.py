"""t-SNE embedding: kNN affinities + exact-repulsion KL descent on the card.

The reference's tsne microservice Spark-loads the collection, gathers every
row to one Spark node, and runs single-core sklearn ``TSNE().fit_transform``
(reference tsne.py:74-102). This is the JAX package's design
(``learningorchestra_tpu/viz/tsne.py``) on one CUDA device:

- **Affinities**: squared distances in (tile × n) blocks, one matrix
  product per tile; ``torch.topk`` keeps the 3·perplexity nearest
  neighbours; per-row bandwidths are bisected to the target perplexity
  for all rows at once.
- **Symmetrized sparse attraction**: the directed kNN edge set is flipped
  once on the host into a padded incoming-edge table (``_edge_table``),
  so each step's attraction is one gather and a dense reduction; edges of
  hubs past the table's cap are summed per destination row exactly (an
  int64 fixed-point running sum), so two embeds give the same bits.
- **Exact repulsion**: the full n² q-sum through the hand-written CUDA
  kernel ``ops.tsne_kernels.tsne_repulsion`` (its plain version for CPU
  tensors). On a pod whose data axis has D > 1 ranks, and when each
  rank gets at least one tile of rows, the repulsion is row-sharded as
  in the JAX package: rank k takes rows [k·n/D, (k+1)·n/D) against the
  whole (n, 2) embedding through the row form
  ``tsne_kernels.tsne_repulsion_rows``, Z is all-reduced and the force
  rows all-gathered over the data axis, so every rank steps the same
  embedding.
- Standard Kullback-Leibler descent schedule: early exaggeration ×12, then
  momentum 0.8 with per-coordinate gains, as in van der Maaten's reference
  implementation.

The descent loop stays on the device: no step reads a value back to the
host. kNN and calibration run whole on every rank of a pod (the JAX
package runs them per process): they are deterministic, so every rank
builds the same edge table.

Matrix products run in full float32: the kNN distance form
``|a|² + |b|² − 2ab`` cancels at 50 dimensions, so TF32 must stay off
(PyTorch's default for ``torch.matmul``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from learningorchestra_tpu_torch.ops import tsne_kernels
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, all_gather, all_reduce_)
from learningorchestra_tpu_torch.parallel.runtime import (
    DeviceRuntime, host_rows)
from learningorchestra_tpu_torch.utils import tracing
from learningorchestra_tpu_torch.utils.profiling import device_span
from learningorchestra_tpu_torch.viz.pca import pca_embed

_TILE = 1024


def _pad_rows(X: np.ndarray, multiple: int):
    n = len(X)
    pad = (-n) % multiple
    if pad:
        X = np.concatenate([X, np.full((pad,) + X.shape[1:], 1e7,
                                       X.dtype)])
    return X, n


def _knn(X: torch.Tensor, *, k: int, tile: int):
    """Blocked kNN: per row, squared distances + indices of the k nearest
    (excluding self). X: (n, d) padded to a tile multiple. Returns
    (d2k (n, k) float32, idx (n, k) int32)."""
    n = X.shape[0]
    sq = (X * X).sum(dim=1)
    d2k = torch.empty((n, k), dtype=X.dtype, device=X.device)
    idxk = torch.empty((n, k), dtype=torch.int32, device=X.device)
    diag = torch.arange(tile, device=X.device)
    for i in range(n // tile):
        sl = slice(i * tile, (i + 1) * tile)
        d2 = sq[sl, None] + sq[None, :] - 2.0 * (X[sl] @ X.T)
        d2[diag, i * tile + diag] = math.inf                 # mask self
        neg, idx = torch.topk(-d2, k, dim=1)
        d2k[sl] = -neg
        idxk[sl] = idx.int()
    return d2k, idxk


def _calibrate(d2k: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Bisect per-row precision beta to hit the target perplexity, all rows
    at once (50 steps). d2k: (n, k) squared distances to neighbours.
    Returns the (n, k) row-normalized affinities."""
    target = torch.log(torch.tensor(perplexity, dtype=torch.float32))
    d2 = d2k - d2k[:, :1]                          # stabilize exponent

    def entropy(beta):
        w = torch.exp(-d2 * beta[:, None])
        s = w.sum(dim=1)
        h = torch.log(s) + beta * (d2 * w).sum(dim=1) / s
        return h, w / s[:, None]

    n = d2.shape[0]
    dev = d2.device
    lo = torch.zeros(n, device=dev)
    hi = torch.full((n,), math.inf, device=dev)
    beta = torch.ones(n, device=dev)
    target = target.to(dev)
    for _ in range(50):
        h, _ = entropy(beta)
        too_high = h > target                      # entropy too high → raise beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), lo * 2.0, (lo + hi) / 2.0)
    _, P = entropy(beta)
    return P


def _edge_table(idx: np.ndarray, P: np.ndarray, n_pad: int,
                n_valid: int) -> tuple:
    """Flip the directed kNN edge set into one padded gather table
    (host-side, once per embed; the structure is static across all
    descent iterations).

    Every directed edge (i → j, p) exerts w·q·(y_i − y_j) on i and the
    opposite on j, with w = p / (2n) — the exact symmetrization a
    scatter-add would express. Row i's table therefore holds its k
    outgoing neighbours followed by its incoming sources (padded with
    weight-0 self edges), so the per-iteration attraction is one gather +
    dense reduction.

    Incoming columns cap at 2k: kNN hubs (dense-cluster centers) can draw
    thousands of in-edges, and padding every row to the max in-degree
    explodes the table. Edges past the cap go to a COO overflow list
    handled by a small sorted scatter-add — the same forces, just a
    different summation route for the hub tail.

    Returns (sym_idx (n_pad, K) int32, sym_w (n_pad, K) float32,
    ov_src (m,) int32, ov_dst (m,) int32, ov_w (m,) float32).
    """
    n, k = idx.shape
    cap = 2 * k
    wmat = (P / (2.0 * max(n_valid, 1))).astype(np.float32)
    # kNN should never select a padding row (they sit at distance ~1e14),
    # but a zero weight makes that a guarantee rather than an assumption.
    wmat[idx >= n_valid] = 0.0
    src = np.repeat(np.arange(n, dtype=np.int64), k)
    dst = idx.reshape(-1).astype(np.int64)
    w = wmat.reshape(-1)
    keep = dst < n_valid
    src, dst, w = src[keep], dst[keep], w[keep]
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    starts = np.searchsorted(dst, np.arange(n_pad))
    rank = np.arange(len(dst)) - starts[dst]
    counts = np.bincount(dst, minlength=n_pad) if len(dst) else \
        np.zeros(n_pad, np.int64)
    in_cols = int(min(counts.max(), cap)) if len(dst) else 0
    K = k + in_cols
    sym_idx = np.tile(np.arange(n_pad, dtype=np.int32)[:, None], (1, K)) \
        if K else np.zeros((n_pad, 0), np.int32)
    sym_w = np.zeros((n_pad, K), np.float32)
    sym_idx[:n, :k] = idx
    sym_w[:n, :k] = wmat
    dense = rank < in_cols
    sym_idx[dst[dense], k + rank[dense]] = src[dense].astype(np.int32)
    sym_w[dst[dense], k + rank[dense]] = w[dense]
    ov = ~dense
    return (sym_idx, sym_w, src[ov].astype(np.int32),
            dst[ov].astype(np.int32), w[ov])


def _repulsion(Y, valid, mesh=None):
    """(Z, F) over all pairs. ``mesh``: row-shard over its data axis —
    each rank computes its row range against the whole embedding
    (``tsne_repulsion_rows``), the Z partials are all-reduced and the
    force rows all-gathered back to every rank. Y's rows must divide by
    the data axis."""
    if mesh is None:
        return tsne_kernels.tsne_repulsion(Y, valid)
    nloc = Y.shape[0] // mesh.size(DATA_AXIS)
    off = mesh.index(DATA_AXIS) * nloc
    Zp, Fp = tsne_kernels.tsne_repulsion_rows(
        Y[off:off + nloc], valid[off:off + nloc], Y, valid, off)
    Zp = Zp.reshape(1)
    all_reduce_(Zp, mesh, DATA_AXIS)
    return Zp[0], all_gather(Fp, mesh, DATA_AXIS, 0)


def _overflow_segments(ov_dst: torch.Tensor):
    """(rows, starts, ends) of the dst-sorted overflow edges, on their
    device: each destination row once, and the [start, end) range of its
    edges."""
    rows, counts = torch.unique_consecutive(ov_dst, return_counts=True)
    ends = torch.cumsum(counts, 0)
    return rows, ends - counts, ends


def _step(Y, vel, gains, sym_idx, sym_w, ov_src, ov_dst, ov_w,
          n_valid: int, exaggeration: float, eta: float, momentum: float,
          mesh=None, ov_seg=None):
    """One descent step; returns new (Y, vel, gains). Index tensors are
    int64 (PyTorch's gather and ``index_add_`` index type). ``mesh``
    row-shards the repulsion (``_repulsion``).

    ``ov_seg`` (``_overflow_segments(ov_dst)``, which the descent makes
    once; required when there are overflow edges) sums the overflow
    edges deterministically: each edge's force as an int64 fixed-point
    number, a running sum of those (exact, so the same bits in any order
    of adds), then one add a row, each row once. Atomic adds of the
    edges, or a float running sum (the card's scan groups its adds
    differently from run to run), would round differently from run to
    run, so two embeds of one dataset and seed would differ (the descent
    amplifies any difference), and a pod's ranks, each stepping its own
    copy of the embedding, would drift apart."""
    n = Y.shape[0]
    valid = (torch.arange(n, device=Y.device) < n_valid).float()

    # --- exact repulsion over the 2-D embedding: the CUDA kernel for CUDA
    # tensors, its plain version for CPU ones -------------------------------
    Z, Frep = _repulsion(Y, valid, mesh)
    Z = torch.clamp(Z, min=1e-12)

    # --- sparse symmetric attraction over the precomputed edge table -------
    # (padding entries are weight-0 self edges whose diff is exactly zero.)
    diff = Y[:, None, :] - Y[sym_idx]                # (n, K, 2) one gather
    d2e = (diff * diff).sum(dim=-1)
    qe = 1.0 / (1.0 + d2e)
    w = (sym_w * exaggeration) * qe
    Fattr = (w[..., None] * diff).sum(dim=1)
    if ov_dst.shape[0]:
        # Hub-tail overflow edges (beyond the dense cap), dst-sorted COO.
        dov = Y[ov_dst] - Y[ov_src]
        qov = 1.0 / (1.0 + (dov * dov).sum(dim=-1))
        fov = (ov_w * exaggeration * qov)[:, None] * dov
        rows, starts, ends = ov_seg
        # Fixed point at 2^k, the largest scale at which m edges of the
        # largest magnitude sum below 2^62 (frexp: bound < 2^e).
        f64 = fov.double()
        bound = f64.abs().max() * f64.shape[0]
        scale = torch.ldexp(torch.ones_like(bound),
                            62 - torch.frexp(bound).exponent)
        # One 1-D scan a coordinate: a scan down the rows of an (m, 2)
        # tensor runs a thread a column on the card.
        seg = []
        for c in range(2):
            run = torch.cumsum(torch.round(f64[:, c] * scale).long(), dim=0)
            run = torch.cat([run.new_zeros(1), run])
            seg.append(((run[ends] - run[starts]).double() / scale)
                       .to(fov.dtype))
        Fattr = Fattr.index_add(0, rows, torch.stack(seg, dim=1))

    grad = 4.0 * (Fattr - Frep / Z)
    # van der Maaten gains + momentum
    same_sign = torch.sign(grad) == torch.sign(vel)
    gains = torch.where(same_sign, gains * 0.8, gains + 0.2)
    gains = torch.clamp(gains, min=0.01)
    vel = momentum * vel - eta * gains * grad
    Y = (Y + vel) * valid[:, None]
    return Y, vel, gains


def tsne_embed(runtime: DeviceRuntime, X: np.ndarray, *,
               perplexity: float = 30.0, iters: int = 750,
               exaggeration_iters: int = 250, eta: Optional[float] = None,
               seed: int = 0, pca_dims: int = 50,
               tile: int = _TILE) -> np.ndarray:
    """(n, d) host matrix → (n, 2) t-SNE embedding.

    Each stage records a span (``viz.pca50``, ``viz.knn``,
    ``viz.calibrate``, ``viz.edge_table``, ``viz.descent``) under the
    ambient trace; a device stage's span ends when the device has
    finished it, and ``viz.edge_table`` is a host stage.
    ``viz.descent`` carries the count of hub-overflow edges
    (``overflow_edges``)."""
    X = np.asarray(X, np.float32)
    n, d = X.shape
    dev = runtime.device
    if d > pca_dims:
        # standard PCA-50 front end
        X, _ = device_span(lambda: pca_embed(runtime, X, k=pca_dims),
                           "viz.pca50", dev)
    tile = min(tile, 1 << max(3, (n - 1).bit_length() - 1))
    # Row-shard the O(n²) repulsion across the data axis when each rank
    # still gets at least one full tile of rows; smaller problems run
    # whole on every rank (they are sub-second anyway).
    P_data = runtime.data_shards()[0]
    shard = P_data > 1 and n >= P_data * tile
    Xp, n_valid = _pad_rows(X, tile * P_data if shard else tile)
    k = min(int(3 * perplexity), n - 1)

    (d2k, idx), _ = device_span(
        lambda: _knn(runtime.replicate(Xp), k=k, tile=tile), "viz.knn", dev)
    P, _ = device_span(lambda: _calibrate(d2k[:n_valid], perplexity),
                       "viz.calibrate", dev)
    with tracing.span("viz.edge_table"):
        table = _edge_table(host_rows(idx)[:n_valid], host_rows(P), len(Xp),
                            n_valid)
    sym_idx, ov_src, ov_dst = (runtime.replicate(a.astype(np.int64))
                               for a in (table[0], table[2], table[3]))
    sym_w, ov_w = runtime.replicate(table[1]), runtime.replicate(table[4])
    ov_seg = _overflow_segments(ov_dst) if len(table[3]) else None

    rng = np.random.default_rng(seed)
    Y0 = runtime.replicate(
        rng.normal(scale=1e-4, size=(len(Xp), 2)).astype(np.float32))
    if eta is None:
        eta = max(float(n_valid) / 12.0 / 4.0, 50.0)  # learning rate n/48

    def descend():
        state = (Y0, torch.zeros_like(Y0), torch.ones_like(Y0))
        for it in range(iters):
            early = it < exaggeration_iters
            state = _step(*state, sym_idx, sym_w, ov_src, ov_dst, ov_w,
                          n_valid, 12.0 if early else 1.0, eta,
                          0.5 if early else 0.8,
                          runtime.mesh if shard else None, ov_seg)
        return state[0]

    Y, _ = device_span(descend, "viz.descent", dev,
                       attrs={"overflow_edges": int(len(table[3]))})
    return host_rows(Y)[:n_valid]
