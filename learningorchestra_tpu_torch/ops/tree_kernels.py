"""Tree-fitting kernels: hand-written CUDA for Hopper + plain versions.

The JAX package runs the two hot inner loops of level-wise tree growth
as Pallas TPU kernels (``learningorchestra_tpu/ops/pallas_kernels.py``):
the per-level (node, feature, bin, stat) histogram with its per-leaf
form, the per-level routing of rows to child nodes, and the full-tree
descent of binned rows to their leaves. Here each is a CUDA kernel in
``csrc/tree_kernels.cu`` (design notes there), built with ``nvcc`` for
``sm_90a`` at first use and bound with ctypes:

====================  ==============================================
wrapper               replaces (pallas_kernels.py)
====================  ==============================================
``tree_histogram``    ``tree_histogram`` → ``_tree_hist_kernel``
``tree_leaf_stats``   ``tree_leaf_stats`` → ``_tree_hist_kernel``
``tree_route_level``  ``tree_route_level`` → ``_tree_route_kernel``
``tree_descend``      ``tree_descend`` → ``_tree_descend_kernel``
====================  ==============================================

Beside each wrapper is its plain PyTorch version (``*_ref``), blocked
over rows so nothing (n, d·n_bins)-shaped exists. A wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches
its kernel or raises. Each launch adds one to the wrapper's count
(``launch_counts``), so a run can show which kernels it went through.
Public layouts are the JAX package's: histograms (n_nodes, d, n_bins, S),
leaf stats (S, M), node ids int32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from learningorchestra_tpu_torch.ops._cuda_build import (  # noqa: F401
    NVCC_FLAGS, CudaLibrary, LaunchCounter, check_launch as _check,
    need as _need, num_sms as _num_sms, on_cuda as _on_cuda,
    stream as _stream)

#: Dynamic shared memory one block may use on Hopper (227 KiB), and an
#: SM's whole shared memory (228 KiB; each resident block also holds 1 KiB
#: of it for the system).
SMEM_BYTES = 232_448
_SM_SMEM_BYTES = 233_472
#: Histogram row chunk floor; 512-thread blocks fit at most 4 to an SM.
_HIST_MIN_ROWS = 2048
_HIST_MAX_BLOCKS_PER_SM = 4
#: Cap on the per-chunk partial histograms of one launch.
_PARTIAL_BYTES = 512 << 20
#: Grid cap (in units of SMs) for the one-thread-per-row kernels, whose
#: blocks stride over rows so each loads its node table once.
_ROW_BLOCKS_PER_SM = 8
#: Rows per block of the plain versions.
_REF_BLOCK = 1 << 18

KERNELS = ("tree_histogram", "tree_leaf_stats", "tree_route_level",
           "tree_descend")

_counter = LaunchCounter(KERNELS)
_count = _counter.add


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return _counter.snapshot()


def reset_launch_counts() -> None:
    _counter.reset()


# ---------------------------------------------------------------------------
# Build + load (ops/_cuda_build.py)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = CudaLibrary("tree_kernels", {
    "lo_tree_hist_u8": [_P, _P, _P, _P, _P, _P] + [_I] * 9 + [_P],
    "lo_tree_leaf_i32": [_P, _P, _P, _P] + [_I] * 6 + [_P],
    "lo_tree_route": [_P] * 6 + [_I] * 4 + [_P],
    "lo_tree_descend": [_P] * 3 + [_I] * 6 + [_P],
})
SOURCE = _LIB.source
BUILD_DIR = _LIB.build_dir
#: The shared library for the current source (content-addressed).
library_path = _LIB.path
#: Compile the kernels if this source has no library yet.
build = _LIB.build
_library = _LIB.load


# ---------------------------------------------------------------------------
# K1 — histogram and leaf statistics
# ---------------------------------------------------------------------------

def hist_plan(n: int, d: int, n_bins: int, S: int, n_nodes: int,
              n_sms: int) -> Tuple[int, int, int, int]:
    """Launch shape of the histogram kernel: (NG nodes and CG of the
    d·n_bins columns per shared-memory slice, R row chunks, rows per
    chunk). The slice is the whole accumulator when it fits the block's
    shared memory; past that, node groups halve first, then columns. Row
    chunks fill one wave of resident blocks."""
    DC = d * n_bins
    NG, CG = max(n_nodes, 1), max(DC, 1)
    while NG * CG * S * 4 > SMEM_BYTES and NG > 1:
        NG = -(-NG // 2)
    while NG * CG * S * 4 > SMEM_BYTES and CG > 1:
        CG = -(-CG // 2)
    if NG * CG * S * 4 > SMEM_BYTES:
        raise ValueError(f"{S} stats per row do not fit a histogram slice")
    slices = -(-n_nodes // NG) * -(-DC // CG)
    # One wave: as many row chunks as the SMs hold blocks at once.
    per_sm = max(1, min(_HIST_MAX_BLOCKS_PER_SM,
                        _SM_SMEM_BYTES // (NG * CG * S * 4 + 1024)))
    R = max(1, min(-(-n // _HIST_MIN_ROWS), -(-per_sm * n_sms // slices)))
    R = min(R, max(1, _PARTIAL_BYTES // max(n_nodes * DC * S * 4, 1)))
    rows = max(1, -(-n // R))
    return NG, CG, max(1, -(-n // rows)), rows


def tree_histogram_ref(codes, stats_T, rel, active, *, n_nodes: int,
                       n_bins: int) -> torch.Tensor:
    """Plain version of ``tree_histogram``: an ``index_add_`` of each
    active row's stats into its (node, feature, bin) slots, one row block
    at a time."""
    n, d = codes.shape
    S = stats_T.shape[0]
    out = torch.zeros((n_nodes * d * n_bins, S), dtype=torch.float32,
                      device=codes.device)
    fcol = torch.arange(d, device=codes.device) * n_bins
    for i in range(0, n, _REF_BLOCK):
        a = active[i:i + _REF_BLOCK]
        c = codes[i:i + _REF_BLOCK][a].long()
        r = rel[i:i + _REF_BLOCK][a].long()
        s = stats_T[:, i:i + _REF_BLOCK][:, a].T
        key = r[:, None] * (d * n_bins) + fcol[None, :] + c
        out.index_add_(0, key.reshape(-1),
                       s[:, None, :].expand(-1, d, S).reshape(-1, S))
    return out.reshape(n_nodes, d, n_bins, S)


def tree_histogram(codes, stats_T, rel, active, *, n_nodes: int,
                   n_bins: int) -> torch.Tensor:
    """Per-level (node, feature, bin, stat) sums of ``stats_T`` over the
    active rows, grouped by ``rel``.

    codes: (n, d) uint8 bin codes; stats_T: (S, n) float32; rel: (n,)
    int32 node id relative to the level (0 for inactive rows); active:
    (n,) bool. Returns (n_nodes, d, n_bins, S) float32."""
    if not _on_cuda(codes, stats_T, rel, active):
        return tree_histogram_ref(codes, stats_T, rel, active,
                                  n_nodes=n_nodes, n_bins=n_bins)
    n, d = codes.shape
    S = stats_T.shape[0]
    _need(codes, "codes", torch.uint8, (n, d))
    _need(stats_T, "stats_T", torch.float32, (S, n))
    _need(rel, "rel", torch.int32, (n,))
    _need(active, "active", torch.bool, (n,))
    dev = codes.device
    NG, CG, R, rows = hist_plan(n, d, n_bins, S, n_nodes, _num_sms(dev))
    out = torch.empty((n_nodes, d, n_bins, S), dtype=torch.float32,
                      device=dev)
    partial = (torch.empty((R, out.numel()), dtype=torch.float32, device=dev)
               if R > 1 else out)
    lib = _library()
    _check(lib.lo_tree_hist_u8(
        codes.data_ptr(), stats_T.data_ptr(), rel.data_ptr(),
        active.data_ptr(), out.data_ptr(), partial.data_ptr(), n, d, n_bins,
        S, n_nodes, NG, CG, R, rows, _stream(dev)), "tree_histogram")
    _count("tree_histogram")
    return out


def tree_leaf_stats_ref(assign, stats_T, *, n_nodes: int) -> torch.Tensor:
    """Plain version of ``tree_leaf_stats``."""
    S = stats_T.shape[0]
    out = torch.zeros((n_nodes, S), dtype=torch.float32,
                      device=assign.device)
    out.index_add_(0, assign.long(), stats_T.T)
    return out.T


def tree_leaf_stats(assign, stats_T, *, n_nodes: int) -> torch.Tensor:
    """Per-node sums of ``stats_T`` over the rows' final node ids — the
    histogram kernel with one synthetic feature whose code is the node id.
    assign: (n,) int32 in [0, n_nodes); stats_T: (S, n) float32. Returns
    (S, n_nodes) float32 (a transposed view)."""
    if not _on_cuda(assign, stats_T):
        return tree_leaf_stats_ref(assign, stats_T, n_nodes=n_nodes)
    n = assign.shape[0]
    S = stats_T.shape[0]
    _need(assign, "assign", torch.int32, (n,))
    _need(stats_T, "stats_T", torch.float32, (S, n))
    dev = assign.device
    _, CG, R, rows = hist_plan(n, 1, n_nodes, S, 1, _num_sms(dev))
    out = torch.empty((n_nodes, S), dtype=torch.float32, device=dev)
    partial = (torch.empty((R, out.numel()), dtype=torch.float32, device=dev)
               if R > 1 else out)
    lib = _library()
    _check(lib.lo_tree_leaf_i32(
        assign.data_ptr(), stats_T.data_ptr(), out.data_ptr(),
        partial.data_ptr(), n, n_nodes, S, CG, R, rows, _stream(dev)),
        "tree_leaf_stats")
    _count("tree_leaf_stats")
    return out.T


# ---------------------------------------------------------------------------
# K2 — per-level routing
# ---------------------------------------------------------------------------

def tree_route_level_ref(codes, rel, active, assign, best_f, best_t,
                         split) -> torch.Tensor:
    """Plain version of ``tree_route_level``."""
    r = rel.long()
    go = split.bool()[r] & active
    v = codes.gather(1, best_f.long()[r][:, None])[:, 0].int()
    child = 2 * assign + 1 + (v > best_t.int()[r]).int()
    return torch.where(go, child, assign).int()


def tree_route_level(codes, rel, active, assign, best_f, best_t,
                     split) -> torch.Tensor:
    """Route rows of split nodes to child ``2a+1+(code[f] > thr)``; other
    rows keep their node. codes (n, d) uint8; rel, assign (n,) int32;
    active (n,) bool; best_f, best_t (NL,) int32, split (NL,) bool.
    Returns the new (n,) int32 node ids."""
    if not _on_cuda(codes, rel, active, assign, best_f, best_t, split):
        return tree_route_level_ref(codes, rel, active, assign, best_f,
                                    best_t, split)
    n, d = codes.shape
    NL = best_f.shape[0]
    _need(codes, "codes", torch.uint8, (n, d))
    _need(rel, "rel", torch.int32, (n,))
    _need(active, "active", torch.bool, (n,))
    _need(assign, "assign", torch.int32, (n,))
    dev = codes.device
    tbl = torch.stack([best_f.int(), best_t.int(), split.int()]).contiguous()
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = _library()
    _check(lib.lo_tree_route(
        codes.data_ptr(), rel.data_ptr(), active.data_ptr(),
        assign.data_ptr(), tbl.data_ptr(), out.data_ptr(), n, d, NL,
        _ROW_BLOCKS_PER_SM * _num_sms(dev), _stream(dev)),
        "tree_route_level")
    _count("tree_route_level")
    return out


# ---------------------------------------------------------------------------
# K3 — full-tree descent
# ---------------------------------------------------------------------------

def tree_descend_ref(codes, feat, thr, internal, *,
                     max_depth: int) -> torch.Tensor:
    """Plain version of ``tree_descend``."""
    single = feat.dim() == 1
    feat, thr, internal = (t.reshape(-1, t.shape[-1]).long()
                           for t in (feat, thr, internal))
    n = codes.shape[0]
    out = torch.empty((feat.shape[0], n), dtype=torch.int32,
                      device=codes.device)
    for i in range(0, n, _REF_BLOCK):
        cT = codes[i:i + _REF_BLOCK].T.long()            # (d, blk)
        a = torch.zeros((feat.shape[0], cT.shape[1]), dtype=torch.long,
                        device=codes.device)
        for _ in range(max_depth):
            v = cT.gather(0, feat.gather(1, a))
            go = internal.gather(1, a) != 0
            a = torch.where(go, 2 * a + 1 + (v > thr.gather(1, a)).long(), a)
        out[:, i:i + _REF_BLOCK] = a.int()
    return out[0] if single else out


def tree_descend(codes, feat, thr, internal, *,
                 max_depth: int) -> torch.Tensor:
    """Leaf node id of every binned row. codes (n, d) uint8; feat, thr,
    internal (M,) for one tree or (T, M) for T trees in one launch.
    Returns (n,) or (T, n) int32."""
    if not _on_cuda(codes, feat, thr, internal):
        return tree_descend_ref(codes, feat, thr, internal,
                                max_depth=max_depth)
    n, d = codes.shape
    _need(codes, "codes", torch.uint8, (n, d))
    single = feat.dim() == 1
    tbl = torch.stack([feat.int(), thr.int(), internal.int()],
                      dim=-2).reshape(-1, 3, feat.shape[-1]).contiguous()
    T, _, M = tbl.shape
    dev = codes.device
    out = torch.empty((T, n), dtype=torch.int32, device=dev)
    lib = _library()
    _check(lib.lo_tree_descend(
        codes.data_ptr(), tbl.data_ptr(), out.data_ptr(), n, d, M, T,
        max_depth, _ROW_BLOCKS_PER_SM * _num_sms(dev), _stream(dev)),
        "tree_descend")
    _count("tree_descend")
    return out[0] if single else out

