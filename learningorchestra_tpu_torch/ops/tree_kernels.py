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
``feature_major``     (the layout ``tree_route_level`` reads)
``tree_descend``      ``tree_descend`` → ``_tree_descend_kernel``
====================  ==============================================

Each of the four tree kernels takes a slice axis: ``*_slices`` launches
serve G slices at once — the trees of a population fit (models/tune.py)
at one level, each with its own stats, node ids and tables, over one of
P bin matrices stacked (P, n, d) and named by the slice's entry of
``code_idx``. Each slice's output is bit-identical to a launch of that
slice alone, and the single-tree wrappers are the G = 1 calls of the
same launches.

Beside each wrapper is its plain PyTorch version (``*_ref``), blocked
over rows so nothing (n, d·n_bins)-shaped exists; the slice forms' plain
versions loop it over the slices. A wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches its kernel or
raises. Each launch adds one to a count (``launch_counts``), so a run
can show which kernels it went through: a one-slice launch under the
kernel's name, a launch of more slices under ``<name>_slices``.
Public layouts are the JAX package's: histograms (n_nodes, d, n_bins, S),
leaf stats (S, M), node ids int32; the routing kernel also reads a
feature-major (d, n) copy of the codes, made once per bin matrix.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Sequence, Tuple

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
#: Shared memory per histogram slot: two 32-bit fixed-point words.
SLOT_BYTES = 8
#: Histogram row chunk floor; 1024-thread blocks fit at most 2 to an SM.
_HIST_MIN_ROWS = 2048
_HIST_MAX_BLOCKS_PER_SM = 2
#: Row cap of one histogram block, so its 32-bit words cannot overflow
#: (kMaxRowsPerChunk in csrc/tree_kernels.cu, which refuses more).
HIST_MAX_ROWS = 1 << 17
#: Fixed point of the histogram kernel (csrc/tree_kernels.cu): each value
#: becomes rint(v · 2^k) with |·| ≤ 2^HIST_VALUE_BITS, split into words
#: of HIST_LO_BITS low bits and the signed rest.
HIST_VALUE_BITS = 27
HIST_LO_BITS = 14
#: Cap on the per-chunk int64 partial histograms of one launch (lifted
#: where the row cap needs more chunks).
_PARTIAL_BYTES = 512 << 20
#: Grid cap (in units of SMs) for the routing kernel, whose blocks stride
#: over rows so each loads its node table once.
_ROW_BLOCKS_PER_SM = 8
#: Rows per block of the plain versions.
_REF_BLOCK = 1 << 18

#: The kernels that take a slice axis; a launch of more than one slice
#: counts under ``<name>_slices``.
SLICED = ("tree_histogram", "tree_leaf_stats", "tree_route_level",
          "tree_descend")
KERNELS = SLICED + ("feature_major",) + tuple(f"{k}_slices" for k in SLICED)

_counter = LaunchCounter(KERNELS)


def _count(name: str, G: int = 1) -> None:
    _counter.add(name if G == 1 else f"{name}_slices")


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
_L = ctypes.c_longlong
_LIB = CudaLibrary("tree_kernels", {
    "lo_tree_hist_u8": [_P] * 8 + [_I] * 10 + [_P],
    "lo_tree_leaf_i32": [_P] * 5 + [_I] * 7 + [_P],
    "lo_tree_route": [_P] * 9 + [_I] * 5 + [_P],
    "lo_feature_major": [_P] * 2 + [_I] * 2 + [_P],
    "lo_tree_descend": [_P] * 2 + [_L] + [_P] * 4 + [_I] * 11 + [_P],
})
SOURCE = _LIB.source
BUILD_DIR = _LIB.build_dir
#: The shared library for the current source (content-addressed).
library_path = _LIB.path
#: nvcc's output for that library (ptxas registers and spills).
log_path = _LIB.log_path
#: Compile the kernels if this source has no library yet.
build = _LIB.build
_library = _LIB.load


@functools.lru_cache(maxsize=256)
def _index_tensor(code_idx: Tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    return torch.tensor(code_idx, dtype=torch.int32, device=device)


def slice_index(code_idx: Sequence[int], P: int,
                device: torch.device) -> torch.Tensor:
    """The (G,) int32 device tensor a slice launch reads its matrix
    indices from, after checking each lies in [0, P). Cached by value, so
    the levels of a tree group copy it to the card once."""
    idx = tuple(int(i) for i in code_idx)
    if not idx:
        raise ValueError("a slice launch needs at least one slice")
    if len(idx) > 65535:
        raise ValueError(f"{len(idx)} slices exceed a launch's 65,535")
    if min(idx) < 0 or max(idx) >= P:
        raise ValueError(f"code_idx {idx} outside the {P} bin matrices")
    return _index_tensor(idx, device)


# ---------------------------------------------------------------------------
# K1 — histogram and leaf statistics
# ---------------------------------------------------------------------------

def hist_smem_bytes(NG: int, CG: int, S: int) -> int:
    """Dynamic shared memory of one histogram block: the slice's slots
    and the S fixed-point scales."""
    return NG * CG * S * SLOT_BYTES + 4 * S


def hist_plan(n: int, d: int, n_bins: int, S: int, n_nodes: int,
              n_sms: int, G: int = 1) -> Tuple[int, int, int, int]:
    """Launch shape of the histogram kernel over G slices: (NG nodes and
    CG of the d·n_bins columns per shared-memory slice, R row chunks,
    rows per chunk). The slice is the whole accumulator when it fits the
    block's shared memory; past that, node groups halve first, then
    columns. Row chunks of all G slices together fill one wave of
    resident blocks, with at most HIST_MAX_ROWS rows each; the int64
    partials of all slices (R · G histograms) stay within
    ``_PARTIAL_BYTES`` unless the row cap needs more chunks."""
    DC = d * n_bins
    NG, CG = max(n_nodes, 1), max(DC, 1)
    while hist_smem_bytes(NG, CG, S) > SMEM_BYTES and NG > 1:
        NG = -(-NG // 2)
    while hist_smem_bytes(NG, CG, S) > SMEM_BYTES and CG > 1:
        CG = -(-CG // 2)
    if hist_smem_bytes(NG, CG, S) > SMEM_BYTES:
        raise ValueError(f"{S} stats per row do not fit a histogram slice")
    groups = -(-n_nodes // NG) * -(-DC // CG)
    # One wave: as many row chunks as the SMs hold blocks at once.
    per_sm = max(1, min(_HIST_MAX_BLOCKS_PER_SM, _SM_SMEM_BYTES
                        // (hist_smem_bytes(NG, CG, S) + 1024)))
    R = max(1, min(-(-n // _HIST_MIN_ROWS),
                   -(-per_sm * n_sms // (groups * G))))
    R = min(R, max(1, _PARTIAL_BYTES // max(G * n_nodes * DC * S * 8, 1)))
    R = max(R, -(-n // HIST_MAX_ROWS))
    rows = max(1, -(-n // R))
    return NG, CG, max(1, -(-n // rows)), rows


def stat_max_abs(stats_T: torch.Tensor) -> torch.Tensor:
    """max |stats_T[..., s, :]| per stat row: (S,) for (S, n) stats,
    (G, S) for a slice launch's (G, S, n), float32 on the stats' device:
    the histogram kernel's fixed-point scale input. Compute it once for
    stats that several histograms share (a tree's levels)."""
    if stats_T.shape[-1] == 0:
        return torch.zeros(stats_T.shape[:-1], dtype=torch.float32,
                           device=stats_T.device)
    return stats_T.abs().amax(dim=-1).float().contiguous()


def _max_abs_arg(stats_T, max_abs):
    if max_abs is None:
        return stat_max_abs(stats_T)
    _need(max_abs, "max_abs", torch.float32, tuple(stats_T.shape[:-1]))
    if max_abs.device != stats_T.device:
        raise ValueError(f"max_abs on {max_abs.device}, stats on "
                         f"{stats_T.device}")
    return max_abs


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
                   n_bins: int, max_abs=None) -> torch.Tensor:
    """Per-level (node, feature, bin, stat) sums of ``stats_T`` over the
    active rows, grouped by ``rel``.

    codes: (n, d) uint8 bin codes; stats_T: (S, n) float32; rel: (n,)
    int32 node id relative to the level (0 for inactive rows); active:
    (n,) bool; max_abs: ``stat_max_abs(stats_T)`` if the caller has it
    (computed here otherwise; unused on the CPU). Returns (n_nodes, d,
    n_bins, S) float32. On the card the sums are exact integer sums of
    the stats in fixed point (csrc/tree_kernels.cu): integer-valued stats
    give the plain version's float sums exactly, float stats agree within
    max|v|·2^-27 a row, and every run gives the same bits. The one-slice
    launch of ``tree_histogram_slices``."""
    if not _on_cuda(codes, stats_T, rel, active):
        return tree_histogram_ref(codes, stats_T, rel, active,
                                  n_nodes=n_nodes, n_bins=n_bins)
    return tree_histogram_slices(
        codes[None], (0,), stats_T[None], rel[None], active[None],
        n_nodes=n_nodes, n_bins=n_bins,
        max_abs=None if max_abs is None else max_abs[None])[0]


def tree_histogram_slices_ref(codes, code_idx, stats_T, rel, active, *,
                              n_nodes: int, n_bins: int) -> torch.Tensor:
    """Plain version of ``tree_histogram_slices``: the plain histogram of
    each slice."""
    return torch.stack([
        tree_histogram_ref(codes[int(c)], stats_T[g], rel[g], active[g],
                           n_nodes=n_nodes, n_bins=n_bins)
        for g, c in enumerate(code_idx)])


def tree_histogram_slices(codes, code_idx, stats_T, rel, active, *,
                          n_nodes: int, n_bins: int,
                          max_abs=None) -> torch.Tensor:
    """``tree_histogram`` for G slices in one launch: codes (P, n, d)
    uint8, a stack of bin matrices; code_idx: G ints, slice g's matrix;
    stats_T (G, S, n) float32; rel (G, n) int32; active (G, n) bool;
    max_abs (G, S) or None. Returns (G, n_nodes, d, n_bins, S), each
    slice bit-identical to its own one-slice launch."""
    G = len(code_idx)
    if not _on_cuda(codes, stats_T, rel, active):
        return tree_histogram_slices_ref(codes, code_idx, stats_T, rel,
                                         active, n_nodes=n_nodes,
                                         n_bins=n_bins)
    P, n, d = codes.shape
    S = stats_T.shape[1]
    _need(codes, "codes", torch.uint8, (P, n, d))
    _need(stats_T, "stats_T", torch.float32, (G, S, n))
    _need(rel, "rel", torch.int32, (G, n))
    _need(active, "active", torch.bool, (G, n))
    max_abs = _max_abs_arg(stats_T, max_abs)
    dev = codes.device
    idx = slice_index(code_idx, P, dev)
    NG, CG, R, rows = hist_plan(n, d, n_bins, S, n_nodes, _num_sms(dev), G)
    out = torch.empty((G, n_nodes, d, n_bins, S), dtype=torch.float32,
                      device=dev)
    partial = torch.empty((R, out.numel()), dtype=torch.int64, device=dev)
    _check(_library().lo_tree_hist_u8(
        codes.data_ptr(), idx.data_ptr(), stats_T.data_ptr(),
        max_abs.data_ptr(), rel.data_ptr(), active.data_ptr(),
        out.data_ptr(), partial.data_ptr(), n, d, n_bins, S, n_nodes, NG, CG,
        R, rows, G, _stream(dev)), "tree_histogram")
    _count("tree_histogram", G)
    return out


def tree_leaf_stats_ref(assign, stats_T, *, n_nodes: int) -> torch.Tensor:
    """Plain version of ``tree_leaf_stats``."""
    S = stats_T.shape[0]
    out = torch.zeros((n_nodes, S), dtype=torch.float32,
                      device=assign.device)
    out.index_add_(0, assign.long(), stats_T.T)
    return out.T


def tree_leaf_stats(assign, stats_T, *, n_nodes: int,
                    max_abs=None) -> torch.Tensor:
    """Per-node sums of ``stats_T`` over the rows' final node ids — the
    histogram kernel with one synthetic feature whose code is the node id,
    in the same fixed point. assign: (n,) int32 in [0, n_nodes); stats_T:
    (S, n) float32; max_abs as for ``tree_histogram``. Returns
    (S, n_nodes) float32 (a transposed view). The one-slice launch of
    ``tree_leaf_stats_slices``."""
    if not _on_cuda(assign, stats_T):
        return tree_leaf_stats_ref(assign, stats_T, n_nodes=n_nodes)
    return tree_leaf_stats_slices(
        assign[None], stats_T[None], n_nodes=n_nodes,
        max_abs=None if max_abs is None else max_abs[None])[0]


def tree_leaf_stats_slices_ref(assign, stats_T, *,
                               n_nodes: int) -> torch.Tensor:
    """Plain version of ``tree_leaf_stats_slices``."""
    return torch.stack([tree_leaf_stats_ref(a, s, n_nodes=n_nodes)
                        for a, s in zip(assign, stats_T)])


def tree_leaf_stats_slices(assign, stats_T, *, n_nodes: int,
                           max_abs=None) -> torch.Tensor:
    """``tree_leaf_stats`` for G slices in one launch: assign (G, n)
    int32, stats_T (G, S, n) float32, max_abs (G, S) or None. Returns
    (G, S, n_nodes) float32 (a transposed view), each slice bit-identical
    to its own one-slice launch."""
    if not _on_cuda(assign, stats_T):
        return tree_leaf_stats_slices_ref(assign, stats_T, n_nodes=n_nodes)
    G, n = assign.shape
    S = stats_T.shape[1]
    if G > 65535:
        raise ValueError(f"{G} slices exceed a launch's 65,535")
    _need(assign, "assign", torch.int32, (G, n))
    _need(stats_T, "stats_T", torch.float32, (G, S, n))
    max_abs = _max_abs_arg(stats_T, max_abs)
    dev = assign.device
    _, CG, R, rows = hist_plan(n, 1, n_nodes, S, 1, _num_sms(dev), G)
    out = torch.empty((G, n_nodes, S), dtype=torch.float32, device=dev)
    partial = torch.empty((R, out.numel()), dtype=torch.int64, device=dev)
    _check(_library().lo_tree_leaf_i32(
        assign.data_ptr(), stats_T.data_ptr(), max_abs.data_ptr(),
        out.data_ptr(), partial.data_ptr(), n, n_nodes, S, CG, R, rows, G,
        _stream(dev)), "tree_leaf_stats")
    _count("tree_leaf_stats", G)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# K2 and K3 — the packed node table
# ---------------------------------------------------------------------------

#: The kernels pack each node into one int32 word as they load their
#: tables (pack_node in csrc/tree_kernels.cu): bit 31 set keeps the row
#: where it is; bits 30..9 hold the feature; bits 8..0 hold tt in
#: [0, 256], and the row goes right iff its code is >= tt.
NODE_TT_BITS = 9
#: Features a packed word can name.
NODE_MAX_D = 1 << 22


def check_node_features(d: int) -> None:
    """Refuse rows wider than a packed node word can name."""
    if d > NODE_MAX_D:
        raise ValueError(f"{d} features exceed the {NODE_MAX_D} a packed "
                         f"node word can name")


# ---------------------------------------------------------------------------
# K2 — per-level routing
# ---------------------------------------------------------------------------

def feature_major_ref(codes: torch.Tensor) -> torch.Tensor:
    """Plain version of ``feature_major``."""
    return codes.t().contiguous()


def feature_major(codes: torch.Tensor) -> torch.Tensor:
    """The (d, n) feature-major copy of (n, d) uint8 bin codes that
    ``tree_route_level`` reads on the card: a tiled transpose kernel
    there. Make it once per bin matrix and pass it to every level of
    every tree."""
    if not _on_cuda(codes):
        return feature_major_ref(codes)
    n, d = codes.shape
    _need(codes, "codes", torch.uint8, (n, d))
    out = torch.empty((d, n), dtype=torch.uint8, device=codes.device)
    _check(_library().lo_feature_major(codes.data_ptr(), out.data_ptr(), n,
                                       d, _stream(codes.device)),
           "feature_major")
    _count("feature_major")
    return out


def tree_route_level_ref(codes, rel, active, assign, best_f, best_t,
                         split) -> torch.Tensor:
    """Plain version of ``tree_route_level``."""
    r = rel.long()
    go = split.bool()[r] & active
    v = codes.gather(1, best_f.long()[r][:, None])[:, 0].int()
    child = 2 * assign + 1 + (v > best_t.int()[r]).int()
    return torch.where(go, child, assign).int()


def tree_route_level(codes, rel, active, assign, best_f, best_t, split, *,
                     codes_T=None) -> torch.Tensor:
    """Route rows of split nodes to child ``2a+1+(code[f] > thr)``; other
    rows keep their node. codes (n, d) uint8; rel, assign (n,) int32;
    active (n,) bool; best_f, best_t (NL,) int32, split (NL,) bool;
    codes_T: ``feature_major(codes)`` if the caller has it (made here
    otherwise on the card; unused on the CPU). Returns the new (n,) int32
    node ids. The one-slice launch of ``tree_route_level_slices``."""
    n, d = codes.shape
    if codes_T is not None:
        _need(codes_T, "codes_T", torch.uint8, (d, n))
    NL = best_f.shape[0]
    for name, t in (("best_f", best_f), ("best_t", best_t), ("split", split)):
        if tuple(t.shape) != (NL,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the level "
                             f"tables ({NL},)")
    extra = () if codes_T is None else (codes_T,)
    if not _on_cuda(codes, rel, active, assign, best_f, best_t, split,
                    *extra):
        return tree_route_level_ref(codes, rel, active, assign, best_f,
                                    best_t, split)
    return tree_route_level_slices(
        codes[None], (0,), rel[None], active[None], assign[None],
        best_f[None], best_t[None], split[None],
        codes_T=None if codes_T is None else codes_T[None])[0]


def tree_route_level_slices_ref(codes, code_idx, rel, active, assign,
                                best_f, best_t, split) -> torch.Tensor:
    """Plain version of ``tree_route_level_slices``."""
    return torch.stack([
        tree_route_level_ref(codes[int(c)], rel[g], active[g], assign[g],
                             best_f[g], best_t[g], split[g])
        for g, c in enumerate(code_idx)])


def tree_route_level_slices(codes, code_idx, rel, active, assign, best_f,
                            best_t, split, *, codes_T=None) -> torch.Tensor:
    """``tree_route_level`` for G slices in one launch: codes (P, n, d)
    uint8, a stack of bin matrices; code_idx: G ints, slice g's matrix;
    rel, assign (G, n) int32; active (G, n) bool; best_f, best_t (G, NL)
    int32, split (G, NL) bool; codes_T the (P, d, n) feature-major stack
    (``feature_major`` of each matrix; made here on the card otherwise).
    Returns (G, n) int32, each slice bit-identical to its own one-slice
    launch."""
    G = len(code_idx)
    P, n, d = codes.shape
    if codes_T is not None:
        _need(codes_T, "codes_T", torch.uint8, (P, d, n))
    NL = best_f.shape[1]
    for name, t in (("best_f", best_f), ("best_t", best_t), ("split", split)):
        if tuple(t.shape) != (G, NL):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the level "
                             f"tables ({G}, {NL})")
    extra = () if codes_T is None else (codes_T,)
    if not _on_cuda(codes, rel, active, assign, best_f, best_t, split,
                    *extra):
        return tree_route_level_slices_ref(codes, code_idx, rel, active,
                                           assign, best_f, best_t, split)
    _need(codes, "codes", torch.uint8, (P, n, d))
    _need(rel, "rel", torch.int32, (G, n))
    _need(active, "active", torch.bool, (G, n))
    _need(assign, "assign", torch.int32, (G, n))
    check_node_features(d)
    if 4 * NL > SMEM_BYTES:
        raise ValueError(f"a {NL}-node level table does not fit shared "
                         f"memory")
    best_f, best_t = best_f.int().contiguous(), best_t.int().contiguous()
    split = split.bool().contiguous()
    if codes_T is None:
        codes_T = (feature_major(codes[0])[None] if P == 1
                   else torch.stack([feature_major(c) for c in codes]))
    dev = codes.device
    idx = slice_index(code_idx, P, dev)
    out = torch.empty((G, n), dtype=torch.int32, device=dev)
    _check(_library().lo_tree_route(
        codes_T.data_ptr(), idx.data_ptr(), rel.data_ptr(),
        active.data_ptr(), assign.data_ptr(), best_f.data_ptr(),
        best_t.data_ptr(), split.data_ptr(), out.data_ptr(), n, d, NL, G,
        _ROW_BLOCKS_PER_SM * _num_sms(dev), _stream(dev)),
        "tree_route_level")
    _count("tree_route_level", G)
    return out


# ---------------------------------------------------------------------------
# K3 — full-tree descent
# ---------------------------------------------------------------------------

#: Threads of a descent block (kDescendThreads in csrc/tree_kernels.cu).
DESCEND_THREADS = 256
#: A direct walk touches at most one 32-B sector of a row a level, so a
#: row wider than that times the depth is walked in place, not staged.
SECTOR_BYTES = 32
#: Rows a thread walks at once in a staged tile (the kernel's kRows), the
#: most that lets two tiles fit first.
_DESCEND_ROWS_PER_THREAD = (4, 2, 1)
#: Bytes of one node's table entry (a staged entry or a node word).
STEP_BYTES = 4
#: Deepest walk the kernels take: a staged entry's key holds node ids
#: below 2^15 (the JAX package's fits go to depth 12).
MAX_DESCEND_DEPTH = 14
#: Resident descent blocks an SM holds at most (2,048 threads).
_DESCEND_BLOCKS_PER_SM = 8


class DescendPlan(NamedTuple):
    """Launch shape of the descent kernel (``descend_plan``)."""
    staged: bool
    rows_per_tile: int      # staged path: rows of one tile
    tile_bytes: int         # staged path: bytes of one of its two buffers
    trees_per_chunk: int    # trees whose tables share a block
    chunks: int             # grid.y: each chunk reads the codes once
    blocks: int             # grid.x
    smem_bytes: int         # dynamic shared memory of a block


def table_words(depth: int) -> int:
    """Entries a tree's table needs for a walk of ``depth`` levels: the
    nodes of levels 0 .. depth-1 (at least one)."""
    return max(2 ** depth - 1, 1)


def descend_tile_bytes(rows: int, d: int) -> int:
    """Bytes of a staged tile buffer: the 16-B chunks that cover rows · d
    bytes starting anywhere in a chunk."""
    return (rows * d + 30) // 16 * 16


def descend_plan(n: int, d: int, depth: int, T: int,
                 n_sms: int, G: int = 1) -> DescendPlan:
    """Path and launch shape of ``tree_descend`` over G slices. Staged
    where a row is at most SECTOR_BYTES × depth wide and two tiles of
    DESCEND_THREADS rows fit beside one table, with as many rows a thread
    (4, 2 or 1) as fit; direct otherwise. Trees go in chunks as large as
    the shared memory left beside the tiles holds; the blocks of all
    chunks and slices fill one wave. Raises ``ValueError`` past
    MAX_DESCEND_DEPTH."""
    if depth > MAX_DESCEND_DEPTH:
        raise ValueError(f"a depth-{depth} walk exceeds the "
                         f"{MAX_DESCEND_DEPTH} levels the descent takes")
    tb = STEP_BYTES * table_words(depth)
    T = max(T, 1)
    rows = tile = 0
    if d <= SECTOR_BYTES * depth:
        for k in _DESCEND_ROWS_PER_THREAD:
            tile = descend_tile_bytes(k * DESCEND_THREADS, d)
            if 2 * tile + tb <= SMEM_BYTES:
                rows = k * DESCEND_THREADS
                break
    staged = rows > 0
    if staged:
        per_chunk = min(T, (SMEM_BYTES - 2 * tile) // tb)
        smem = 2 * tile + per_chunk * tb
        units = -(-n // rows)
    else:
        tile = 0
        per_chunk = min(T, SMEM_BYTES // tb)
        smem = per_chunk * tb
        units = -(-n // DESCEND_THREADS)
    chunks = -(-T // per_chunk)
    resident = max(1, min(_DESCEND_BLOCKS_PER_SM,
                          _SM_SMEM_BYTES // (smem + 1024)))
    blocks = max(1, min(units, -(-resident * n_sms // (chunks * G))))
    # As few blocks as keep the rounds over the units the same, so that
    # no last round runs a few blocks alone.
    blocks = -(-units // -(-units // blocks)) if units else 1
    return DescendPlan(staged, rows, tile, per_chunk, chunks, blocks, smem)


def descend_depth(M: int, max_depth: int) -> int:
    """Levels a walk of max_depth levels over M-node tables needs: none
    past max_depth, and none whose nodes all lie past M (node ids >= M
    keep their rows, as in the Pallas kernel)."""
    return max(0, min(max_depth, M.bit_length()))


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
    internal (M,) for one tree or (T, M) for T trees in one launch, which
    reads the codes once per chunk of trees (``descend_plan``). Returns
    (n,) or (T, n) int32. The one-slice launch of
    ``tree_descend_slices``."""
    if not _on_cuda(codes, feat, thr, internal):
        return tree_descend_ref(codes, feat, thr, internal,
                                max_depth=max_depth)
    single = feat.dim() == 1
    M = feat.shape[-1]
    out = tree_descend_slices(
        codes[None], (0,), feat.reshape(1, -1, M), thr.reshape(1, -1, M),
        internal.reshape(1, -1, M), max_depth=max_depth)[0]
    return out[0] if single else out


def tree_descend_slices_ref(codes, code_idx, feat, thr, internal, *,
                            max_depth: int) -> torch.Tensor:
    """Plain version of ``tree_descend_slices``."""
    return torch.stack([
        tree_descend_ref(codes[int(c)], feat[g], thr[g], internal[g],
                         max_depth=max_depth)
        for g, c in enumerate(code_idx)])


def tree_descend_slices(codes, code_idx, feat, thr, internal, *,
                        max_depth: int) -> torch.Tensor:
    """``tree_descend`` for G slices in one launch, each walking its own
    T trees: codes (P, n, d) uint8, a stack of bin matrices whose rows
    are contiguous (a row range of a stack is fine); code_idx: G ints,
    slice g's matrix; feat, thr, internal (G, T, M). Returns (G, T, n)
    int32, each slice bit-identical to its own one-slice launch."""
    G = len(code_idx)
    if not _on_cuda(codes, feat, thr, internal):
        return tree_descend_slices_ref(codes, code_idx, feat, thr, internal,
                                       max_depth=max_depth)
    P, n, d = codes.shape
    if (codes.dtype != torch.uint8
            or (n > 1 and codes.stride(1) != d)
            or (d > 1 and codes.stride(2) != 1)):
        raise ValueError(f"codes: expected uint8 (P, n, d) with contiguous "
                         f"rows, got {codes.dtype} strides {codes.stride()}")
    check_node_features(d)
    M = feat.shape[-1]
    T = feat.shape[1]
    feat, thr = (t.int().contiguous() for t in (feat, thr))
    internal = internal.bool().contiguous()
    for name, t in (("feat", feat), ("thr", thr), ("internal", internal)):
        if tuple(t.shape) != (G, T, M):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"({G}, {T}, {M})")
    depth = descend_depth(M, max_depth)
    dev = codes.device
    idx = slice_index(code_idx, P, dev)
    plan = descend_plan(n, d, depth, T, _num_sms(dev), G)
    out = torch.empty((G, T, n), dtype=torch.int32, device=dev)
    _check(_library().lo_tree_descend(
        codes.data_ptr(), idx.data_ptr(), codes.stride(0), feat.data_ptr(),
        thr.data_ptr(), internal.data_ptr(), out.data_ptr(), n, d, M,
        table_words(depth), T, depth, plan.rows_per_tile, plan.tile_bytes,
        plan.trees_per_chunk, plan.blocks, G, _stream(dev)),
        "tree_descend")
    _count("tree_descend", G)
    return out
