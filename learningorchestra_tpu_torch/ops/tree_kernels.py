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
same launches. The histogram takes ``n_live``, the nodes of a level that
may hold rows: a population grows every level at its deepest width, and
the kernel's accumulators cover only the live nodes. The descent groups
its slices by bin matrix and stages each matrix's rows once for all of
them.

Beside each wrapper is its plain PyTorch version (``*_ref``), blocked
over rows so nothing (n, d·n_bins)-shaped exists; the slice forms' plain
versions loop it over the slices. A wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches its kernel or
raises. Each launch adds one to a count (``launch_counts``), so a run
can show which kernels it went through: a one-slice launch under the
kernel's name, a launch of more slices under ``<name>_slices``.
Public layouts are the JAX package's: histograms (n_nodes, d, n_bins, S),
leaf stats (S, M), node ids int32; the routing kernel also reads a
feature-major (d, n) copy of the codes, made once per bin matrix, or
(P, d, n) for a stack of P matrices in one launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
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
#: A histogram block's spare words past its slice, one a lane (the adds
#: of codes outside the slice land there).
HIST_SPARE_BYTES = 128
#: Shared memory a histogram block's slices may take: the spare words are
#: left free.
_HIST_SMEM_BUDGET = SMEM_BYTES - HIST_SPARE_BYTES
#: Histogram row chunk floor; 1024-thread blocks fit at most 2 to an SM.
_HIST_MIN_ROWS = 2048
_HIST_MAX_BLOCKS_PER_SM = 2
#: Share of its waves' blocks a histogram launch keeps busy at least, and
#: the most waves it takes to (``_hist_blocks``).
_HIST_BALANCE = 0.95
_HIST_MAX_ROUNDS = 8
#: Share of the most chunks a block of a stream walks that the mean must
#: reach (``_hist_layout``).
_HIST_CHUNK_BALANCE = 0.97
#: Bank-spread copies of a histogram slice the kernel is built for, and
#: the fewest the plan gives a slice that takes more than one.
HIST_REPLICAS = (1, 2, 4, 8, 16)
_HIST_MIN_COPIES = 8
#: Row cap of one histogram block, so its 32-bit words cannot overflow
#: (kMaxRowsPerChunk in csrc/tree_kernels.cu, which refuses more).
HIST_MAX_ROWS = 1 << 17
#: Fixed point of the histogram kernel (csrc/tree_kernels.cu): each value
#: becomes rint(v · 2^k) with |·| ≤ 2^HIST_VALUE_BITS, split into words
#: of HIST_LO_BITS low bits and the signed rest.
HIST_VALUE_BITS = 27
HIST_LO_BITS = 14
#: What the int64 partial histograms of one launch stay within at the
#: shapes the fits use (tests/test_torch_tree_kernels.py holds the plans
#: to it).
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
    "lo_tree_hist_u8": [_P] * 8 + [_I] * 12 + [_P],
    "lo_tree_hist_u8_fixed": [_P] * 8 + [_I] * 12 + [_P],
    "lo_tree_leaf_i32": [_P] * 5 + [_I] * 8 + [_P],
    "lo_tree_leaf_i32_fixed": [_P] * 5 + [_I] * 8 + [_P],
    "lo_tree_route": [_P] * 9 + [_I] * 5 + [_P],
    "lo_feature_major": [_P, _L, _P] + [_I] * 6 + [_P],
    "lo_tree_descend": [_P] * 4 + [_L] + [_P] * 4 + [_I] * 13 + [_P],
    "lo_atoms_probe": [_I] * 3 + [_P] * 2,
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


def _slice_tuple(code_idx: Sequence[int], P: int) -> Tuple[int, ...]:
    idx = tuple(int(i) for i in code_idx)
    if not idx:
        raise ValueError("a slice launch needs at least one slice")
    if len(idx) > 65535:
        raise ValueError(f"{len(idx)} slices exceed a launch's 65,535")
    if min(idx) < 0 or max(idx) >= P:
        raise ValueError(f"code_idx {idx} outside the {P} bin matrices")
    return idx


@functools.lru_cache(maxsize=256)
def _index_tensor(code_idx: Tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    return torch.tensor(code_idx, dtype=torch.int32, device=device)


def slice_index(code_idx: Sequence[int], P: int,
                device: torch.device) -> torch.Tensor:
    """The (G,) int32 device tensor a slice launch reads its matrix
    indices from, after checking each lies in [0, P). Cached by value, so
    the levels of a tree group copy it to the card once."""
    return _index_tensor(_slice_tuple(code_idx, P), device)


class SliceGroups(NamedTuple):
    """The slices of a launch grouped by bin matrix (``slice_groups``)."""
    order: torch.Tensor     # (G,) int32: the slices, sorted by matrix
    first: torch.Tensor     # (P + 1,) int32: where each matrix's start
    counts: Tuple[int, ...]  # slices of each matrix


@functools.lru_cache(maxsize=256)
def _group_tensors(code_idx: Tuple[int, ...], P: int,
                   device: torch.device) -> SliceGroups:
    order = sorted(range(len(code_idx)), key=code_idx.__getitem__)
    counts = [0] * P
    for c in code_idx:
        counts[c] += 1
    first = np.concatenate([[0], np.cumsum(counts)])
    return SliceGroups(
        torch.tensor(order, dtype=torch.int32, device=device),
        torch.tensor(first, dtype=torch.int32, device=device),
        tuple(counts))


def slice_groups(code_idx: Sequence[int], P: int,
                 device: torch.device) -> SliceGroups:
    """The slices of a launch grouped by bin matrix, as the staged descent
    reads them: ``order`` the slices sorted by matrix (a stable sort, so
    a matrix's slices keep their order), matrix p's being ``order[first[p]
    : first[p + 1]]``. Device tensors, cached by value as
    ``slice_index``."""
    return _group_tensors(_slice_tuple(code_idx, P), P, device)


# ---------------------------------------------------------------------------
# K1 — histogram and leaf statistics
# ---------------------------------------------------------------------------

def hist_smem_bytes(NG: int, CG: int, S: int, replicas: int = 1) -> int:
    """Dynamic shared memory of one histogram block: ``replicas`` copies
    of the slice's slots and the S fixed-point scales (and
    HIST_SPARE_BYTES more, which the plan leaves free)."""
    return NG * CG * S * SLOT_BYTES * replicas + 4 * S


class HistPlan(NamedTuple):
    """The histogram kernel's slice and row chunks (``hist_plan``)."""
    NG: int     # nodes of a node group (of the level's live nodes)
    CG: int     # columns of a column group (of the d·n_bins)
    R: int      # row chunks of a stream (one slice, node and column group)
    rows: int   # rows a chunk (the flush interval): at most HIST_MAX_ROWS
                # a copy of the slice (``hist_grid``)


class HistGrid(NamedTuple):
    """The histogram kernel's launch (``hist_grid``)."""
    blocks: int     # persistent blocks a stream, each its own partial slot
    replicas: int   # bank-spread copies of the shared slice


def hist_replicas(NG: int, CG: int, S: int) -> int:
    """The copies of a shared slice the plan gives it: as many of
    HIST_REPLICAS as fit a block's shared memory where that is
    _HIST_MIN_COPIES or more — a narrow level, few live nodes and a small
    slice — else one. The copies spread a warp's adds over the banks
    (lane l adds to copy l % replicas), which pays where a row adds two
    words a stat (float stats) and many copies fit; the flush of the
    copies costs the one-word rows (integer stats) a few percent at any
    width (chip_smoke.py times each count the shared memory fits)."""
    r = 1
    for cand in HIST_REPLICAS:
        if hist_smem_bytes(NG, CG, S, cand) <= _HIST_SMEM_BUDGET:
            r = cand
    return r if r >= _HIST_MIN_COPIES else 1


def _hist_wave(NG: int, CG: int, S: int, replicas: int, n_sms: int,
               leaf: bool) -> int:
    """Blocks the card holds at once: the histogram form's 1,024-thread
    blocks take up to 64 registers a thread, an SM's whole register file,
    so one an SM; the leaf form's are held to 32 registers, so two where
    their shared memory fits."""
    per_sm = _SM_SMEM_BYTES // (hist_smem_bytes(NG, CG, S, replicas)
                                + HIST_SPARE_BYTES + 1024)
    cap = _HIST_MAX_BLOCKS_PER_SM if leaf else 1
    return max(1, min(cap, per_sm)) * n_sms


def _hist_blocks(streams: int, wave: int) -> int:
    """Persistent blocks a stream: over 1 to _HIST_MAX_ROUNDS waves, the
    fewest rounds whose whole waves the streams' blocks keep at least
    _HIST_BALANCE busy (else the best of them): one wave where the
    streams divide it, a few where they do not (48 streams share 132
    SMs evenly only over 3 waves of 8 blocks a stream)."""
    best, best_eff = 1, 0.0
    for k in range(1, _HIST_MAX_ROUNDS + 1):
        B = k * wave // streams
        if B < 1:
            continue
        eff = streams * B / (k * wave)
        if eff > best_eff + 1e-9:
            best, best_eff = B, eff
        if eff >= _HIST_BALANCE:
            break
    return best


class _HistLayout(NamedTuple):
    plan: HistPlan
    grid: HistGrid


@functools.lru_cache(maxsize=1024)
def _hist_layout(n: int, d: int, n_bins: int, S: int, n_live: int,
                 n_sms: int, G: int, replicas=None,
                 leaf: bool = False) -> _HistLayout:
    DC = d * n_bins
    NG, CG = max(n_live, 1), max(DC, 1)
    while hist_smem_bytes(NG, CG, S) > _HIST_SMEM_BUDGET and NG > 1:
        NG = -(-NG // 2)
    while hist_smem_bytes(NG, CG, S) > _HIST_SMEM_BUDGET and CG > 1:
        CG = -(-CG // 2)
    if hist_smem_bytes(NG, CG, S) > _HIST_SMEM_BUDGET:
        raise ValueError(f"{S} stats per row do not fit a histogram slice")
    if replicas is None:
        # The leaf form's kernel is held to 32 registers, where copies
        # spill (chip_smoke.py times its copies against one): one copy.
        replicas = 1 if leaf else hist_replicas(NG, CG, S)
    if (replicas not in HIST_REPLICAS
            or hist_smem_bytes(NG, CG, S, replicas) > _HIST_SMEM_BUDGET):
        raise ValueError(f"{replicas} copies of a histogram slice do not "
                         f"fit shared memory")
    streams = G * -(-n_live // NG) * -(-DC // CG)
    B = _hist_blocks(streams, _hist_wave(NG, CG, S, replicas, n_sms, leaf))
    # Chunks of at least _HIST_MIN_ROWS rows, and partials within
    # _PARTIAL_BYTES where one slot a slice allows it.
    B = max(1, min(B, -(-n // _HIST_MIN_ROWS),
                   _PARTIAL_BYTES // (8 * G * n_live * DC * S)))
    # Chunks within the cap: a copy takes one row in `replicas` of a chunk
    # (lane l adds to copy l % replicas), so the cap on the rows a copy
    # sums between flushes allows chunks `replicas` times as long. A
    # stream's blocks walk ceil(C / B) chunks at most; where that is more
    # than _HIST_CHUNK_BALANCE of the mean, C rounds up to a multiple of B.
    C = max(1, -(-n // (HIST_MAX_ROWS * replicas)))
    if C < _HIST_CHUNK_BALANCE * B * -(-C // B):
        C = B * -(-C // B)
    rows = max(1, -(-n // C))
    return _HistLayout(HistPlan(NG, CG, max(1, -(-n // rows)), rows),
                       HistGrid(B, replicas))


def _live_arg(n_live, n_nodes: int) -> int:
    n_live = n_nodes if n_live is None else int(n_live)
    if not 1 <= n_live <= max(n_nodes, 1):
        raise ValueError(f"n_live {n_live} outside [1, {n_nodes}]")
    return n_live


def hist_plan(n: int, d: int, n_bins: int, S: int, n_nodes: int,
              n_sms: int, G: int = 1, n_live=None) -> HistPlan:
    """Slice and row chunks of the histogram kernel over G slices: (NG
    nodes and CG of the d·n_bins columns per shared-memory slice, R row
    chunks, rows per chunk). The slice covers the level's ``n_live`` live
    nodes (default n_nodes), whole when it fits the block's shared
    memory; past that, node groups halve first, then columns. A stream —
    one slice's node and column group — walks its rows in R chunks, the
    interval at which a block flushes its 32-bit words into its int64
    partial, each of at most HIST_MAX_ROWS rows a copy of the slice; R
    is the least that the row cap allows, raised to a multiple of the
    stream's blocks (``hist_grid``) where the blocks' shares of it would
    differ by more than 3%."""
    return _hist_layout(n, d, n_bins, S, _live_arg(n_live, n_nodes),
                        n_sms, G).plan


def hist_grid(n: int, d: int, n_bins: int, S: int, n_nodes: int,
              n_sms: int, G: int = 1, n_live=None) -> HistGrid:
    """Launch of the histogram kernel for ``hist_plan``'s slice and
    chunks: persistent blocks a stream, filling whole waves of the card
    evenly, each walking every blocks-th chunk of its stream and adding
    into its own int64 partial slot; and the copies of the slice
    (``hist_replicas``). The partials then scale with the blocks, not
    with n / HIST_MAX_ROWS: blocks · G · n_live · d · n_bins · S · 8
    bytes."""
    return _hist_layout(n, d, n_bins, S, _live_arg(n_live, n_nodes),
                        n_sms, G).grid


def stat_max_abs(stats_T: torch.Tensor) -> torch.Tensor:
    """max |stats_T[..., s, :]| per stat row: (S,) for (S, n) stats,
    (G, S) for a slice launch's (G, S, n), float32 on the stats' device:
    the histogram kernel's fixed-point scale input. Compute it once for
    stats that several histograms share (a tree's levels)."""
    if stats_T.shape[-1] == 0:
        return torch.zeros(stats_T.shape[:-1], dtype=torch.float32,
                           device=stats_T.device)
    return stats_T.abs().amax(dim=-1).float().contiguous()


def stat_exponent(max_abs: torch.Tensor) -> torch.Tensor:
    """k of each stat row's fixed point, from its max |value| (the
    kernel's ``stat_exponent``): x = rint(v · 2^k) has |x| ≤
    2^HIST_VALUE_BITS; 0 where max_abs is not > 0; capped at 126 so that
    2^k is a normal float. int32, the shape of ``max_abs``."""
    m, e = torch.frexp(max_abs.float())
    e = torch.where(m == 0.5, e - 1, e)
    k = torch.clamp(HIST_VALUE_BITS - e, max=126)
    return torch.where(max_abs > 0, k, torch.zeros_like(k)).int()


def fixed_to_float(totals: torch.Tensor,
                   max_abs: torch.Tensor) -> torch.Tensor:
    """Fixed-point totals (int64, the stat last) → float32 sums, rounded
    once from the float64 value ``total · 2^-k``: the kernel's own
    conversion, so the float histogram of integer totals equals the
    float launch's bit for bit. ``max_abs`` (..., S) broadcasts against
    the totals' leading slice axes."""
    k = stat_exponent(max_abs).cpu().numpy()
    scale = torch.from_numpy(np.ldexp(1.0, -k.astype(np.int64))).to(
        totals.device)
    shape = scale.shape[:-1] + (1,) * (totals.dim() - scale.dim()) \
        + scale.shape[-1:]
    return (totals.double() * scale.reshape(shape)).float()


def _fixed_rows(stats_T: torch.Tensor, max_abs: torch.Tensor):
    """The kernel's per-row fixed-point values of (S, n) stats at the
    scale of ``max_abs`` (S,): rint(v · 2^k) as int64 (the product is
    exact in float32 and rounds half to even, as ``__float2int_rn``)."""
    k = stat_exponent(max_abs).cpu().numpy().astype(np.int64)
    scale = torch.from_numpy(np.ldexp(np.float32(1), k).astype(np.float32))
    return torch.round(stats_T * scale.to(stats_T.device)[:, None]).to(
        torch.int64)


def _max_abs_arg(stats_T, max_abs):
    if max_abs is None:
        return stat_max_abs(stats_T)
    _need(max_abs, "max_abs", torch.float32, tuple(stats_T.shape[:-1]))
    if max_abs.device != stats_T.device:
        raise ValueError(f"max_abs on {max_abs.device}, stats on "
                         f"{stats_T.device}")
    return max_abs


def _check_live(rel, active, n_live: int) -> None:
    """The plain versions' check of the live-node precondition."""
    if bool((rel[active] >= n_live).any()):
        raise ValueError(f"an active row's node id is past the {n_live} "
                         f"live nodes")


def tree_histogram_ref(codes, stats_T, rel, active, *, n_nodes: int,
                       n_bins: int, n_live=None) -> torch.Tensor:
    """Plain version of ``tree_histogram``: an ``index_add_`` of each
    active row's stats into its (node, feature, bin) slots, one row block
    at a time. Raises if an active row's ``rel`` is past ``n_live``."""
    n, d = codes.shape
    S = stats_T.shape[0]
    _check_live(rel, active, _live_arg(n_live, n_nodes))
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
                   n_bins: int, max_abs=None, n_live=None) -> torch.Tensor:
    """Per-level (node, feature, bin, stat) sums of ``stats_T`` over the
    active rows, grouped by ``rel``.

    codes: (n, d) uint8 bin codes; stats_T: (S, n) float32; rel: (n,)
    int32 node id relative to the level (0 for inactive rows); active:
    (n,) bool; max_abs: ``stat_max_abs(stats_T)`` if the caller has it
    (computed here otherwise; unused on the CPU); n_live: the nodes [0,
    n_live) that may hold active rows at this level (default n_nodes) —
    the kernel's accumulators cover only those, and nodes past them come
    out 0. Every active row's ``rel`` must be below n_live: the plain
    version raises otherwise, and the kernel takes it as given. Returns
    (n_nodes, d, n_bins, S) float32. On the card the sums are exact
    integer sums of the stats in fixed point (csrc/tree_kernels.cu):
    integer-valued stats give the plain version's float sums exactly,
    float stats agree within max|v|·2^-27 a row, and every run gives the
    same bits. The one-slice launch of ``tree_histogram_slices``."""
    if not _on_cuda(codes, stats_T, rel, active):
        return tree_histogram_ref(codes, stats_T, rel, active,
                                  n_nodes=n_nodes, n_bins=n_bins,
                                  n_live=n_live)
    return tree_histogram_slices(
        codes[None], (0,), stats_T[None], rel[None], active[None],
        n_nodes=n_nodes, n_bins=n_bins,
        max_abs=None if max_abs is None else max_abs[None], n_live=n_live)[0]


def tree_histogram_slices_ref(codes, code_idx, stats_T, rel, active, *,
                              n_nodes: int, n_bins: int,
                              n_live=None) -> torch.Tensor:
    """Plain version of ``tree_histogram_slices``: the plain histogram of
    each slice."""
    return torch.stack([
        tree_histogram_ref(codes[int(c)], stats_T[g], rel[g], active[g],
                           n_nodes=n_nodes, n_bins=n_bins, n_live=n_live)
        for g, c in enumerate(code_idx)])


def tree_histogram_slices(codes, code_idx, stats_T, rel, active, *,
                          n_nodes: int, n_bins: int, max_abs=None,
                          n_live=None) -> torch.Tensor:
    """``tree_histogram`` for G slices in one launch: codes (P, n, d)
    uint8, a stack of bin matrices; code_idx: G ints, slice g's matrix;
    stats_T (G, S, n) float32; rel (G, n) int32; active (G, n) bool;
    max_abs (G, S) or None; n_live as for ``tree_histogram``, shared by
    the slices. Returns (G, n_nodes, d, n_bins, S), each slice
    bit-identical to its own one-slice launch."""
    if not _on_cuda(codes, stats_T, rel, active):
        return tree_histogram_slices_ref(codes, code_idx, stats_T, rel,
                                         active, n_nodes=n_nodes,
                                         n_bins=n_bins, n_live=n_live)
    return _hist_launch(codes, code_idx, stats_T, rel, active, n_nodes,
                        n_bins, max_abs, fixed=False, n_live=n_live)


def tree_histogram_fixed_ref(codes, code_idx, stats_T, rel, active, *,
                             n_nodes: int, n_bins: int, max_abs,
                             n_live=None) -> torch.Tensor:
    """Plain version of ``tree_histogram_fixed``: each active row's
    fixed-point stats ``index_add_``-ed as int64 into its (node, feature,
    bin) slots — the same integers the kernel sums."""
    G = len(code_idx)
    _, n, d = codes.shape
    S = stats_T.shape[1]
    n_live = _live_arg(n_live, n_nodes)
    out = torch.zeros((G, n_nodes * d * n_bins, S), dtype=torch.int64,
                      device=codes.device)
    fcol = torch.arange(d, device=codes.device) * n_bins
    for g, c in enumerate(code_idx):
        _check_live(rel[g], active[g], n_live)
        x = _fixed_rows(stats_T[g], max_abs[g])
        for i in range(0, n, _REF_BLOCK):
            a = active[g, i:i + _REF_BLOCK]
            cd = codes[int(c), i:i + _REF_BLOCK][a].long()
            r = rel[g, i:i + _REF_BLOCK][a].long()
            v = x[:, i:i + _REF_BLOCK][:, a].T
            key = r[:, None] * (d * n_bins) + fcol[None, :] + cd
            out[g].index_add_(0, key.reshape(-1),
                              v[:, None, :].expand(-1, d, S).reshape(-1, S))
    return out.reshape(G, n_nodes, d, n_bins, S)


def tree_histogram_fixed(codes, code_idx, stats_T, rel, active, *,
                         n_nodes: int, n_bins: int, max_abs,
                         n_live=None) -> torch.Tensor:
    """``tree_histogram_slices`` stopped before its conversion: the
    (G, n_nodes, d, n_bins, S) int64 fixed-point totals at the scale of
    ``max_abs`` (G, S), which the caller gives. Totals of the same scale
    add exactly across row shards, and ``fixed_to_float`` of their sum
    is the float launch over all the rows, bit for bit. The plain
    version (CPU tensors) gives the same integers. n_live as for
    ``tree_histogram``."""
    _need(max_abs, "max_abs", torch.float32, (len(code_idx),
                                              stats_T.shape[1]))
    if not _on_cuda(codes, stats_T, rel, active, max_abs):
        return tree_histogram_fixed_ref(codes, code_idx, stats_T, rel,
                                        active, n_nodes=n_nodes,
                                        n_bins=n_bins, max_abs=max_abs,
                                        n_live=n_live)
    return _hist_launch(codes, code_idx, stats_T, rel, active, n_nodes,
                        n_bins, max_abs, fixed=True, n_live=n_live)


def _hist_launch(codes, code_idx, stats_T, rel, active, n_nodes, n_bins,
                 max_abs, *, fixed: bool, n_live=None,
                 replicas=None) -> torch.Tensor:
    """One launch of the histogram kernel: float sums, or with ``fixed``
    the int64 totals. ``replicas`` replaces ``hist_replicas``'s choice
    of copies (chip_smoke.py times the choices against each other)."""
    G = len(code_idx)
    P, n, d = codes.shape
    S = stats_T.shape[1]
    n_live = _live_arg(n_live, n_nodes)
    _need(codes, "codes", torch.uint8, (P, n, d))
    _need(stats_T, "stats_T", torch.float32, (G, S, n))
    _need(rel, "rel", torch.int32, (G, n))
    _need(active, "active", torch.bool, (G, n))
    max_abs = _max_abs_arg(stats_T, max_abs)
    dev = codes.device
    idx = slice_index(code_idx, P, dev)
    plan, grid = _hist_layout(n, d, n_bins, S, n_live, _num_sms(dev), G,
                              replicas)
    out = torch.empty((G, n_nodes, d, n_bins, S),
                      dtype=torch.int64 if fixed else torch.float32,
                      device=dev)
    partial = torch.empty((grid.blocks, G, n_live * d * n_bins * S),
                          dtype=torch.int64, device=dev)
    entry = (_library().lo_tree_hist_u8_fixed if fixed
             else _library().lo_tree_hist_u8)
    _check(entry(
        codes.data_ptr(), idx.data_ptr(), stats_T.data_ptr(),
        max_abs.data_ptr(), rel.data_ptr(), active.data_ptr(),
        out.data_ptr(), partial.data_ptr(), n, d, n_bins, S, n_nodes, n_live,
        plan.NG, plan.CG, plan.rows, grid.blocks, grid.replicas, G,
        _stream(dev)), "tree_histogram")
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
    return _leaf_launch(assign, stats_T, n_nodes, max_abs,
                        fixed=False).transpose(1, 2)


def tree_leaf_stats_fixed_ref(assign, stats_T, *, n_nodes: int,
                              max_abs) -> torch.Tensor:
    """Plain version of ``tree_leaf_stats_fixed``."""
    G, n = assign.shape
    S = stats_T.shape[1]
    out = torch.zeros((G, n_nodes, S), dtype=torch.int64,
                      device=assign.device)
    for g in range(G):
        out[g].index_add_(0, assign[g].long(),
                          _fixed_rows(stats_T[g], max_abs[g]).T)
    return out


def tree_leaf_stats_fixed(assign, stats_T, *, n_nodes: int,
                          max_abs) -> torch.Tensor:
    """``tree_leaf_stats_slices`` stopped before its conversion: the
    (G, n_nodes, S) int64 fixed-point totals at the scale of ``max_abs``
    (G, S), for the caller to add across row shards and convert with
    ``fixed_to_float``. The plain version gives the same integers."""
    _need(max_abs, "max_abs", torch.float32, (assign.shape[0],
                                              stats_T.shape[1]))
    if not _on_cuda(assign, stats_T, max_abs):
        return tree_leaf_stats_fixed_ref(assign, stats_T, n_nodes=n_nodes,
                                         max_abs=max_abs)
    return _leaf_launch(assign, stats_T, n_nodes, max_abs, fixed=True)


def _leaf_launch(assign, stats_T, n_nodes, max_abs, *, fixed: bool,
                 replicas=None) -> torch.Tensor:
    """One launch of the leaf form: (G, n_nodes, S) float sums, or with
    ``fixed`` int64 totals; ``replicas`` as for ``_hist_launch``."""
    G, n = assign.shape
    S = stats_T.shape[1]
    if G > 65535:
        raise ValueError(f"{G} slices exceed a launch's 65,535")
    _need(assign, "assign", torch.int32, (G, n))
    _need(stats_T, "stats_T", torch.float32, (G, S, n))
    max_abs = _max_abs_arg(stats_T, max_abs)
    dev = assign.device
    plan, grid = _hist_layout(n, 1, n_nodes, S, 1, _num_sms(dev), G,
                              replicas, leaf=True)
    out = torch.empty((G, n_nodes, S),
                      dtype=torch.int64 if fixed else torch.float32,
                      device=dev)
    partial = torch.empty((grid.blocks, G, n_nodes * S), dtype=torch.int64,
                          device=dev)
    entry = (_library().lo_tree_leaf_i32_fixed if fixed
             else _library().lo_tree_leaf_i32)
    _check(entry(
        assign.data_ptr(), stats_T.data_ptr(), max_abs.data_ptr(),
        out.data_ptr(), partial.data_ptr(), n, n_nodes, S, plan.CG,
        plan.rows, grid.blocks, grid.replicas, G, _stream(dev)),
        "tree_leaf_stats")
    _count("tree_leaf_stats", G)
    return out


@functools.lru_cache(maxsize=8)
def _probe_sink(device: torch.device) -> torch.Tensor:
    return torch.zeros((1,), dtype=torch.int32, device=device)


def shared_atomics_probe(device: torch.device, rounds: int,
                         random_bins: bool) -> int:
    """Launch the shared-atomic probe (``atoms_probe_kernel`` in
    csrc/tree_kernels.cu) on a CUDA device: one block of 1,024 threads an
    SM, each thread 32 · ``rounds`` 32-bit shared ``ATOMS.ADD``s, into
    random bins of 32 words (K1's pattern) or conflict-free. Returns the
    adds it makes; timed, it gives the card's shared-atomic rate, K1's
    atomics floor. A probe, not a kernel of the port's paths: it counts
    no launch."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probe runs on a CUDA device, not {device}")
    blocks = _num_sms(device)
    _check(_library().lo_atoms_probe(rounds, int(random_bins), blocks,
                                     _probe_sink(device).data_ptr(),
                                     _stream(device)), "atoms_probe")
    return blocks * 1024 * 32 * rounds


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

#: Tiles of the feature-major copy (kTransRows, kTransFeats in
#: csrc/tree_kernels.cu): rows come in groups of TRANS_GROUP, one 16-B
#: store a lane; rows up to TRANS_FEATS wide are staged whole, as one span.
TRANS_ROWS = 1024
TRANS_FEATS = 32
TRANS_GROUP = 16


class FeatureMajorPlan(NamedTuple):
    """Launch shape of ``feature_major`` (``feature_major_plan``)."""
    span: bool        # a tile's rows staged whole, as one contiguous span
    pitch: int        # bytes a staged row takes
    pad: int          # 16-B pads after each staged 16-row group
    feat_tiles: int   # feature tiles a row tile
    row_tiles: int    # row tiles a matrix
    store: str        # "aligned": every feature's output row 16-B
                      # aligned; "shifted": 16-B stores across two lanes
    smem_bytes: int   # dynamic shared memory of a block


def feature_major_plan(n: int, d: int,
                       out_addr: int = 0) -> FeatureMajorPlan:
    """Launch shape of ``feature_major`` for (n, d) matrices written at
    device address ``out_addr`` (each matrix d·n bytes after the last).
    Rows of at most TRANS_FEATS bytes are staged whole, a tile of
    TRANS_ROWS rows as one span; wider rows in tiles of TRANS_FEATS
    features. A staged row takes ``pitch`` bytes (d, or TRANS_FEATS), and
    where that is even a 16-B pad follows each 16-row group, so that
    groups lie an odd number of 16-B chunks apart (the transpose's
    shared reads). Stores are 16 B a lane; where n is a multiple of 16
    and the output 16-B aligned every feature's row is ("aligned"), else
    each 16-B aligned block straddles two lanes' rows ("shifted"), and the
    kernel finds each row's offset itself."""
    if n < 1 or d < 1:
        raise ValueError(f"no feature-major plan for ({n}, {d}) codes")
    span = d <= TRANS_FEATS
    pitch = d if span else TRANS_FEATS
    pad = 1 - pitch % 2
    store = "aligned" if n % 16 == 0 and out_addr % 16 == 0 else "shifted"
    groups = TRANS_ROWS // TRANS_GROUP
    smem = 16 * (-(-(TRANS_ROWS * pitch + 32) // 16) + pad * (groups + 3))
    return FeatureMajorPlan(span, pitch, pad, -(-d // TRANS_FEATS),
                            -(-n // TRANS_ROWS), store, smem)


def feature_major_ref(codes: torch.Tensor) -> torch.Tensor:
    """Plain version of ``feature_major``."""
    return codes.transpose(-1, -2).contiguous()


def feature_major(codes: torch.Tensor) -> torch.Tensor:
    """The feature-major copy of uint8 bin codes that
    ``tree_route_level`` reads on the card: (n, d) → (d, n), or a stack
    (P, n, d) → (P, d, n) in one launch — a tiled transpose kernel there
    (``feature_major_plan``). Make it once per bin matrix, or once per
    stack, and pass it to every level of every tree."""
    if codes.dim() not in (2, 3) or codes.dtype != torch.uint8:
        raise ValueError(f"codes: expected uint8 (n, d) or (P, n, d), got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if not _on_cuda(codes):
        return feature_major_ref(codes)
    _need(codes, "codes", torch.uint8, tuple(codes.shape))
    P, n, d = (1,) * (3 - codes.dim()) + tuple(codes.shape)
    if P > 65535:
        raise ValueError(f"{P} bin matrices exceed a launch's 65,535")
    out = torch.empty(codes.shape[:-2] + (d, n), dtype=torch.uint8,
                      device=codes.device)
    if out.numel() == 0:
        return out
    plan = feature_major_plan(n, d, out.data_ptr())
    _check(_library().lo_feature_major(
        codes.data_ptr(), n * d, out.data_ptr(), n, d, P, plan.feat_tiles,
        plan.row_tiles, plan.smem_bytes, _stream(codes.device)),
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
        codes_T = feature_major(codes)
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
    trees_per_chunk: int    # tables that share a block: a matrix's (slice,
                            # tree) pairs (staged), a slice's trees (direct)
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


def descend_plan(n: int, d: int, depth: int, T: int, n_sms: int,
                 groups: Sequence[int] = (1,)) -> DescendPlan:
    """Path and launch shape of ``tree_descend`` over slices of T trees
    each, ``groups[p]`` of them over bin matrix p. Staged where a row is
    at most SECTOR_BYTES × depth wide and two tiles of DESCEND_THREADS
    rows fit beside one table, with as many rows a thread (4, 2 or 1) as
    fit; direct otherwise. Staged, a matrix's (slice, tree) pairs go in
    chunks as large as the shared memory left beside the tiles holds, so
    a block stages each tile of the matrix once for all the pairs of its
    chunk; direct, each slice's trees go in chunks of their own. The
    blocks of all chunks fill one wave. Raises ``ValueError`` past
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
        pairs = max(max(groups), 1) * T
        per_chunk = min(pairs, (SMEM_BYTES - 2 * tile) // tb)
        smem = 2 * tile + per_chunk * tb
        units = -(-n // rows)
        chunks = -(-pairs // per_chunk)
        launched = sum(-(-g * T // per_chunk) for g in groups if g) or 1
    else:
        tile = 0
        per_chunk = min(T, SMEM_BYTES // tb)
        smem = per_chunk * tb
        units = -(-n // DESCEND_THREADS)
        chunks = -(-T // per_chunk)
        launched = chunks * max(sum(groups), 1)
    resident = max(1, min(_DESCEND_BLOCKS_PER_SM,
                          _SM_SMEM_BYTES // (smem + 1024)))
    blocks = max(1, min(units, -(-resident * n_sms // launched)))
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
    int32, each slice bit-identical to its own one-slice launch. On the
    staged path the slices are grouped by matrix (``slice_groups``), and
    each tile of a matrix's rows is staged once for all its slices'
    trees."""
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
    grouped = slice_groups(code_idx, P, dev)
    plan = descend_plan(n, d, depth, T, _num_sms(dev), grouped.counts)
    out = torch.empty((G, T, n), dtype=torch.int32, device=dev)
    _check(_library().lo_tree_descend(
        codes.data_ptr(), idx.data_ptr(), grouped.order.data_ptr(),
        grouped.first.data_ptr(), codes.stride(0), feat.data_ptr(),
        thr.data_ptr(), internal.data_ptr(), out.data_ptr(), n, d, M,
        table_words(depth), T, depth, plan.rows_per_tile, plan.tile_bytes,
        plan.trees_per_chunk, plan.chunks, plan.blocks, G, P, _stream(dev)),
        "tree_descend")
    _count("tree_descend", G)
    return out
