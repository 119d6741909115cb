"""Exact t-SNE repulsion: a hand-written CUDA kernel for Hopper + its
plain PyTorch version.

The JAX package runs the O(n²) repulsion of every t-SNE descent step as
a Pallas TPU kernel (``learningorchestra_tpu/ops/pallas_kernels.py``
``_repulsion_kernel``, through ``tsne_repulsion_rows`` and
``tsne_repulsion``). Here it is two CUDA kernels in
``csrc/tsne_kernels.cu`` (design notes there), built with ``nvcc`` for
``sm_90a`` at first use and bound with ctypes: ``tsne_repulsion`` over
the whole embedding evaluates each unordered pair once and credits both
rows; ``tsne_repulsion_rows`` over a row range sums each query row over
the columns outside the range (the direct form) and takes the range's
own block once a pair, through a work list that ``rows_geometry``
builds here.

For query rows ``Yq`` (global row ids ``offset + i``) against every row
of ``Y``, with ``q_ij = 1 / (1 + |y_i − y_j|²)`` masked where either
side is invalid or both are the same global row, it returns the scalar
``Z = Σ q_ij`` and the (nq, 2) force numerator
``F_i = Σ_j q_ij² (y_i − y_j)``, from the differences themselves (the
Pallas kernel's ``y_i·Σ q² − Σ q² y_j`` is the same sum, but cancels
when |y_i| is large against the force). Summing the Z of row ranges
gives the whole embedding's Z.

The wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises. Each launch adds one to
``launch_counts()["tsne_repulsion"]``, or for the row form to
``launch_counts()["tsne_repulsion_rows"]``. Unlike the Pallas kernel, neither
form needs n or nq to be a multiple of a tile. The two forms group their
float sums differently, so a row range agrees with the whole call to
rounding, not bit for bit. On CUDA the row form needs what the Pallas
kernel's docstring states, that query row i is global row offset + i:
``Yq`` and ``validq`` must be views of ``Y`` and ``valid`` at
``offset`` (``check_row_views``), or it raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from learningorchestra_tpu_torch.ops._cuda_build import (
    CudaLibrary, LaunchCounter, check_launch, need, num_sms, on_cuda,
    stream)

KERNELS = ("tsne_repulsion", "tsne_repulsion_rows")
#: Pair elements per row block of the plain version (one (blk, n) f32
#: temporary is 256 MiB at this size).
_REF_ELEMS = 1 << 26

_counter = LaunchCounter(KERNELS)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return _counter.snapshot()


def reset_launch_counts() -> None:
    _counter.reset()


#: Query rows of a row-form tile (the kernel's kSymTile) and columns of a
#: foreign item (kForeignCols); the wrapper checks both against the
#: library.
ROW_TILE = 1024
FOREIGN_COLS = 512
#: Work-item kinds of the row form: query tile I against a foreign column
#: range, against itself, or against a later query tile (each unordered
#: pair once).
FOREIGN, OWN_DIAG, OWN_PAIR = 0, 1, 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = CudaLibrary("tsne_kernels", {
    "lo_tsne_repulsion": [_P, _P, _I, _I, _P, _I, _I, _I] + [_P] * 6,
    "lo_tsne_repulsion_sym": [_P, _P, _I] + [_P] * 5,
    "lo_tsne_sym_tile": [],
    "lo_tsne_foreign_cols": [],
    "lo_tsne_rows_blocks_per_sm": [],
})
SOURCE = _LIB.source
library_path = _LIB.path
#: nvcc's output for that library (ptxas registers and spills).
log_path = _LIB.log_path
build = _LIB.build


def tsne_repulsion_rows_ref(Yq: torch.Tensor, validq: torch.Tensor,
                            Y: torch.Tensor, valid: torch.Tensor,
                            offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``tsne_repulsion_rows``, blocked over query rows
    so no (nq, n) matrix exists; distances and forces from direct
    differences, in Y's float type."""
    nq, n = Yq.shape[0], Y.shape[0]
    dev = Y.device
    blk = max(1, _REF_ELEMS // max(n, 1))
    Z = torch.zeros((), dtype=Y.dtype, device=dev)
    F = torch.empty((nq, 2), dtype=Y.dtype, device=dev)
    for i in range(0, nq, blk):
        yr = Yq[i:i + blk]
        dx = yr[:, 0:1] - Y[None, :, 0]
        dy = yr[:, 1:2] - Y[None, :, 1]
        q = (dx * dx).addcmul_(dy, dy).add_(1.0).reciprocal_()
        q.mul_(valid[None, :]).mul_(validq[i:i + blk, None])
        # The self pair of each query row, where its global id is a column.
        r = torch.arange(len(yr), device=dev)
        on = (offset + i + r >= 0) & (offset + i + r < n)
        q[r[on], (offset + i + r)[on]] = 0.0
        Z = Z + q.sum()
        q.mul_(q)                                    # q²
        F[i:i + blk, 0] = (q * dx).sum(dim=1)
        F[i:i + blk, 1] = (q * dy).sum(dim=1)
    return Z, F


def rows_geometry(nq: int, n: int, offset: int, tile: int = ROW_TILE,
                  cols: int = FOREIGN_COLS) -> Tuple[np.ndarray, int]:
    """The row form's work list for query rows [offset, offset + nq) of n
    rows: ``(items, slots)``.

    Query tile I holds query rows [I·tile, (I+1)·tile). Each tile's
    partial sums go to ``slots`` slots in global column order: the
    foreign ranges of ``cols`` columns before ``offset``, the nt =
    ceil(nq / tile) query tiles, the foreign ranges after the query rows.
    ``items`` is an (n_items, 6) int32 array of (kind, I, a, b, row slot,
    column slot):

    - ``FOREIGN``: tile I against global columns [a, b), outside the
      query rows, every ordered pair; the row partial to (I, row slot);
    - ``OWN_DIAG``: tile I against itself (a = b = I), every ordered
      pair but the self pair;
    - ``OWN_PAIR``: tile I against query tile J = a = b > I, each
      unordered pair once; the row partial to (I, row slot) and the
      column partial to (J, column slot).

    Item k writes Z partial k. Heaviest first: tile pairs (a full tile
    of columns, both sides credited), diagonal tiles, then the foreign
    items (half a tile of columns), so the persistent blocks' last items
    are short. Column slot is -1 where an item has none."""
    nt = -(-nq // tile)
    before = [(a, min(a + cols, offset)) for a in range(0, offset, cols)]
    after = [(a, min(a + cols, n)) for a in range(offset + nq, n, cols)]
    nb = len(before)
    pairs, diags, foreign = [], [], []
    for i in range(nt):
        diags.append((OWN_DIAG, i, i, i, nb + i, -1))
        pairs += [(OWN_PAIR, i, j, j, nb + j, nb + i)
                  for j in range(i + 1, nt)]
        foreign += [(FOREIGN, i, a, b, s, -1)
                    for s, (a, b) in enumerate(before)]
        foreign += [(FOREIGN, i, a, b, nb + nt + s, -1)
                    for s, (a, b) in enumerate(after)]
    items = np.asarray(pairs + diags + foreign, np.int32).reshape(-1, 6)
    return items, nb + nt + len(after)


def check_row_views(Yq: torch.Tensor, validq: torch.Tensor,
                    Y: torch.Tensor, valid: torch.Tensor,
                    offset: int) -> None:
    """Refuse query rows that are not rows [offset, offset + nq) of Y
    itself: ``Yq`` and ``validq`` must be contiguous views of contiguous
    ``Y`` and ``valid`` starting at row ``offset`` (their data pointers
    compared). The row form's kernel reads the query rows out of Y and
    takes their own block once a pair, so a copy could hold other
    values."""
    nq, n = Yq.shape[0], Y.shape[0]
    if not 0 <= offset <= n - nq:
        raise ValueError(f"tsne_repulsion_rows: rows [{offset}, "
                         f"{offset + nq}) are not rows of Y ({n} rows)")
    for q, full, what in ((Yq, Y, "Yq"), (validq, valid, "validq")):
        if not (q.is_contiguous() and full.is_contiguous()):
            raise ValueError(f"tsne_repulsion_rows: {what} and its full "
                             "tensor must be contiguous")
        want = full.data_ptr() + offset * full.stride(0) * full.element_size()
        if q.data_ptr() != want:
            raise ValueError(
                f"tsne_repulsion_rows: {what} must be a view of its full "
                f"tensor at row {offset}")


@functools.lru_cache(maxsize=16)
def _rows_plan(nq: int, n: int, offset: int, device: torch.device):
    """The work list on the device, its slot count, and the persistent
    grid, per shape (a descent calls one shape every step)."""
    lib = _LIB.load()
    if (lib.lo_tsne_sym_tile(), lib.lo_tsne_foreign_cols()) != (
            ROW_TILE, FOREIGN_COLS):
        raise RuntimeError("tsne_kernels: the library's tiles are not "
                           f"({ROW_TILE}, {FOREIGN_COLS})")
    per_sm = lib.lo_tsne_rows_blocks_per_sm()
    if per_sm < 1:
        raise RuntimeError("tsne_repulsion_rows: the kernel fits no SM")
    items, slots = rows_geometry(nq, n, offset)
    grid = min(len(items), per_sm * num_sms(device))
    return torch.from_numpy(items).to(device), slots, grid


def tsne_repulsion_rows(Yq: torch.Tensor, validq: torch.Tensor,
                        Y: torch.Tensor, valid: torch.Tensor,
                        offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repulsion of query rows ``Yq`` (global rows [offset, offset+nq))
    against every row of ``Y``. Yq (nq, 2), validq (nq,), Y (n, 2),
    valid (n,) float32; on CUDA, Yq and validq views of Y and valid at
    ``offset`` (``check_row_views``). Returns (Z 0-d float32, F (nq, 2)
    float32), on the inputs' device; nothing is copied to the host."""
    if not on_cuda(Yq, validq, Y, valid):
        return tsne_repulsion_rows_ref(Yq, validq, Y, valid, offset)
    nq, n, offset = Yq.shape[0], Y.shape[0], int(offset)
    _check_inputs(Yq, validq, "Yq", "validq")
    _check_inputs(Y, valid, "Y", "valid")
    check_row_views(Yq, validq, Y, valid, offset)
    dev = Y.device
    items, slots, grid = _rows_plan(nq, n, offset, dev)
    nt = -(-nq // ROW_TILE)
    part = torch.empty((nt, slots, ROW_TILE, 2), dtype=torch.float32,
                       device=dev)
    zpart = torch.empty((len(items),), dtype=torch.float32, device=dev)
    nxt = torch.zeros((1,), dtype=torch.int32, device=dev)
    F = torch.empty((nq, 2), dtype=torch.float32, device=dev)
    Z = torch.empty((), dtype=torch.float32, device=dev)
    check_launch(_LIB.load().lo_tsne_repulsion(
        Y.data_ptr(), valid.data_ptr(), nq, offset, items.data_ptr(),
        len(items), slots, grid, nxt.data_ptr(), part.data_ptr(),
        zpart.data_ptr(), F.data_ptr(), Z.data_ptr(), stream(dev)),
        "tsne_repulsion_rows")
    _counter.add("tsne_repulsion_rows")
    return Z, F


def tsne_repulsion_ref(Y: torch.Tensor, valid: torch.Tensor):
    """Plain version of ``tsne_repulsion``."""
    return tsne_repulsion_rows_ref(Y, valid, Y, valid, 0)


def tsne_repulsion(Y: torch.Tensor, valid: torch.Tensor):
    """Exact t-SNE repulsion over all pairs of a 2-D embedding: Y (n, 2)
    float32, valid (n,) float32 (1 or 0) masks padding rows, which may
    sit anywhere. Returns (Z 0-d float32, F (n, 2) float32) on Y's
    device."""
    if not on_cuda(Y, valid):
        return tsne_repulsion_ref(Y, valid)
    n = Y.shape[0]
    _check_inputs(Y, valid, "Y", "valid")
    dev = Y.device
    lib = _LIB.load()
    nt = -(-n // lib.lo_tsne_sym_tile())
    part = torch.empty((nt, nt, lib.lo_tsne_sym_tile(), 2),
                       dtype=torch.float32, device=dev)
    zpart = torch.empty((nt * (nt + 1) // 2,), dtype=torch.float32,
                        device=dev)
    F = torch.empty((n, 2), dtype=torch.float32, device=dev)
    Z = torch.empty((), dtype=torch.float32, device=dev)
    check_launch(lib.lo_tsne_repulsion_sym(
        Y.data_ptr(), valid.data_ptr(), n, part.data_ptr(),
        zpart.data_ptr(), F.data_ptr(), Z.data_ptr(), stream(dev)),
        "tsne_repulsion")
    _counter.add("tsne_repulsion")
    return Z, F


def _check_inputs(Y: torch.Tensor, valid: torch.Tensor, y_name: str,
                  v_name: str) -> None:
    n = Y.shape[0]
    if n < 1:
        raise ValueError(f"tsne_repulsion needs rows: {y_name} has none")
    need(Y, y_name, torch.float32, (n, 2))
    need(valid, v_name, torch.float32, (n,))
    if Y.data_ptr() % 8:
        raise ValueError(f"{y_name}: rows must be 8-byte aligned")
