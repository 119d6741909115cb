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
every column (the direct form).

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
``launch_counts()["tsne_repulsion"]``. Unlike the Pallas kernel, neither
form needs n or nq to be a multiple of a tile. The two forms group their
float sums differently, so a row range agrees with the whole call to
rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from learningorchestra_tpu_torch.ops._cuda_build import (
    CudaLibrary, LaunchCounter, check_launch, need, on_cuda, stream)

KERNELS = ("tsne_repulsion",)
#: Pair elements per row block of the plain version (one (blk, n) f32
#: temporary is 256 MiB at this size).
_REF_ELEMS = 1 << 26

_counter = LaunchCounter(KERNELS)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return _counter.snapshot()


def reset_launch_counts() -> None:
    _counter.reset()


_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = CudaLibrary("tsne_kernels", {
    "lo_tsne_repulsion": [_P] * 4 + [_I] * 3 + [_P] * 5,
    "lo_tsne_repulsion_sym": [_P, _P, _I] + [_P] * 5,
    "lo_tsne_sym_tile": [],
    "lo_tsne_rows_per_block": [],
    "lo_tsne_cols_per_chunk": [],
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
    differences."""
    nq, n = Yq.shape[0], Y.shape[0]
    dev = Y.device
    blk = max(1, _REF_ELEMS // max(n, 1))
    Z = torch.zeros((), dtype=torch.float32, device=dev)
    F = torch.empty((nq, 2), dtype=torch.float32, device=dev)
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


def tsne_repulsion_rows(Yq: torch.Tensor, validq: torch.Tensor,
                        Y: torch.Tensor, valid: torch.Tensor,
                        offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repulsion of query rows ``Yq`` (global rows [offset, offset+nq))
    against every row of ``Y``. Yq (nq, 2), validq (nq,), Y (n, 2),
    valid (n,) float32. Returns (Z 0-d float32, F (nq, 2) float32), on
    the inputs' device; nothing is copied to the host."""
    if not on_cuda(Yq, validq, Y, valid):
        return tsne_repulsion_rows_ref(Yq, validq, Y, valid, offset)
    nq, n = Yq.shape[0], Y.shape[0]
    _check_inputs(Yq, validq, "Yq", "validq")
    _check_inputs(Y, valid, "Y", "valid")
    dev = Y.device
    lib = _LIB.load()
    row_blocks = -(-nq // lib.lo_tsne_rows_per_block())
    n_chunks = -(-n // lib.lo_tsne_cols_per_chunk())
    fpart = torch.empty((n_chunks, nq, 2), dtype=torch.float32, device=dev)
    zpart = torch.empty((n_chunks * row_blocks,), dtype=torch.float32,
                        device=dev)
    F = torch.empty((nq, 2), dtype=torch.float32, device=dev)
    Z = torch.empty((), dtype=torch.float32, device=dev)
    check_launch(lib.lo_tsne_repulsion(
        Yq.data_ptr(), validq.data_ptr(), Y.data_ptr(), valid.data_ptr(),
        nq, n, int(offset), fpart.data_ptr(), zpart.data_ptr(),
        F.data_ptr(), Z.data_ptr(), stream(dev)), "tsne_repulsion")
    _counter.add("tsne_repulsion")
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
