"""The (data, model, seq) mesh over the ranks of a process group, and the
differentiable collectives the sequence transformer runs on it.

The JAX package builds a ``jax.sharding.Mesh`` over its devices with the
named axes ``data`` (rows), ``model`` (Megatron-style tensor parallelism)
and ``seq`` (context parallelism, parallel/ring_attention.py), and its
programs run per shard inside ``shard_map``. Here each rank of the
``torch.distributed`` world owns one device, and ``ProcessMesh`` places
the ranks on the three axes row-major — rank ``(d·M + m)·S + s`` sits at
``(d, m, s)``, as ``mesh_utils.create_device_mesh((D, M, S))`` lays out
the CPU devices — with one process group per axis line through each
rank. With no process group the mesh is 1×1×1 and every collective is
the identity.

``shard_map`` differentiates through its collectives with replication
tracking; PyTorch's autograd does not know what is replicated, so the
collectives say what their transposes are:

- ``psum``: all-reduce forward, identity backward — the sum of varying
  values is replicated, and its cotangent arrives replicated;
- ``pvary``: identity forward, all-reduce backward — a replicated value
  entering per-rank work (Megatron's ``f``, the entry into a model-split
  region); its transpose is the sum of the ranks' partial cotangents;
- ``ppermute``: one hop around the ring of an axis
  (``batch_isend_irecv``); backward is the inverse hop.

A collective on a mesh whose process group exists is issued whatever the
axis size (a one-rank group included); only a mesh with no process group
skips them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from learningorchestra_tpu_torch.config import (
    Settings, settings as global_settings)

DATA_AXIS = "data"
MODEL_AXIS = "model"
#: Sequence/context-parallel axis: long sequences shard their length across
#: it and attention runs as a ring (parallel/ring_attention.py).
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)


def parse_mesh_shape(mesh_shape: str, n: int) -> Tuple[int, int, int]:
    """``"D,M"`` or ``"D,M,S"`` over ``n`` ranks (the seq axis defaults to
    1); empty puts every rank on the data axis. The JAX package's
    messages."""
    if not mesh_shape:
        return n, 1, 1
    dims = [int(x) for x in mesh_shape.split(",")]
    if len(dims) not in (2, 3):
        raise ValueError(
            f"mesh_shape {mesh_shape!r} must be 'D,M' or 'D,M,S'")
    if len(dims) == 2:
        dims.append(1)                      # no seq axis requested
    d, m, s = dims
    if d * m * s != n:
        raise ValueError(f"mesh_shape {mesh_shape} != device count {n}")
    return d, m, s


class ProcessMesh:
    """This rank's place on the (data, model, seq) mesh.

    ``shape`` is an ordered dict of the axis sizes, ``coords`` this rank's
    index on each axis, and ``groups`` the process group of each axis line
    through this rank (None for every axis when there is no process
    group)."""

    def __init__(self, shape: Tuple[int, int, int], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None):
        self.shape = OrderedDict(zip(AXES, (int(v) for v in shape)))
        self.rank = int(rank)
        _, m, s = self.shape.values()
        self.coords = OrderedDict(
            zip(AXES, (rank // (m * s), rank // s % m, rank % s)))
        self.groups = groups or {a: None for a in AXES}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's line along ``axis``, in axis
        order."""
        return _line(self.shape, self.coords, axis)

    def __repr__(self) -> str:
        return (f"ProcessMesh({dict(self.shape)}, rank={self.rank}, "
                f"coords={dict(self.coords)})")


def _rank_of(shape, coords) -> int:
    _, m, s = shape.values()
    return (coords[DATA_AXIS] * m + coords[MODEL_AXIS]) * s + coords[SEQ_AXIS]


def _line(shape, coords, axis: str) -> List[int]:
    out = []
    for i in range(shape[axis]):
        c = dict(coords)
        c[axis] = i
        out.append(_rank_of(shape, c))
    return out


def local_mesh(cfg: Optional[Settings] = None) -> ProcessMesh:
    """The mesh over the process group's ranks (default: every rank on the
    data axis; ``cfg.mesh_shape`` forces the layout). Without a process
    group: 1×1×1, no groups.

    Creating the groups is collective: every rank calls this, and every
    rank creates every axis line's group in the same order (axis by axis,
    lines in row-major order of the other two coordinates)."""
    cfg = cfg or global_settings
    if not dist.is_initialized():
        return ProcessMesh(parse_mesh_shape(cfg.mesh_shape, 1))
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = OrderedDict(zip(AXES, parse_mesh_shape(cfg.mesh_shape, world)))
    mesh = ProcessMesh(tuple(shape.values()), rank)
    groups = {}
    for axis in AXES:
        others = [a for a in AXES if a != axis]
        for i in range(shape[others[0]]):
            for j in range(shape[others[1]]):
                ranks = _line(shape, {others[0]: i, others[1]: j, axis: 0},
                              axis)
                g = dist.new_group(ranks=ranks)
                if rank in ranks:
                    groups[axis] = g
    mesh.groups = groups
    return mesh


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _hop(x: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
    """Send ``x`` to global rank ``dst`` and receive a tensor like it from
    ``src`` in one batch."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.ring = (group, nxt, prv)
        return _hop(x, group, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        group, nxt, prv = ctx.ring
        return _hop(g, group, prv, nxt), None, None, None


def psum(x: torch.Tensor, mesh: ProcessMesh, axis: str) -> torch.Tensor:
    """Sum over ``axis`` (all-reduce); its cotangent passes through."""
    group = mesh.groups[axis]
    return x if group is None else _PSum.apply(x, group)


def pvary(x: torch.Tensor, mesh: ProcessMesh, axis: str) -> torch.Tensor:
    """A value replicated over ``axis`` entering per-rank work: the
    identity forward, the sum of the ranks' cotangents backward."""
    group = mesh.groups[axis]
    return x if group is None else _PVary.apply(x, group)


def ppermute_next(x: torch.Tensor, mesh: ProcessMesh,
                  axis: str) -> torch.Tensor:
    """Rotate ``x`` one hop around ``axis``'s ring: rank i sends to i+1
    and receives from i−1 (mod the axis size), as JAX's ``ppermute`` with
    ``perm = [(j, (j + 1) % P)]``."""
    group = mesh.groups[axis]
    if group is None or mesh.size(axis) == 1:
        return x
    ring = mesh.axis_ranks(axis)
    i, p = mesh.index(axis), mesh.size(axis)
    return _PPermute.apply(x, group, ring[(i + 1) % p], ring[(i - 1) % p])


def all_reduce_(t: torch.Tensor, mesh: ProcessMesh, axis: str) -> None:
    """Sum ``t`` over ``axis`` in place (no autograd: gradients after
    ``backward``). ``t`` must be contiguous: NCCL refuses a strided
    tensor (gloo takes one, so the CPU checks it here)."""
    group = mesh.groups[axis]
    if group is not None:
        if not t.is_contiguous():
            raise ValueError("all_reduce_ needs a contiguous tensor")
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def all_gather(t: torch.Tensor, mesh: ProcessMesh, axis: str,
               dim: int) -> torch.Tensor:
    """Concatenate the ranks' ``t`` along ``dim`` in axis order (no
    autograd)."""
    group = mesh.groups[axis]
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)
