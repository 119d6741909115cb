"""Device runtime — one CUDA device holding the framework's tensors.

The JAX package row-shards every array over a device mesh
(``learningorchestra_tpu/parallel/mesh.py``). Here each process owns one
device and one place on the (data, model, seq) mesh of its process group
(``mesh``, parallel/mesh.py). With one rank on the data axis,
``shard_rows`` is a host→device copy of the whole array. With D > 1
ranks on it (a pod, parallel/spmd.py), rows are padded with zeros to a
multiple of D and each rank holds its block of ``ceil(n / D)`` rows:
rank k of the data axis rows [k·L, (k+1)·L). The trainers mask the
padding (``valid_rows``) and sum over the data axis; ``host_rows``
all-gathers a row-sharded result and drops the padding. ``replicate``
is a copy of a small value on every rank. On a pod both entry points
refuse to run outside a dispatched job (``spmd.check_mesh_entry``): the
collectives that follow them would run on one rank alone. What carries
over from the one-device runtime is the transfer cache: a five-classifier
build hands the same design matrix to five trainers, and each would
otherwise copy gigabytes over PCIe again — one copy of X serves every
family.

A lazy design matrix (``ops/preprocess.ChunkedDesign``: ``.shape``,
``.dtype``, ``.rows(start, stop)``) never exists whole on the host: the
device tensor is allocated once and filled block by block
(``_feed_lazy``, the port of the JAX package's ``shard_chunked``). On a
card each block lands in one of two pinned host buffers and is copied
on a side stream while the read pipeline's pool reads the next, so host
memory holds the two pinned blocks and the reads in flight, never O(n).
On a pod each rank reads only its own block's rows.

The runtime never moves to another device by itself: ``device="cuda"``
(the default) raises when no CUDA device is present, and only an explicit
``device="cpu"`` runs on the host.
"""

from __future__ import annotations

import threading
import warnings
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from learningorchestra_tpu_torch.catalog import readpipe
from learningorchestra_tpu_torch.config import (
    Settings, settings as global_settings)
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, ProcessMesh, all_gather, local_mesh)
from learningorchestra_tpu_torch.utils import tracing


def host_rows(x) -> np.ndarray:
    """Device tensor → host numpy (a plain copy of this rank's tensor;
    ``DeviceRuntime.host_rows`` gathers a row-sharded one)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _plan_placement(start: int, stop: int, shard_map) -> None:
    """Classify this rank's row range of a streamed design against the
    dataset's ingest shard map (owner host → contiguous row range,
    recorded by the range-partitioned ingest, catalog/ingest.py): rows
    whose owner is this host (``spmd.local_host_id``) count local, the
    rest remote — readpipe's ``lo_shard_local_reads_total`` /
    ``_remote_reads_total``, whose local fraction is the placement
    health signal."""
    if not shard_map or stop <= start:
        return
    parts = shard_map.get("partitions") or []
    if not parts:
        return
    from learningorchestra_tpu_torch.parallel import spmd

    reader = spmd.local_host_id()
    local = 0
    for p in parts:
        if int(p.get("host", -1)) != reader:
            continue
        r0 = int(p.get("row_start", 0))
        r1 = r0 + int(p.get("rows", 0))
        local += max(0, min(stop, r1) - max(start, r0))
    if local:
        readpipe.bump_shard("local_reads", local)
    if (stop - start) - local:
        readpipe.bump_shard("remote_reads", (stop - start) - local)


#: Every tensor a ``DeviceRuntime`` placed, held weakly by id: the CPU
#: rig's device-memory reading (utils/resources.py ``live_buffers``)
#: sums the ones still alive. A card reads its allocator's counters
#: instead. (Not a ``WeakSet``: a set compares colliding entries with
#: ``==``, which a tensor answers elementwise.)
_placed: Dict[int, "weakref.ref[torch.Tensor]"] = {}


def _track(t: torch.Tensor) -> torch.Tensor:
    key = id(t)

    def _gone(ref, key=key):
        # Runs at collection, on whatever thread collects: a plain dict
        # operation, no lock (a lock held by that thread would deadlock).
        if _placed.get(key) is ref:
            _placed.pop(key, None)

    _placed[key] = weakref.ref(t, _gone)
    return t


def placed_bytes() -> int:
    """Bytes of the live tensors the runtime placed, each storage counted
    once (a view shares its base's storage)."""
    while True:
        try:
            refs = list(_placed.values())
            break
        except RuntimeError:        # a collection resized the dict
            continue
    seen = {}
    for ref in refs:
        t = ref()
        if t is None:
            continue
        st = t.untyped_storage()
        seen[(str(t.device), st.data_ptr())] = st.nbytes()
    return int(sum(seen.values()))


def resolve_device(device: str = "cuda") -> torch.device:
    """The torch device an entry point runs on: ``"cuda"`` (the default;
    the current CUDA device) raises when no CUDA device is present, and
    only an explicit ``"cpu"`` runs on the host."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} needs a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class DeviceRuntime:
    """Process-wide device holder for compute jobs.

    ``shard_rows`` memoizes host→device transfers per host array, keyed
    by the array's identity and dropped when the host array is garbage-
    collected. Callers must treat arrays handed to ``shard_rows`` as
    immutable; the cache enforces this by marking cached owner-arrays
    read-only (a later in-place write raises instead of silently
    computing on stale device data). Views are copied uncached. Lazy
    designs are cached by identity too: each pins its row snapshot for
    its lifetime, so its rows never change.
    """

    #: Rows of a lazy design read and copied at a time: 2^20 rows is
    #: 112 MiB of float32 at the HIGGS width (d = 28); the feed pins two
    #: such buffers.
    FEED_BLOCK_ROWS = 1 << 20

    def __init__(self, cfg: Optional[Settings] = None,
                 device: str = "cuda"):
        self.cfg = cfg or global_settings
        self.device = resolve_device(device)
        # RLock: cache-eviction finalizers can fire from gc inside a
        # lock-holding allocation; a plain Lock would self-deadlock.
        self._lock = threading.RLock()
        self._transfer_cache: dict = {}
        self._mesh: Optional[ProcessMesh] = None

    @property
    def mesh(self) -> ProcessMesh:
        """The (data, model, seq) mesh over the process group's ranks
        (parallel/mesh.py), built at first use: with a process group that
        first use is collective, so every rank reaches it in the same
        order. 1×1×1 with no process group."""
        with self._lock:
            if self._mesh is None:
                self._mesh = local_mesh(self.cfg)
        return self._mesh

    def data_shards(self) -> Tuple[int, int]:
        """(D, k): the ranks on the data axis and this rank's index on
        it."""
        mesh = self.mesh
        return mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)

    def row_block(self, n: int) -> Tuple[int, int]:
        """(start, rows) of this rank's block of ``n`` rows: rows [start,
        start + rows) of the zero-padded array, ``rows = ceil(n / D)``."""
        D, k = self.data_shards()
        rows = -(-int(n) // D) if D > 1 else int(n)
        return k * rows, rows

    def valid_rows(self, n: int) -> Optional[torch.Tensor]:
        """This rank's (rows,) float32 mask of real (1) and padding (0)
        rows of a row-sharded array of ``n`` rows; None with one rank on
        the data axis, where no row is padding."""
        if self.data_shards()[0] == 1:
            return None
        start, rows = self.row_block(n)
        idx = torch.arange(start, start + rows, device=self.device)
        return (idx < int(n)).float()

    def host_rows(self, x, n: Optional[int] = None) -> np.ndarray:
        """A row-sharded device result → the host array of all its rows:
        all-gathered over the data axis (a collective every rank of the
        job reaches) and cut to the ``n`` real rows. One rank on the data
        axis: a plain copy."""
        if isinstance(x, torch.Tensor) and self.data_shards()[0] > 1:
            x = all_gather(x.contiguous(), self.mesh, DATA_AXIS, dim=0)
        out = host_rows(x)
        return out if n is None else out[:n]

    def _block(self, arr: np.ndarray) -> np.ndarray:
        """This rank's zero-padded block of a host array (the whole array
        with one rank on the data axis)."""
        if self.data_shards()[0] == 1:
            return arr
        start, rows = self.row_block(arr.shape[0])
        block = arr[start:start + rows]
        if block.shape[0] < rows:
            block = np.concatenate([block, np.zeros(
                (rows - block.shape[0],) + arr.shape[1:], arr.dtype)])
        return block

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        with warnings.catch_warnings():
            # Cached host arrays are frozen read-only; the zero-copy view
            # only feeds the copy below and is never written.
            warnings.filterwarnings("ignore", message=".*not writable.*")
            t = torch.from_numpy(np.ascontiguousarray(arr))
        with tracing.span("runtime.put", bytes=t.nbytes, pinned=False):
            if self.device.type == "cuda":
                return _track(t.to(self.device))
            # CPU: copy, so the tensor never aliases a host array the
            # caller may later unfreeze or that the cache finalizer tracks.
            return _track(t.clone())

    def shard_rows(self, arr) -> Tuple[torch.Tensor, int]:
        """Host array or lazy design → this rank's device tensor (all
        rows with one rank on the data axis, else its zero-padded block).
        Returns the tensor and the global row count, the JAX runtime's
        contract."""
        from learningorchestra_tpu_torch.parallel import spmd

        # Structural SPMD guard: on a pod, host→device entry is only
        # legal inside a dispatched job scope — nothing can "forget" to
        # dispatch and wedge the pod in a collective.
        spmd.check_mesh_entry("shard_rows")
        if hasattr(arr, "rows") and not isinstance(arr, np.ndarray):
            return self._cached(("design", id(arr)), arr,
                                lambda: self._feed_lazy(arr))
        if not isinstance(arr, np.ndarray):
            arr = np.asarray(arr)
            return self._put(self._block(arr)), int(arr.shape[0])
        # Views never enter the cache — freezing a view leaves its base
        # writable, so mutation through the base would still serve stale
        # device data silently.
        if arr.base is not None or not arr.flags.owndata:
            return self._put(self._block(arr)), int(arr.shape[0])

        def put():
            arr.flags.writeable = False
            return self._put(self._block(arr)), int(arr.shape[0])

        return self._cached((id(arr), arr.shape, str(arr.dtype)), arr, put)

    def _cached(self, key, owner, make) -> Tuple[torch.Tensor, int]:
        # The copy runs under the lock: the builder's family threads ask
        # for the same design matrix at once, and each must find the one
        # copy instead of starting its own.
        with self._lock:
            hit = self._transfer_cache.get(key)
            if hit is not None:
                return hit
            out = make()
            self._transfer_cache[key] = out

            def _evict(cache=self._transfer_cache, key=key, lock=self._lock):
                with lock:
                    cache.pop(key, None)

            # Drop the device copy when the host owner dies (also guards
            # against a recycled id() pointing at the stale entry).
            weakref.finalize(owner, _evict)
        return out

    def _feed_lazy(self, design) -> Tuple[torch.Tensor, int]:
        """Fill this rank's device tensor — all n rows, or on a pod its
        zero-padded block (``row_block``) — from ``design.rows`` in
        blocks of ``FEED_BLOCK_ROWS``; a rank reads no other rank's rows.

        While block i is copied, the read pipeline's pool reads block
        i+1 (``prefetch_chunks`` > 0). On a card the read lands in one of
        two pinned buffers, which is copied with ``non_blocking=True`` on
        a side stream; an event per buffer keeps the read of block i+2
        from refilling the buffer before block i's copy has left it. The
        caller's stream waits on the copy stream before the tensor is
        returned, and the host waits for the last copies, so every
        thread's stream sees the whole tensor. ``prefetch_chunks = 0`` is
        the strictly serial read→copy loop, the parity oracle; on the
        CPU the same loop copies each block into the tensor in place."""
        n = int(design.shape[0])
        tail = tuple(int(s) for s in design.shape[1:])
        dtype = np.dtype(getattr(design, "dtype", np.float32))
        start, rows = self.row_block(n)
        stop = min(start + rows, n)
        out = _track(torch.empty(
            (rows,) + tail, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
            device=self.device))
        if stop - start < rows:
            out[max(0, stop - start):].zero_()          # padding rows
        if self.data_shards()[0] > 1:
            _plan_placement(start, stop,
                            getattr(design, "shard_map", None))
        blk = max(1, int(self.FEED_BLOCK_ROWS))
        # (a, b) are global rows; they land at out[a - start : b - start].
        ranges = [(a, min(a + blk, stop)) for a in range(start, stop, blk)]
        if not ranges:
            return out, n
        cuda = self.device.type == "cuda"
        with tracing.span("runtime.put", bytes=out[:stop - start].nbytes,
                          pinned=cuda):
            if cuda:
                nbuf = min(2, len(ranges))
                bufs = [torch.empty((min(blk, stop - start),) + tail,
                                    dtype=out.dtype, pin_memory=True)
                        for _ in range(nbuf)]
                freed = [torch.cuda.Event() for _ in range(nbuf)]
                stream = torch.cuda.Stream(self.device)
                # ``out`` may reuse memory that work queued on the caller's
                # stream still reads: the copies start after that work.
                stream.wait_stream(torch.cuda.current_stream(self.device))

            def read(i: int) -> torch.Tensor:
                a, b = ranges[i]
                rows = np.ascontiguousarray(
                    np.asarray(design.rows(a, b), dtype))
                if rows.shape != (b - a,) + tail:
                    raise ValueError(f"design.rows({a}, {b}) gave shape "
                                     f"{rows.shape}")
                host = torch.from_numpy(rows)
                if not cuda:
                    return host
                k = i % nbuf
                freed[k].synchronize()     # block i-2's copy has left it
                bufs[k][:b - a].copy_(host)
                return bufs[k][:b - a]

            depth = readpipe.prefetch_depth(self.cfg.prefetch_chunks)
            pool = readpipe.pool() if depth > 0 and len(ranges) > 1 else None
            ahead = None
            try:
                for i, (a, b) in enumerate(ranges):
                    if pool is None:
                        host = read(i)
                    else:
                        fut = (ahead if ahead is not None
                               else pool.submit(read, i))
                        ahead = (pool.submit(read, i + 1)
                                 if i + 1 < len(ranges) else None)
                        if ahead is not None:
                            readpipe.bump("prefetched_chunks")
                        if not fut.done():
                            readpipe.bump("prefetch_stalls")
                        try:
                            host = fut.result()
                        except BaseException:
                            readpipe.bump("worker_errors")
                            raise
                    if cuda:
                        with torch.cuda.stream(stream):
                            out[a - start:b - start].copy_(host,
                                                           non_blocking=True)
                            freed[i % nbuf].record(stream)
                    else:
                        out[a - start:b - start].copy_(host)
            finally:
                if ahead is not None:
                    ahead.cancel()
                    if not ahead.cancelled():
                        try:
                            ahead.result()
                        except Exception:  # noqa: BLE001 — a discarded read
                            pass
            if cuda:
                done = torch.cuda.Event()
                done.record(stream)
                torch.cuda.current_stream(self.device).wait_event(done)
                out.record_stream(stream)
                # The pinned buffers die with this frame: wait for their last
                # copies (also makes the tensor whole for every thread's
                # stream, not only the caller's).
                done.synchronize()
        return out, n

    def replicate(self, x) -> torch.Tensor:
        """A small host value (edges, scalars, params) on the device: a
        local copy on every rank (each holds the same host value)."""
        from learningorchestra_tpu_torch.parallel import spmd

        spmd.check_mesh_entry("replicate")
        if isinstance(x, torch.Tensor):
            return _track(x.to(self.device))
        return self._put(np.asarray(x))

