"""Device runtime — one CUDA device holding the framework's tensors.

The JAX package row-shards every array over a device mesh
(``learningorchestra_tpu/parallel/mesh.py``). This package runs on one
device, so ``shard_rows`` is a host→device copy of the whole array and
``replicate`` a copy of a small one. What carries over is the transfer
cache: a five-classifier build hands the same design matrix to five
trainers, and each would otherwise copy gigabytes over PCIe again —
one copy of X serves every family.

The runtime never moves to another device by itself: ``device="cuda"``
(the default) raises when no CUDA device is present, and only an explicit
``device="cpu"`` runs on the host.
"""

from __future__ import annotations

import threading
import warnings
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from learningorchestra_tpu_torch.config import (
    Settings, settings as global_settings)


def host_rows(x) -> np.ndarray:
    """Device tensor → host numpy (a plain copy on one device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
    computing on stale device data). Views are copied uncached.
    """

    def __init__(self, cfg: Optional[Settings] = None,
                 device: str = "cuda"):
        self.cfg = cfg or global_settings
        self.device = resolve_device(device)
        # RLock: cache-eviction finalizers can fire from gc inside a
        # lock-holding allocation; a plain Lock would self-deadlock.
        self._lock = threading.RLock()
        self._transfer_cache: dict = {}

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        with warnings.catch_warnings():
            # Cached host arrays are frozen read-only; the zero-copy view
            # only feeds the copy below and is never written.
            warnings.filterwarnings("ignore", message=".*not writable.*")
            t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.to(self.device)
        # CPU: copy, so the tensor never aliases a host array the caller
        # may later unfreeze or that the cache finalizer tracks.
        return t.clone()

    def shard_rows(self, arr) -> Tuple[torch.Tensor, int]:
        """Host array → device tensor (all rows, one device). Returns the
        tensor and its row count, the JAX runtime's contract."""
        if hasattr(arr, "rows") and not isinstance(arr, np.ndarray):
            raise NotImplementedError(
                "streamed (chunked) design matrices are not yet ported")
        if not isinstance(arr, np.ndarray):
            arr = np.asarray(arr)
            return self._put(arr), int(arr.shape[0])
        # Views never enter the cache — freezing a view leaves its base
        # writable, so mutation through the base would still serve stale
        # device data silently.
        if arr.base is not None or not arr.flags.owndata:
            return self._put(arr), int(arr.shape[0])
        key = (id(arr), arr.shape, str(arr.dtype))
        # The copy runs under the lock: the builder's family threads ask
        # for the same design matrix at once, and each must find the one
        # copy instead of starting its own.
        with self._lock:
            hit = self._transfer_cache.get(key)
            if hit is not None:
                return hit
            arr.flags.writeable = False
            out = (self._put(arr), int(arr.shape[0]))
            self._transfer_cache[key] = out

            def _evict(cache=self._transfer_cache, key=key, lock=self._lock):
                with lock:
                    cache.pop(key, None)

            # Drop the device copy when the host array dies (also guards
            # against a recycled id() pointing at the stale entry).
            weakref.finalize(arr, _evict)
        return out

    def replicate(self, x) -> torch.Tensor:
        """A small host value (edges, scalars, params) on the device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return self._put(np.asarray(x))

