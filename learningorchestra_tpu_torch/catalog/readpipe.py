"""Asynchronous chunk-read pipeline: prefetch workers + host-RAM LRU cache.

The chunk store's hot read path (``Dataset.iter_chunks`` and
``SnapshotReader.scan``) was strictly sequential and synchronous: the
consumer thread blocked on file read + CRC verify + decode for every
chunk, and every pass re-read from disk. tf.data (arXiv:2101.12127)
identifies overlapping fetch/decode with compute and caching hot datasets
as the dominant input-pipeline levers; this module supplies both for the
catalog:

- **Prefetch** (``LO_TPU_PREFETCH_CHUNKS``, default 2): a shared,
  bounded worker pool materializes the next K chunks of a streaming scan
  while the consumer computes on the current one. Ordering is preserved
  (futures are consumed in submission order), worker failures — including
  :class:`~learningorchestra_tpu_torch.catalog.dataset.ChunkCorrupt` and armed
  failpoints — re-raise on the CONSUMER thread via ``Future.result()``
  (never a hang), and ``0`` keeps the exact synchronous path as the
  parity oracle.
- **Chunk cache** (``LO_TPU_CHUNK_CACHE_BYTES``, default 256 MiB): a
  byte-budgeted LRU of decoded chunk reads, shared across passes and
  datasets. Keys are ``(chunk file path, journal CRC32, field
  selection)`` — the path encodes dataset + generation + chunk id
  (``GGG-NNNNN.arrow`` under ``<store>/<dataset>/chunks/``) and the CRC
  pins the exact journaled bytes, so the key is *self-validating*:
  appends add new files (old entries stay correct), generation rewrites
  produce new paths, and a ``reopen`` that reuses a path writes different
  content under a different CRC. Explicit invalidation
  (``invalidate_under``) mostly just reclaims bytes promptly on
  delete/GC; the one *correctness* invalidation is replica repair
  (store._repair_chunk), which drops the repaired file's entries —
  lazy verification covers only a chunk's first read, so bytes decoded
  between rot-onset and repair may sit in the cache under the journal
  CRC. Field selections are cached whole (no per-column sharing), so
  overlapping selections of the same chunk duplicate column bytes
  within the budget — a deliberate simplicity trade-off; the hot paths
  (full-row streamed-fit scans, single-column aggregations) each reuse
  their own selection.

Thread-safety: the cache lock covers only dict bookkeeping (no I/O under
it). Cached column dicts are returned as shallow copies; the arrays
themselves are shared — consistent with the catalog's copy-on-write
invariant (columns are never mutated in place, projection already shares
parent chunk arrays).

Counters for every moving part (hits/misses/evictions/bytes, prefetch
stalls, worker errors) are served under ``read_pipeline`` on
``GET /metrics`` (docs/observability.md).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

_lock = threading.Lock()

#: (path, crc32, fields-signature) -> (columns dict, payload bytes).
_cache: "OrderedDict[Tuple, Tuple[Dict, int]]" = OrderedDict()
_cache_bytes = 0
#: None = read the budget from config.settings on next use (process
#: default); tests pin it via set_cache_budget().
_budget_override: Optional[int] = None

_counters = {
    "cache_hits": 0,
    "cache_misses": 0,
    "cache_evictions": 0,
    "prefetch_stalls": 0,
    "prefetched_chunks": 0,
    "worker_errors": 0,
}

_pool: Optional[ThreadPoolExecutor] = None


def _budget() -> int:
    if _budget_override is not None:
        return _budget_override
    from learningorchestra_tpu_torch.config import settings

    return int(settings.chunk_cache_bytes)


def set_cache_budget(max_bytes: Optional[int]) -> None:
    """Pin the cache byte budget (tests); ``None`` restores the config
    default. Shrinking evicts immediately."""
    global _budget_override
    with _lock:
        _budget_override = max_bytes
        _evict_to_locked(_budget())


def pool() -> ThreadPoolExecutor:
    """The shared prefetch worker pool (lazily created; sized to overlap
    I/O waits, not to saturate cores — decode is a minority of chunk-read
    time and the consumer thread is the real compute)."""
    global _pool
    with _lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=min(8, max(2, os.cpu_count() or 2)),
                thread_name_prefix="lo-readpipe")
        return _pool


def bump(key: str, by: int = 1) -> None:
    with _lock:
        _counters[key] += by


# --- shard-placement counters -------------------------------------------
# Written by mesh.shard_chunked's placement planner: rows of each
# addressable shard's feed classified against the dataset's ingest shard
# map as host-local vs peer-resident. The local fraction
# (local / (local + remote)) is THE placement health signal — an aligned
# feed over a sharded dataset should sit near 1.0.
_shard_counters = {
    "local_reads": 0,
    "remote_reads": 0,
}


def bump_shard(key: str, by: int = 1) -> None:
    with _lock:
        _shard_counters[key] += by


def shard_snapshot() -> Dict[str, int]:
    """Placement counter snapshot for ``GET /metrics`` (``shard``
    section; rendered as ``lo_shard_*_total``)."""
    with _lock:
        return dict(_shard_counters)


def cache_probe() -> Tuple[int, int]:
    """Current (cache_hits, cache_misses) totals — scan instrumentation
    (the ``readpipe.materialize`` span) diffs two probes to attribute a
    scan's cache traffic. Counters are process-global, so the delta is
    exact for the common single-scan case and approximate while scans
    overlap (documented on the span)."""
    with _lock:
        return _counters["cache_hits"], _counters["cache_misses"]


def snapshot() -> Dict[str, Any]:
    """Counter snapshot for ``GET /metrics`` (``read_pipeline`` section)."""
    with _lock:
        out: Dict[str, Any] = dict(_counters)
        out["cache_bytes"] = _cache_bytes
        out["cache_entries"] = len(_cache)
        out["cache_budget_bytes"] = _budget()
        return out


def reset() -> None:
    """Drop every cache entry and zero all counters (test isolation)."""
    global _cache_bytes
    with _lock:
        _cache.clear()
        _cache_bytes = 0
        for k in _counters:
            _counters[k] = 0
        for k in _shard_counters:
            _shard_counters[k] = 0


def _evict_to_locked(budget: int) -> None:
    global _cache_bytes
    while _cache and _cache_bytes > budget:
        _, (_, nbytes) = _cache.popitem(last=False)
        _cache_bytes -= nbytes
        _counters["cache_evictions"] += 1


def cache_get(path: str, crc32: Optional[int],
              fields_key: Optional[Tuple[str, ...]]) -> Optional[Dict]:
    """Cached decoded columns for one chunk read, or None. Chunks without
    a journaled CRC (pre-checksum journals) are never cached — their key
    would not be self-validating across a ``reopen`` reusing the path."""
    if crc32 is None or _budget() <= 0:
        return None
    key = (path, crc32, fields_key)
    with _lock:
        hit = _cache.get(key)
        if hit is None:
            _counters["cache_misses"] += 1
            return None
        _cache.move_to_end(key)
        _counters["cache_hits"] += 1
        # Shallow copy: callers may pop/replace dict entries; the arrays
        # are shared under the catalog's copy-on-write invariant.
        return dict(hit[0])


def cache_put(path: str, crc32: Optional[int],
              fields_key: Optional[Tuple[str, ...]],
              cols: Dict, nbytes: int) -> None:
    global _cache_bytes
    budget = _budget()
    if crc32 is None or budget <= 0 or nbytes > budget:
        return
    key = (path, crc32, fields_key)
    with _lock:
        old = _cache.pop(key, None)
        if old is not None:
            _cache_bytes -= old[1]
        _cache[key] = (dict(cols), nbytes)
        _cache_bytes += nbytes
        _evict_to_locked(budget)


def invalidate_under(dir_path: str) -> None:
    """Drop every cache entry whose chunk file lives under ``dir_path`` —
    the prompt-reclaim hook for dataset delete/reopen and chunk-file GC
    (correctness never depends on it: keys are CRC-pinned)."""
    global _cache_bytes
    prefix = dir_path.rstrip(os.sep) + os.sep
    with _lock:
        stale = [k for k in _cache if k[0].startswith(prefix)]
        for k in stale:
            _, nbytes = _cache.pop(k)
            _cache_bytes -= nbytes


def invalidate_files(paths) -> None:
    """Drop cache entries for specific chunk files (GC of a superseded
    generation). Same correctness note as :func:`invalidate_under`."""
    global _cache_bytes
    gone = set(paths)
    with _lock:
        stale = [k for k in _cache if k[0] in gone]
        for k in stale:
            _, nbytes = _cache.pop(k)
            _cache_bytes -= nbytes


def prefetch_depth(override: Optional[int] = None) -> int:
    """Resolve the prefetch window: explicit override, else the process
    setting (``LO_TPU_PREFETCH_CHUNKS``)."""
    if override is not None:
        return max(0, int(override))
    from learningorchestra_tpu_torch.config import settings

    return max(0, int(settings.prefetch_chunks))
