"""Profiling + op timing — the observability tier SURVEY.md §5 calls for.

The reference's only performance instrumentation is the per-model
``fit_time`` wall clock persisted with results (reference
model_builder.py:199-204); everything else was delegated to Spark's web
UIs. Here:

- every framework operation (ingest, projection, histogram, each model
  fit, each embedding) records its wall-clock into a process-wide
  ``OpTimer`` — count/total/mean/max PLUS a log-bucketed latency
  histogram per op, which is what ``GET /metrics?format=prometheus``
  exposes as real histogram series and what the p50/p99 estimates
  derive from (a rolling sample window keeps only recent shape; the
  histogram is exact over the op's whole life at O(#buckets) memory);
- ``timed``/``device_span`` are span-emitting: under an ambient trace
  (utils/tracing.py) each timed region also records a span with the
  exact measured duration, so per-request traces and aggregate metrics
  can never disagree about the same measurement;
- setting ``LO_TPU_PROFILE_DIR`` wraps compute jobs in a
  ``torch.profiler`` trace so every kernel launch, copy and CPU-side
  operator lands in a Chrome-trace file — the device-level view Spark's
  stage UI approximated.
"""

from __future__ import annotations

import bisect
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.utils import tracing

#: Log-spaced histogram bucket upper bounds, seconds (Prometheus-style
#: 1-2.5-5 ladder from 1 ms to 60 s; one implicit +Inf bucket past the
#: end). Shared by OpTimer and the serving tier's latency stats so every
#: histogram on /metrics speaks the same ladder.
BUCKETS_S: Sequence[float] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def new_histogram() -> List[int]:
    """Zeroed per-bucket counts (len(BUCKETS_S) + 1: last = +Inf)."""
    return [0] * (len(BUCKETS_S) + 1)


def observe(buckets: List[int], seconds: float) -> None:
    """Count one observation into its (non-cumulative) bucket."""
    buckets[bisect.bisect_left(BUCKETS_S, seconds)] += 1


def quantile_from_buckets(buckets: Sequence[int],
                          q: float) -> Optional[float]:
    """Estimate the q-quantile (seconds) from non-cumulative bucket
    counts by linear interpolation within the containing bucket — the
    standard Prometheus ``histogram_quantile`` scheme. The +Inf bucket
    clamps to the last finite bound (an estimate can't exceed what the
    ladder resolves). None when empty."""
    total = sum(buckets)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    for i, c in enumerate(buckets):
        if c == 0:
            continue
        prev = cum
        cum += c
        if cum >= target:
            if i >= len(BUCKETS_S):
                return BUCKETS_S[-1]
            lo = BUCKETS_S[i - 1] if i > 0 else 0.0
            hi = BUCKETS_S[i]
            return lo + (hi - lo) * max(0.0, min(1.0, (target - prev) / c))
    return BUCKETS_S[-1]


class OpTimer:
    """Thread-safe aggregate wall-clock stats per operation name.

    An entry exists only once something was recorded into it, so every
    snapshot entry has ``count >= 1`` by construction — ``mean_s`` is a
    plain division, never a guarded one that silently reads 0.0 for an
    empty entry (the old ``max(count, 1)`` bug class)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict] = {}

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            s = self._stats.get(name)
            if s is None:
                s = self._stats[name] = {
                    "count": 0, "total_s": 0.0, "max_s": 0.0,
                    "buckets": new_histogram()}
            s["count"] += 1
            s["total_s"] += seconds
            s["max_s"] = max(s["max_s"], seconds)
            observe(s["buckets"], seconds)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            out = {}
            for name, s in self._stats.items():
                out[name] = {
                    "count": s["count"],
                    "total_s": s["total_s"],
                    "max_s": s["max_s"],
                    # count >= 1 always: entries are created by record().
                    "mean_s": s["total_s"] / s["count"],
                    "p50_s": quantile_from_buckets(s["buckets"], 0.50),
                    "p99_s": quantile_from_buckets(s["buckets"], 0.99),
                    "buckets": list(s["buckets"]),
                }
            return out


#: Process-global timer (one server process = one metrics surface).
op_timer = OpTimer()


@contextmanager
def timed(name: str, timer: Optional[OpTimer] = None):
    """Time a region into the op timer AND, under an ambient trace,
    record a span of the same name with the identical duration."""
    t0 = time.time()
    try:
        yield
    finally:
        dur = time.time() - t0
        (timer or op_timer).record(name, dur)
        tracing.record_span(name, dur)


def device_span(fn, name: Optional[str] = None, device=None,
                attrs: Optional[dict] = None):
    """Run ``fn`` and return ``(result, seconds)`` where the span covers
    the work's launch *through completion on the device*: CUDA launches
    are asynchronous, so an unsynchronised wall clock around them
    measures enqueue time, not compute. On a CUDA ``device`` the span
    ends with ``torch.cuda.synchronize(device)``; on the CPU the work is
    already complete when ``fn`` returns.

    When the caller serializes device work (one fit in its device phase
    at a time), the span is the fit's device occupancy plus its transfer
    tail — the ``device_s`` figure that separates host jitter from
    device compute. Under overlapped fits it includes the other fits'
    work queued on the same card and is reported as such.

    Every device phase is also a resource sample point
    (``resources.device_phase``): the compile-seconds delta across the
    span (attributed only when the window overlapped no other phase —
    the counter is process-global) and a device-bytes reading at its
    end merge into the current job's watermarks (``peak_hbm_bytes``)
    and — for ``fit.<family>.device`` names — the per-family table and
    the job profile's ``fit_resources``. Best-effort: a sampling failure
    degrades to an unprofiled span, never a failed fit.

    ``name`` additionally records a trace span (ambient context) with
    the exact same measured duration — the builder passes
    ``fit.<family>.device`` so a job's trace and its ``fit_device_s``
    profile figure agree to the digit. ``attrs`` go on that span.
    """
    import torch

    from learningorchestra_tpu_torch.utils import resources

    with resources.device_phase(name):
        # Timed INSIDE the sampling window so the measured duration
        # stays the pure launch-to-completion figure (the sampling reads
        # at window exit never inflate device_s).
        t0 = time.time()
        out = fn()
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dur = time.time() - t0
    if name is not None:
        tracing.record_span(name, dur, attrs=attrs)
    return out, dur


#: One profiler trace at a time per process; concurrent jobs that both
#: request tracing serialize on this lock instead of interleaving.
_trace_lock = threading.Lock()


@contextmanager
def device_trace(cfg: Settings):
    """``torch.profiler`` trace around a compute job when profile_dir is
    set: CPU operators and, where a card is present, its kernels. The
    Chrome trace lands in ``profile_dir`` as ``trace-<pid>-<ms>.json``.

    Wrap whole jobs (a full multi-classifier build, one predict call) —
    not per-thread work items — so a trace covers a meaningful span.
    """
    if not cfg.profile_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(cfg.profile_dir, exist_ok=True)
    with _trace_lock:
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            cfg.profile_dir,
            f"trace-{os.getpid()}-{int(time.time() * 1000)}.json"))
