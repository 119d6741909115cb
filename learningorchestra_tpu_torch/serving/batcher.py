"""Continuous micro-batching for the online predict tier.

The request-handler + batcher-worker split: HTTP handler threads are thin
enqueue/await shims — parse rows, enqueue, block on an event — and ONE
dispatcher thread per (model, replica) owns that replica's device
(``serve_replicas`` replicas per model; the default 1 is one
dispatcher per model on one card). A cost-based router picks the replica
with the lowest predicted queue wait per request. The dispatcher coalesces
whatever is waiting (up to ``serve_max_batch`` rows, lingering
``serve_max_wait_ms`` for stragglers when the batch isn't full) into one
padded dispatch of the warmed model (models/aot.py) and scatters the
probability rows back to the waiting requests. Per-request device
dispatch drowns in fixed overhead (a host→device copy, the model's
launches, a device→host copy); coalescing pays it once per *batch*.
The dispatcher thread launches on its current CUDA stream, the one the
kernel wrappers pass (``ops/_cuda_build.py``), so its work and a fit
running beside it are ordered, not racing.

Backpressure: each model's queue is bounded (``serve_queue_depth`` rows).
A request that would overflow it raises :class:`QueueFull`, which the
serving layer maps to 503 + Retry-After — the contract the client SDK's
jittered backoff already honors, so overload degrades into
client-side pacing instead of collapse.

Instrumentation feeds the ``serving`` section of ``/metrics`` and the
status page: per-model and aggregate request/row/batch counts, rejected
and failed counts, mean batch occupancy (rows per dispatch — the
batching win, directly), live queue depth, a log-bucketed end-to-end
latency histogram (p50/p99 are estimated from its buckets — exact over
the model's whole life, and the same series Prometheus scrapes; the old
rolling-sample percentiles forgot everything past 2048 requests), and
QPS over the last ~30 s.

Tracing: each traced request's trace context rides its queue entry, so
the dispatcher can attribute — per request — ``queue.wait`` (enqueue →
taken), and link one ``batch.coalesce`` span per coalesced dispatch as
the parent of every co-batched request's ``dispatch.device`` span:
queue wait, device time, and scatter tail finally separate per request
instead of blurring into one p99.

Fault domain:

- **End-to-end deadlines** — a request may carry a deadline budget
  (``X-Deadline-Ms`` → :meth:`PredictBatcher.predict`). Admission
  rejects up front when the predicted queue wait (queue depth × the
  recent per-row service rate, an EWMA the dispatcher maintains)
  already exceeds the remaining budget; the dispatcher discards
  requests that expired while queued BEFORE padding them into a batch
  (device time is never spent answering a caller that gave up); both
  map to a terminal 504 (:class:`DeadlineExceeded`), never a retryable
  503, and the expiry is recorded on the request's trace.
- **Dispatcher self-healing** — the per-model dispatcher thread runs
  under in-process supervision: an exception escaping the dispatch loop
  (a silent thread death) restarts the loop under exponential
  backoff, re-queuing in-flight requests the device never saw and
  failing already-dispatched ones 503 (:class:`DispatcherCrashed` — the
  client retries). ``serve_quarantine_crashes`` consecutive crashes
  quarantine the model (:class:`ModelQuarantined`, terminal 503 naming
  the quarantine, counted on ``/metrics``) instead of crash-looping;
  DELETE or re-save lifts it. (The JAX package also dumps a
  flight-recorder bundle here; the recorder is not ported.)
- **Chaos seams** — ``serving.batcher.pre_dispatch`` fires after a
  batch is taken but before any device work (raise-mode = a dispatcher
  crash whose batch is safely re-queued), ``serving.batcher.
  mid_dispatch`` after the device computed but before scatter
  (raise-mode = a crash whose batch must fail 503: re-dispatching would
  double-spend device time).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from learningorchestra_tpu_torch.config import Settings, settings as global_settings
from learningorchestra_tpu_torch.models.aot import AotCache, design_from_rows
from learningorchestra_tpu_torch.models.persistence import ModelRegistry
from learningorchestra_tpu_torch.utils import failpoints, profiling, tracing
from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("serving.batcher")

#: Chaos seams for the predict dispatch path (docs/fault_tolerance.md §7).
FP_PRE_DISPATCH = failpoints.declare("serving.batcher.pre_dispatch")
FP_MID_DISPATCH = failpoints.declare("serving.batcher.mid_dispatch")

#: EWMA weight of the newest per-row service-rate sample — a few batches
#: of history, so the queue-wait prediction tracks load shifts within
#: seconds without one outlier dispatch whipsawing admission.
_RATE_ALPHA = 0.3
#: Supervised dispatcher restarts back off exponentially up to this cap
#: (seconds) — also bounds how long stop() can wait behind a backoff.
_RESTART_BACKOFF_CAP_S = 5.0
#: Retry-After hints computed from predicted queue wait clamp into this
#: range (seconds): at least 1 (the header is integral and 0 means
#: hammer-now), at most 60 (a confused rate estimate must not park
#: clients for an hour).
_RETRY_AFTER_MIN_S, _RETRY_AFTER_MAX_S = 1.0, 60.0

#: Completion timestamps kept per model for the QPS window.
_QPS_SAMPLES = 2048
#: Seconds of request-completion history the QPS figure covers.
_QPS_WINDOW_S = 30.0


class QueueFull(Exception):
    """The model's predict queue is at capacity — answer 503 and tell the
    client when to come back."""

    def __init__(self, model: str, depth: int, retry_after_s: float = 1.0):
        super().__init__(
            f"predict queue full for model {model} ({depth} rows waiting); "
            "retry after backoff")
        self.retry_after_s = retry_after_s


class PredictTimeout(Exception):
    """A queued request outlived ``serve_timeout_s`` without a result."""


class BatcherStopped(Exception):
    """The model's dispatcher was torn down while this request raced it
    (DELETE of the model, or server shutdown). Transient from the
    client's view: mapped to 503 + Retry-After, and the retry gets the
    terminal answer — 404 if the model is gone, a fresh dispatcher if it
    was re-saved."""


class DeadlineExceeded(Exception):
    """The request's end-to-end deadline budget cannot be (or was not)
    met — terminal: mapped to **504**, which the client never retries
    (re-sending work whose caller already gave up only deepens the
    overload). ``phase`` says where the budget died: ``admission``
    (predicted queue wait exceeded the remaining budget up front — the
    rows never even queued) or ``queue`` (it expired waiting — the rows
    were discarded before any device dispatch)."""

    def __init__(self, model: str, budget_ms: float, waited_ms: float,
                 phase: str, predicted_wait_ms: Optional[float] = None):
        detail = (f"; predicted queue wait {predicted_wait_ms:.0f}ms"
                  if predicted_wait_ms is not None else "")
        super().__init__(
            f"deadline exceeded for model {model}: budget {budget_ms:.0f}ms"
            f", waited {waited_ms:.0f}ms at {phase}{detail}")
        self.model = model
        self.budget_ms = budget_ms
        self.waited_ms = waited_ms
        self.phase = phase


class DispatcherCrashed(Exception):
    """This request's batch was in flight when the dispatcher thread
    crashed AFTER device dispatch — its results are lost and re-running
    them would double-spend device time, so it fails here. Transient:
    mapped to 503 + Retry-After; the supervised restart is already
    bringing the dispatcher back for the retry."""


class ModelQuarantined(Exception):
    """The model's dispatcher crashed ``serve_quarantine_crashes``
    consecutive times and the model is quarantined: predicts answer this
    terminal 503 naming the quarantine instead of feeding a crash loop.
    DELETE or re-save (anything that invalidates the batcher) lifts it."""


class _Pending:
    """One enqueued request: its design rows, the AOT entry its design
    was built against, the submitting request's trace context (so the
    dispatcher thread can record spans INTO that request's trace), its
    optional deadline, and the slot the dispatcher scatters the result
    (or error) into. ``dispatched`` flips just before the device runs
    its batch — the supervision's re-queue-or-fail decision on a crash."""

    __slots__ = ("X", "entry", "ctx", "done", "probs", "error",
                 "t_enqueue", "t_taken", "deadline", "budget_ms",
                 "dispatched")

    def __init__(self, X: np.ndarray, entry: Any,
                 deadline: Optional[float] = None,
                 budget_ms: Optional[float] = None):
        self.X = X
        self.entry = entry
        self.ctx = tracing.current()
        self.done = threading.Event()
        self.probs: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.t_enqueue = time.monotonic()
        self.t_taken: Optional[float] = None
        #: Absolute monotonic instant the caller's budget runs out, or
        #: None for no deadline.
        self.deadline = deadline
        self.budget_ms = budget_ms
        self.dispatched = False


class _Stats:
    """Lock-protected counters + latency histogram for one model.

    Latency lives in log-bucketed histograms (the shared
    ``profiling.BUCKETS_S`` ladder): a LIFETIME histogram — the exact
    cumulative series Prometheus scrapes (scrapers window it themselves
    with ``rate()``) — plus a two-epoch rotating window (epochs of
    ``_QPS_WINDOW_S``) that the JSON view's ``p50_ms``/``p99_ms``
    estimate from, so a latency regression on a long-lived server moves
    the operator-facing percentiles within seconds instead of drowning
    in millions of historical observations. QPS keeps a timestamp ring
    (a rate needs exact recency)."""

    def __init__(self):
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.batched_rows = 0
        self.rejected = 0
        self.timeouts = 0
        self.errors = 0
        self.deadline_exceeded = 0
        self.dispatcher_restarts = 0
        self.quarantined = 0
        #: EWMA of device seconds per row over recent dispatches — the
        #: service rate behind predicted queue wait (deadline admission
        #: and computed Retry-After hints). 0.0 until the first dispatch
        #: (a cold model admits everything: no evidence, no rejection).
        self.service_s_per_row = 0.0
        self.lat_buckets = profiling.new_histogram()
        self.lat_sum_s = 0.0
        #: Two-epoch rotating window for recency-sensitive percentiles:
        #: p50/p99 read prev+current, covering the last 1-2 epochs.
        self._lat_recent = profiling.new_histogram()
        self._lat_prev = profiling.new_histogram()
        self._rotated_at = time.monotonic()
        #: Completion monotonic timestamps ring (QPS only).
        self.completions: collections.deque = collections.deque(
            maxlen=_QPS_SAMPLES)

    def _maybe_rotate(self, now: float) -> None:
        gap = now - self._rotated_at
        if gap > 2 * _QPS_WINDOW_S:
            # Idle longer than both epochs: everything in the window is
            # stale — clear it rather than promoting a minutes-old epoch
            # into "recent" (percentiles then fall back to the lifetime
            # shape until fresh traffic refills the window).
            self._lat_prev = profiling.new_histogram()
            self._lat_recent = profiling.new_histogram()
            self._rotated_at = now
        elif gap > _QPS_WINDOW_S:
            self._lat_prev = self._lat_recent
            self._lat_recent = profiling.new_histogram()
            self._rotated_at = now

    def observe(self, latency_s: float) -> None:
        """Record one completed request's latency (caller holds the
        stats lock)."""
        now = time.monotonic()
        self._maybe_rotate(now)
        profiling.observe(self.lat_buckets, latency_s)
        profiling.observe(self._lat_recent, latency_s)
        self.lat_sum_s += latency_s
        self.completions.append(now)

    def observe_dispatch(self, rows: int, device_s: float) -> None:
        """Fold one dispatch's per-row device time into the service-rate
        EWMA (caller holds the stats lock)."""
        if rows <= 0:
            return
        sample = max(0.0, device_s) / rows
        self.service_s_per_row = (
            sample if self.service_s_per_row <= 0.0
            else (1 - _RATE_ALPHA) * self.service_s_per_row
            + _RATE_ALPHA * sample)

    def predicted_wait_s(self, queue_rows: int) -> float:
        """Expected seconds until ``queue_rows`` currently-queued rows
        have been served — depth × the recent per-row service rate. 0.0
        before any dispatch established a rate."""
        return max(0, queue_rows) * self.service_s_per_row

    def snapshot(self, queue_rows: int) -> Dict[str, Any]:
        now = time.monotonic()
        self._maybe_rotate(now)
        recent = [t for t in self.completions if now - t <= _QPS_WINDOW_S]
        # Divide by the full window once it has rolled over; before that
        # (young server) by the observed span, floored so one lone
        # sample can't read as thousands of QPS.
        span = (_QPS_WINDOW_S if len(recent) < len(self.completions)
                else max(now - recent[0], 1.0) if recent else None)
        qps = (len(recent) / span) if recent and span else 0.0
        # Recent-window percentiles (prev + current epoch); an idle
        # model falls back to its lifetime shape rather than reading
        # None the moment traffic pauses.
        window = [a + b for a, b in zip(self._lat_prev, self._lat_recent)]
        source = window if sum(window) else self.lat_buckets

        def pct(q: float) -> Optional[float]:
            est = profiling.quantile_from_buckets(source, q)
            return None if est is None else round(est * 1e3, 3)

        return {
            "requests": self.requests,
            "rows": self.rows,
            "batches": self.batches,
            # Rows the DEVICE actually saw — the deadline tests pin that
            # expired rows never count here.
            "batched_rows": self.batched_rows,
            "mean_batch_rows": (round(self.batched_rows / self.batches, 3)
                                if self.batches else 0.0),
            "rejected": self.rejected,
            "timeouts": self.timeouts,
            "errors": self.errors,
            "deadline_exceeded": self.deadline_exceeded,
            "dispatcher_restarts": self.dispatcher_restarts,
            "quarantined": self.quarantined,
            "service_us_per_row": round(self.service_s_per_row * 1e6, 3),
            "queue_rows": queue_rows,
            "qps": round(qps, 3),
            "p50_ms": pct(0.50),
            "p99_ms": pct(0.99),
            "latency": {"buckets": list(self.lat_buckets),
                        "sum_s": round(self.lat_sum_s, 6)},
        }


class ModelBatcher:
    """The per-(model, replica) queue + the dispatcher thread that owns
    that replica's device. With ``serve_replicas`` = 1 (the default)
    there is exactly one of these per model — the pre-replication tier,
    byte-for-byte. ``stats`` is the REPLICA's own counter block: the
    service-rate EWMA behind admission control and routing is
    per-replica, so one slow device only slows its own queue's
    predictions."""

    def __init__(self, name: str, cfg: Settings, stats: _Stats,
                 replica: int = 0):
        self.name = name
        self.cfg = cfg
        self.stats = stats
        #: Which AOT replica (device index) this dispatcher dispatches
        #: to; 0 is the single-device topology.
        self.replica = int(replica)
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._queue_rows = 0
        self._stopped = False
        #: Set by stop(): interrupts a supervised-restart backoff sleep.
        self._stopping = threading.Event()
        #: Consecutive dispatcher crashes (reset by a clean batch);
        #: reaching serve_quarantine_crashes quarantines the model.
        self._crashes = 0
        #: Quarantine reason once terminal, else None.
        self._quarantined: Optional[str] = None
        #: The batch the dispatcher currently holds outside the queue —
        #: what supervision re-queues or fails after a crash. Touched
        #: only by the dispatcher thread (and by supervision after that
        #: same thread's loop died), so it needs no lock.
        self._inflight: List[_Pending] = []
        # thread-lifecycle: owner=ModelBatcher; exits when stop() sets
        # _stopped under the cond (joined there, bounded timeout) or on
        # quarantine. _run supervises _loop: an exception escaping the
        # dispatch loop (a silent thread death) restarts it under
        # exponential backoff instead of dying silently; per-request
        # model errors are scattered by _loop's per-group try/except and
        # never reach supervision.
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=(f"lo-predict-{name}" if self.replica == 0
                  else f"lo-predict-{name}-r{self.replica}"))
        self._thread.start()

    # -- handler side --------------------------------------------------------

    def quarantined(self) -> Optional[str]:
        with self._cond:
            return self._quarantined

    def submit(self, X: np.ndarray, entry: Any,
               deadline: Optional[float] = None,
               budget_ms: Optional[float] = None) -> np.ndarray:
        """Enqueue one request's rows and block until its batch lands.
        ``entry`` is the AOT entry ``X`` was designed against — the
        dispatcher evaluates through it, never through a fresher one
        (a hot-swap between preprocessing and dispatch must not run
        old-state rows through new params). ``deadline`` is the absolute
        monotonic instant the caller's budget expires (None = none).
        Raises QueueFull at capacity (→ 503 upstream), DeadlineExceeded
        (→ terminal 504) when the budget is already unmeetable or runs
        out in queue, and re-raises any dispatch-side error on the
        submitting thread."""
        n = len(X)
        with self._cond:
            if self._quarantined:
                raise ModelQuarantined(self._quarantined)
            if self._stopped:
                raise BatcherStopped(
                    f"predict dispatcher for model {self.name} stopped")
            queue_rows = self._queue_rows
            if deadline is not None:
                # Admission control: if the rows already waiting are
                # predicted to outlast the remaining budget, spending a
                # queue slot (and later device time) on this request
                # only manufactures a guaranteed-dead answer.
                with _stats_lock:
                    wait_s = self.stats.predicted_wait_s(queue_rows)
                remaining = deadline - time.monotonic()
                if wait_s > remaining:
                    with _stats_lock:
                        self.stats.deadline_exceeded += 1
                    exc = DeadlineExceeded(
                        self.name, budget_ms or 0.0,
                        max(0.0, (budget_ms or 0.0) - remaining * 1e3),
                        "admission", predicted_wait_ms=wait_s * 1e3)
                    tracing.record_span(
                        "deadline.rejected", 0.0,
                        attrs={"model": self.name, "rows": n,
                               "budget_ms": budget_ms,
                               "predicted_wait_ms": round(wait_s * 1e3, 3)},
                        status="error", error=str(exc))
                    raise exc
            depth = int(self.cfg.serve_queue_depth)
            if queue_rows + n > depth:
                with _stats_lock:
                    self.stats.rejected += 1
                    # Computed backpressure hint: how long the queue is
                    # predicted to take to drain, clamped — not the old
                    # hard-coded constant.
                    retry_after = min(
                        _RETRY_AFTER_MAX_S,
                        max(_RETRY_AFTER_MIN_S,
                            self.stats.predicted_wait_s(queue_rows)))
                raise QueueFull(self.name, queue_rows,
                                retry_after_s=retry_after)
            pending = _Pending(X, entry, deadline=deadline,
                               budget_ms=budget_ms)
            self._queue.append(pending)
            self._queue_rows += n
            self._cond.notify_all()
        wait_s = float(self.cfg.serve_timeout_s)
        if deadline is not None:
            wait_s = min(wait_s, max(0.0, deadline - time.monotonic()))
        if not pending.done.wait(wait_s):
            # Withdraw the dead request: if it is still queued, the
            # device must not burn a dispatch computing rows nobody
            # will read (the 503'd client is already re-sending them).
            # Already-taken requests compute wastefully once — bounded.
            withdrew = True
            with self._cond:
                try:
                    self._queue.remove(pending)
                    self._queue_rows -= n
                except ValueError:
                    withdrew = False        # dispatcher already took it
            waited_ms = (time.monotonic() - pending.t_enqueue) * 1e3
            if deadline is not None and time.monotonic() >= deadline:
                # Count only when WE removed it: a pending the
                # dispatcher already took is either discarded by
                # _discard_expired (which counts it there) or computed
                # as bounded waste — counting here too would double the
                # rate alert's numerator for one expiry.
                exc = DeadlineExceeded(self.name, budget_ms or 0.0,
                                       waited_ms, "queue")
                if withdrew:
                    with _stats_lock:
                        self.stats.deadline_exceeded += 1
                    tracing.record_span(
                        "deadline.expired", waited_ms / 1e3,
                        attrs={"model": self.name, "rows": n,
                               "budget_ms": budget_ms},
                        status="error", error=str(exc))
                raise exc
            with _stats_lock:
                self.stats.timeouts += 1
            raise PredictTimeout(
                f"predict timed out after {self.cfg.serve_timeout_s}s "
                f"queued on model {self.name}")
        if pending.error is not None:
            raise pending.error
        lat = time.monotonic() - pending.t_enqueue
        with _stats_lock:
            self.stats.requests += 1
            self.stats.rows += n
            self.stats.observe(lat)
        return pending.probs

    def queue_rows(self) -> int:
        with self._cond:
            return self._queue_rows

    def thread_alive(self) -> bool:
        """Liveness probe for the health rollup: True while the
        dispatcher thread runs OR it exited deliberately (stop or
        quarantine — both answer requests with a mapped status) — only a
        dead-but-not-stopped thread (a silent thread death, the class the
        thread sanitizer hunts) reads as unhealthy."""
        with self._cond:
            if self._stopped or self._quarantined:
                return True
        return self._thread.is_alive()

    def outstanding(self) -> int:
        """Requests this batcher still owes an answer: queued plus taken
        but not yet scattered — the drain loop's quiesce probe."""
        with self._cond:
            queued = len(self._queue)
        return queued + sum(1 for p in self._inflight
                            if not p.done.is_set())

    # -- worker side ---------------------------------------------------------

    def _take_batch(self) -> Tuple[List[_Pending], List[_Pending]]:
        """Pop up to ``serve_max_batch`` rows' worth of waiting requests,
        lingering up to ``serve_max_wait_ms`` for a fuller batch. Whole
        requests only — a single request never splits across dispatches,
        so scatter-back is a simple offset walk. Requests whose deadline
        already passed are DISCARDED here instead of batched — padding a
        dead caller's rows into a dispatch spends device time answering
        nobody — and returned separately for 504 scatter + accounting
        (outside the cond)."""
        max_rows = max(1, int(self.cfg.serve_max_batch))
        expired: List[_Pending] = []
        with self._cond:
            # Plain wait: submit() and stop() both notify under the
            # cond, so an idle dispatcher sleeps silently instead of
            # polling.
            while not self._queue and not self._stopped:
                self._cond.wait()
            if self._stopped and not self._queue:
                return [], []
            deadline = (time.monotonic()
                        + float(self.cfg.serve_max_wait_ms) / 1e3)
            # _queue_rows is maintained by submit/_take_batch/timeout
            # withdrawal under this cond — O(1) vs re-walking the deque
            # on every linger wakeup.
            while self._queue_rows < max_rows and not self._stopped:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch: List[_Pending] = []
            rows = 0
            now = time.monotonic()
            while self._queue and rows + len(self._queue[0].X) <= max_rows:
                p = self._queue.popleft()
                if p.deadline is not None and now >= p.deadline:
                    self._queue_rows -= len(p.X)
                    expired.append(p)
                    continue
                rows += len(p.X)
                batch.append(p)
            if not batch and self._queue:
                # Head request alone exceeds max_batch (only possible if
                # someone shrank serve_max_batch at runtime): dispatch it
                # solo; aot.predict chunks it across max-bucket calls.
                # Same expiry rule as the normal pop — an oversized
                # request is not a license to dispatch a dead caller.
                p = self._queue.popleft()
                if p.deadline is not None and now >= p.deadline:
                    self._queue_rows -= len(p.X)
                    expired.append(p)
                else:
                    batch.append(p)
                    rows = len(p.X)
            self._queue_rows -= rows
            t_taken = time.monotonic()
            for p in batch:
                p.t_taken = t_taken
            self._inflight = batch
            return batch, expired

    def _discard_expired(self, expired: List[_Pending]) -> None:
        """504 the requests whose deadline passed while queued: error
        scatter + counter + a trace record of the expiry — the device
        never saw their rows (the acceptance invariant the deadline
        chaos test pins via the dispatch counters)."""
        with _stats_lock:
            self.stats.deadline_exceeded += len(expired)
        for p in expired:
            waited_s = time.monotonic() - p.t_enqueue
            exc = DeadlineExceeded(self.name, p.budget_ms or 0.0,
                                   waited_s * 1e3, "queue")
            if p.ctx is not None and p.ctx.sampled:
                tracing.record_span(
                    "deadline.expired", waited_s, ctx=p.ctx,
                    attrs={"model": self.name, "rows": len(p.X),
                           "budget_ms": p.budget_ms},
                    status="error", error=str(exc))
            p.error = exc
            p.done.set()

    def _loop(self) -> None:
        while True:
            batch, expired = self._take_batch()
            if expired:
                self._discard_expired(expired)
            if not batch:
                # Empty means stopped-and-drained OR a timeout
                # withdrawal emptied the queue during the linger wait —
                # only the former ends the thread (a dead dispatcher
                # with _stopped False would black-hole the model).
                if self._stopped:
                    return
                continue
            # Per-request queue-wait attribution: enqueue → taken by the
            # dispatcher, recorded into EACH request's own trace (the
            # p99 blur the rolling-sample window could never decompose).
            for p in batch:
                if p.ctx is not None and p.ctx.sampled:
                    tracing.record_span(
                        "queue.wait", (p.t_taken or p.t_enqueue)
                        - p.t_enqueue, ctx=p.ctx,
                        attrs={"model": self.name, "rows": len(p.X)})
            # Group by the entry captured at enqueue: requests that
            # straddle a hot-swap evaluate through the version their
            # design matrix was built for (mixing would run old-state
            # rows through new params — silently wrong numbers, or a
            # width mismatch erroring innocent co-batched requests).
            # One dispatch per group; mixed-version batches only occur
            # in the swap instant itself.
            groups: Dict[int, List[_Pending]] = {}
            for p in batch:
                groups.setdefault(id(p.entry), []).append(p)
            for grp in groups.values():
                # Outside the per-group try on purpose: a raise here is
                # a dispatcher CRASH (supervised restart re-queues the
                # group — the device saw nothing), not a per-request
                # model error to scatter.
                failpoints.fire(FP_PRE_DISPATCH)
                entry = grp[0].entry
                for p in grp:
                    p.dispatched = True
                try:
                    t0 = time.monotonic()
                    X = (grp[0].X if len(grp) == 1
                         else np.concatenate([p.X for p in grp], axis=0))
                    # Replica 0 calls the bare form so tests/stub
                    # entries that monkeypatch a one-arg predict keep
                    # working; other replicas pass their device index
                    # through to the per-replica ladder.
                    probs = (entry.predict(X) if self.replica == 0
                             else entry.predict(X, self.replica))
                    t_device = time.monotonic() - t0
                except Exception as exc:  # noqa: BLE001 — scattered per req
                    with _stats_lock:
                        self.stats.errors += len(grp)
                    for p in grp:
                        p.error = exc
                        p.done.set()
                    continue
                # A raise here crashes the dispatcher AFTER the device
                # computed: supervision fails the group 503 (re-running
                # it would double-spend device time) — the asymmetry the
                # pre/mid chaos pair exists to prove.
                failpoints.fire(FP_MID_DISPATCH)
                try:
                    self._scatter(grp, probs, t0, t_device)
                finally:
                    for p in grp:
                        p.done.set()
            self._inflight = []
            # A clean batch ends any crash streak — quarantine is for
            # models that cannot dispatch at all, not ones that crashed
            # transiently N times over a whole process lifetime.
            self._crashes = 0

    def _scatter(self, grp: List[_Pending], probs: np.ndarray,
                 t0: float, t_device: float) -> None:
        """Scatter one dispatched group's results (or a scatter-side
        error) back to its requests. Its own except keeps the old
        contract: ANY failure after the device ran still hands every
        request a typed error — completing a request with neither probs
        nor error would surface as an opaque 500 downstream."""
        try:
            off = 0
            for p in grp:
                p.probs = probs[off:off + len(p.X)]
                off += len(p.X)
            with _stats_lock:
                self.stats.batches += 1
                self.stats.batched_rows += off
                self.stats.observe_dispatch(off, t_device)
            # One batch.coalesce span per coalesced dispatch
            # (recorded into the first traced request's trace),
            # linked as PARENT of every co-batched request's
            # dispatch.device span: the trace shows N requests
            # sharing one device program, and scatter time is
            # the coalesce−device gap.
            coalesce = time.monotonic() - t0
            bsid = None
            for p in grp:
                if p.ctx is not None and p.ctx.sampled:
                    bsid = tracing.record_span(
                        "batch.coalesce", coalesce, ctx=p.ctx,
                        attrs={"model": self.name,
                               "requests": len(grp), "rows": off})
                    break
            for p in grp:
                if p.ctx is not None and p.ctx.sampled:
                    tracing.record_span(
                        "dispatch.device", t_device, ctx=p.ctx,
                        parent_id=bsid,
                        attrs={"model": self.name,
                               "co_batched": len(grp),
                               "batch_rows": off})
        except Exception as exc:  # noqa: BLE001 — scattered per req
            with _stats_lock:
                self.stats.errors += len(grp)
            for p in grp:
                p.error = exc

    # -- supervision ---------------------------------------------------------

    def _run(self) -> None:
        """The dispatcher thread body: `_loop` under supervision. A
        crash (exception escaping the loop — the class that used to
        black-hole the model until process restart) restarts the loop
        under exponential backoff; `serve_quarantine_crashes`
        consecutive crashes quarantine the model instead."""
        while True:
            try:
                self._loop()
                return                      # stopped and drained
            except Exception as exc:  # noqa: BLE001 — supervised boundary
                if not self._survive_crash(exc):
                    return

    def _survive_crash(self, exc: Exception) -> bool:
        """Handle one dispatcher crash; True = restart the loop."""
        log.error("dispatcher for model %s crashed: %s: %s",
                  self.name, type(exc).__name__, exc, exc_info=exc)
        inflight = [p for p in self._inflight if not p.done.is_set()]
        self._inflight = []
        requeue = [p for p in inflight if not p.dispatched]
        lost = [p for p in inflight if p.dispatched]
        self._crashes += 1
        with _stats_lock:
            self.stats.dispatcher_restarts += 1
        threshold = max(1, int(self.cfg.serve_quarantine_crashes))
        if self._crashes >= threshold:
            with self._cond:
                self._quarantined = (
                    f"model {self.name} quarantined after {self._crashes} "
                    f"consecutive dispatcher crashes "
                    f"(last: {type(exc).__name__}: {exc}); DELETE or "
                    "re-save the model to lift the quarantine")
                leftovers = list(self._queue)
                self._queue.clear()
                self._queue_rows = 0
            with _stats_lock:
                self.stats.quarantined = 1
            log.error("%s", self._quarantined)
            qerr = ModelQuarantined(self._quarantined)
            for p in requeue + lost + leftovers:
                p.error = qerr
                p.done.set()
            return False
        # Already-dispatched requests lost their results with the crash;
        # re-running them would double-spend device time — fail them 503
        # (the client's backoff retries against the restarted loop).
        cerr = DispatcherCrashed(
            f"predict dispatcher for model {self.name} crashed mid-batch "
            f"({type(exc).__name__}: {exc}); dispatcher restarting — retry")
        for p in lost:
            p.error = cerr
            p.done.set()
        with self._cond:
            if self._stopped:
                # stop() raced the crash: it is joining this thread and
                # will fail whatever remains queued; don't re-queue onto
                # a dispatcher that is never coming back.
                for p in requeue:
                    p.error = BatcherStopped(
                        f"predict dispatcher for model {self.name} stopped")
                    p.done.set()
                return False
            # The device never saw these rows: put them back at the
            # FRONT in their original order so the restarted loop serves
            # them first — a stock client completes without even a
            # retry.
            for p in reversed(requeue):
                self._queue.appendleft(p)
                self._queue_rows += len(p.X)
        backoff = min(_RESTART_BACKOFF_CAP_S,
                      float(self.cfg.serve_restart_backoff_s)
                      * (2 ** (self._crashes - 1)))
        log.warning("restarting dispatcher for model %s in %.2fs "
                    "(crash %d/%d before quarantine)",
                    self.name, backoff, self._crashes, threshold)
        if self._stopping.wait(backoff):
            return False                   # stop() interrupted the backoff
        return True

    def stop(self) -> None:
        self._stopping.set()
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=_RESTART_BACKOFF_CAP_S + 5.0)
        # Fail anything still queued so no handler thread waits out its
        # full timeout against a dead worker.
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
            self._queue_rows = 0
        for p in leftovers:
            p.error = BatcherStopped(
                f"predict dispatcher for model {self.name} stopped")
            p.done.set()


#: One lock for all stats mutation — counters are tiny and contention is
#: request-rate, not row-rate.
_stats_lock = threading.Lock()


class PredictBatcher:
    """The serving facade: per-model replica sets created lazily, shared
    AOT cache, aggregate metrics. Held by the App; handlers call
    :meth:`predict` and everything else is internal.

    With ``serve_replicas`` > 1 each model gets one :class:`ModelBatcher`
    (queue + dispatcher thread + stats block) PER replica, and
    :meth:`predict_probs` routes each request to the replica with the
    lowest predicted queue wait (queue depth × that replica's own
    service-rate EWMA, ties broken by raw depth then replica index —
    deterministic, and concentrating idle traffic on replica 0 keeps the
    single-replica path exercised). Quarantine is per-replica: a crashed
    replica degrades capacity while its siblings keep answering, and the
    model-level quarantine (terminal 503) only applies when EVERY
    replica is quarantined."""

    def __init__(self, registry: ModelRegistry,
                 cfg: Optional[Settings] = None, device: str = "cuda"):
        self.cfg = cfg or global_settings
        self.aot = AotCache(registry, self.cfg, device=device)
        #: Replica count resolved once by the AOT cache — the dispatcher
        #: sets here are sized to the same topology the ladders compile
        #: for.
        self.replicas = self.aot.replicas
        self._lock = threading.Lock()
        self._batchers: Dict[str, List[ModelBatcher]] = {}
        self._stats: Dict[str, List[_Stats]] = {}
        self._stopped = False
        #: Requests currently inside :meth:`predict` — including the
        #: handler phase (design build, first-touch compile) BEFORE the
        #: rows reach any queue. The drain quiesce probe must count
        #: these too: stopping the dispatchers while an accepted request
        #: is still preprocessing would 503 it mid-drain.
        self._active = 0

    def _replica_set(self, name: str) -> List[ModelBatcher]:
        """The model's full dispatcher set, created lazily (all replicas
        at once — a model is either replicated or not, never half)."""
        with self._lock:
            if self._stopped:
                # A handler racing Server.stop() must not resurrect a
                # dispatcher thread nothing will ever stop again.
                raise BatcherStopped(
                    f"predict tier stopped; model {name} not served")
            bs = self._batchers.get(name)
            if bs is None:
                # Re-validate before spawning dispatchers: a request
                # racing DELETE can reach here after invalidate()
                # already tore the batchers down — without this check it
                # would resurrect dispatcher threads for a model that
                # can never serve again.
                self.aot.registry.version(name)   # ModelNotFound → 404
                stats = self._stats.setdefault(
                    name, [_Stats() for _ in range(self.replicas)])
                with _stats_lock:
                    # Fresh dispatchers (post-DELETE/re-save) lift any
                    # previous quarantine; the counter history survives.
                    for st in stats:
                        st.quarantined = 0
                bs = [ModelBatcher(name, self.cfg, stats[i], replica=i)
                      for i in range(self.replicas)]
                self._batchers[name] = bs
            return bs

    def _batcher(self, name: str) -> ModelBatcher:
        """The replica this request dispatches to: the cost-based
        router. Cost = predicted queue wait (depth × that replica's own
        service-rate EWMA), ties broken by raw queue depth, then replica
        index. Quarantined replicas are excluded; only when EVERY
        replica is quarantined does the model answer the terminal
        quarantine 503."""
        bs = self._replica_set(name)
        if len(bs) == 1:
            b = bs[0]
            reason = b.quarantined()
            if reason:
                raise ModelQuarantined(reason)
            return b
        live = [b for b in bs if b.quarantined() is None]
        if not live:
            raise ModelQuarantined(bs[0].quarantined())
        depths = [(b, b.queue_rows()) for b in live]
        with _stats_lock:
            scored = [(b.stats.predicted_wait_s(q), q, b.replica, b)
                      for b, q in depths]
        return min(scored)[3]

    def predict(self, name: str, rows: Sequence[Any],
                deadline_ms: Optional[float] = None) -> Dict[str, Any]:
        """The whole handler shim: rows → design matrix (host-side, on
        the handler thread so feature prep overlaps other models'
        device work) → enqueue/await → JSON-able result.

        ``deadline_ms`` is the caller's remaining end-to-end budget; the
        clock starts HERE (so design-build time counts against it), and
        expiry anywhere downstream raises :class:`DeadlineExceeded`
        (→ terminal 504)."""
        kind, probs = self.predict_probs(name, rows, deadline_ms)
        # .tolist() (C-speed) — this runs per request on the hot path.
        return {
            "model": name,
            "kind": kind,
            "predictions": np.argmax(probs, axis=1).tolist(),
            # tolist() on float32 already widens to exact Python floats
            # — an astype(float64) first would copy for identical JSON.
            "probabilities": probs.tolist(),
        }

    def predict_probs(self, name: str, rows: Sequence[Any],
                      deadline_ms: Optional[float] = None
                      ) -> Tuple[str, np.ndarray]:
        """The raw form of :meth:`predict`: ``(model kind, float32
        probability matrix)`` with NO response formatting — what the
        multi-worker front end's row channel calls, so the JSON encode
        of a forwarded request happens in the worker process (off this
        process's GIL) while the numbers stay bit-identical (the worker
        runs the same argmax/tolist on the same float32 bytes).
        Accounting, deadlines, backpressure and drain quiescing are
        identical by construction: :meth:`predict` is this plus
        formatting."""
        with self._lock:
            self._active += 1
        try:
            entry, probs = self._predict(name, rows, deadline_ms)
            return entry.kind, probs
        finally:
            with self._lock:
                self._active -= 1

    def predict_with_epoch(self, name: str, rows: Sequence[Any],
                           deadline_ms: Optional[float] = None
                           ) -> Tuple[str, np.ndarray, int]:
        """:meth:`predict_probs` plus the swap epoch of the AOT entry
        the rows evaluated through — the hot-swap consistency probe: the
        epoch is stamped once per (name, version) cache insert under the
        cache lock, so two responses with the same epoch are guaranteed
        to have been served by the SAME model version on every replica
        (no mixed-version pair can share an epoch). Accounting is
        identical to :meth:`predict_probs` by construction."""
        with self._lock:
            self._active += 1
        try:
            entry, probs = self._predict(name, rows, deadline_ms)
            return entry.kind, probs, entry.swap_epoch
        finally:
            with self._lock:
                self._active -= 1

    def _predict(self, name: str, rows: Sequence[Any],
                 deadline_ms: Optional[float]) -> Tuple[Any, np.ndarray]:
        deadline = budget_ms = None
        if deadline_ms is not None:
            if deadline_ms <= 0:
                # The budget arrived already spent: terminal 504 —
                # counted and traced like any other miss, so a client
                # burning 100% of its requests this way still moves
                # lo_serving_deadline_exceeded_total and the rate alert.
                self.aot.registry.version(name)   # unknown model → 404
                with self._lock:
                    stats = self._stats.setdefault(
                        name, [_Stats() for _ in range(self.replicas)])
                with _stats_lock:
                    # Never routed, so it charges replica 0 — the
                    # aggregate (what the rate alert reads) is the sum.
                    stats[0].deadline_exceeded += 1
                exc = DeadlineExceeded(name, float(deadline_ms), 0.0,
                                       "admission")
                tracing.record_span(
                    "deadline.rejected", 0.0,
                    attrs={"model": name,
                           "budget_ms": float(deadline_ms)},
                    status="error", error=str(exc))
                raise exc
            budget_ms = float(deadline_ms)
            deadline = time.monotonic() + budget_ms / 1e3
        if int(self.cfg.serve_queue_depth) <= 0:
            # Existence check BEFORE creating a stats slot: _stats
            # entries are permanent (invalidate() keeps them for
            # /metrics continuity), so minting one per client-supplied
            # name would let a scanner grow this dict — and /metrics —
            # without bound. Unknown models 404 here like everywhere
            # else; real ones count the rejection below.
            self.aot.registry.version(name)   # ModelNotFound → 404
            # Count the rejection: a tier bouncing 100% of traffic must
            # show it on /metrics, not read as zero rejections.
            with self._lock:
                stats = self._stats.setdefault(
                    name, [_Stats() for _ in range(self.replicas)])
            with _stats_lock:
                stats[0].rejected += 1
            raise QueueFull(name, 0)
        # Quarantine check BEFORE any per-request work: a fully
        # quarantined model's terminal 503 should cost a dict lookup,
        # not a design build (the _batcher() re-check still guards the
        # race). Partially quarantined sets fall through — the router
        # only considers live replicas.
        with self._lock:
            bs = self._batchers.get(name)
        if bs is not None:
            reasons = [b.quarantined() for b in bs]
            if all(reasons):
                raise ModelQuarantined(reasons[0])
        # Load/compile (and 404/406) BEFORE enqueueing: a bad model name
        # must not cost a queue slot, and first-touch compile happens on
        # the handler thread instead of stalling the dispatch loop.
        entry = self.aot.entry(name)
        # Shape-check the body before len()/preprocessing: {"rows":
        # null} or a scalar must 406 like every other malformed input,
        # not 500 on a TypeError. An ndarray means a binary columnar
        # body already decoded (serving/rowchannel.py) — design rows
        # with zero per-row parse left to do.
        if not isinstance(rows, (list, tuple, np.ndarray)):
            raise ValueError(
                "rows must be a non-empty JSON array of feature rows")
        # Cap check BEFORE preprocessing: the client's cap-discovery
        # probe deliberately oversends and expects a cheap 406 — don't
        # vocab-encode/fillna 256 rows just to throw them away. The cap
        # folds in serve_queue_depth: a request bigger than the whole
        # queue can NEVER be accepted, so it must get this terminal 406
        # (whose cap the client re-splits to) rather than burn its
        # retry budget on guaranteed QueueFull 503s.
        cap = min(int(self.cfg.serve_max_batch),
                  int(self.cfg.serve_queue_depth))
        if len(rows) > cap:
            raise ValueError(
                f"request carries {len(rows)} rows; per-request cap is "
                f"serve_max_batch={cap} — split client-side "
                "(Model.predict_online does)")
        t0 = time.monotonic()
        X = design_from_rows(rows, entry.preprocess)
        # Host-side feature prep on the handler thread, attributed per
        # request — the queue.wait / dispatch.device spans downstream
        # come from the dispatcher (ModelBatcher._loop).
        tracing.record_span("design.build", time.monotonic() - t0,
                            attrs={"model": name, "rows": len(rows)})
        probs = self._batcher(name).submit(X, entry, deadline=deadline,
                                           budget_ms=budget_ms)
        return entry, probs

    def invalidate(self, name: Optional[str] = None) -> None:
        """Drop compiled programs (and the dispatcher thread) for a
        deleted/re-saved model; stats survive so /metrics history does
        not reset — except the quarantined LEVEL, which this call is
        the documented lift for: a DELETEd model never creates another
        batcher, so clearing it only on batcher re-creation would pin
        the gauge (and the serving_quarantined alert) at 1 forever."""
        self.aot.invalidate(name)
        with self._lock:
            if name is None:
                doomed = [b for bs in self._batchers.values() for b in bs]
                self._batchers.clear()
                cleared = [st for sts in self._stats.values() for st in sts]
            else:
                bs = self._batchers.pop(name, None)
                doomed = list(bs) if bs is not None else []
                sts = self._stats.get(name)
                cleared = list(sts) if sts is not None else []
        for b in doomed:
            b.stop()
        with _stats_lock:
            for st in cleared:
                st.quarantined = 0

    def health(self) -> Dict[str, Any]:
        """Dispatcher-thread liveness for ``GET /healthz``: a model whose
        dispatcher thread died without being stopped would black-hole
        its requests — the silent failure mode the deep health rollup
        exists to surface. Quarantined models are listed (they answer a
        mapped terminal 503, so they don't flip ``ok`` — the
        ``serving_quarantined`` alert carries the paging signal)."""
        with self._lock:
            batchers = dict(self._batchers)
        dead = sorted(n for n, bs in batchers.items()
                      if any(not b.thread_alive() for b in bs))
        # A model is "quarantined" (terminal 503) only when EVERY
        # replica is; partially quarantined models keep serving and are
        # named per replica below — capacity degraded, not availability.
        quarantined = sorted(n for n, bs in batchers.items()
                             if all(b.quarantined() for b in bs))
        quarantined_replicas = {
            n: [b.replica for b in bs if b.quarantined()]
            for n, bs in sorted(batchers.items())
            if any(b.quarantined() for b in bs)}
        return {"ok": not dead,
                "dispatchers": sum(len(bs) for bs in batchers.values()),
                "replicas": self.replicas,
                "dead": dead, "quarantined": quarantined,
                "quarantined_replicas": quarantined_replicas}

    def quiesced(self) -> bool:
        """True when no request is anywhere inside the tier — neither
        in :meth:`predict`'s handler phase (design build / first-touch
        compile, before any queue) nor queued/in-flight on a dispatcher
        — the drain loop's completion probe (new work is gated off
        upstream while draining, so this only ever goes to True and
        stays)."""
        with self._lock:
            if self._active > 0:
                return False
            batchers = [b for bs in self._batchers.values() for b in bs]
        return all(b.outstanding() == 0 for b in batchers)

    def _model_snapshot(self, sts: List[_Stats],
                        queues: List[int]) -> Dict[str, Any]:
        """One model's snapshot doc across its replicas (caller holds
        ``_stats_lock``). A single replica delegates to its stats block
        verbatim — the exact pre-replication document, so the
        replicas=1 metric surface is byte-for-byte. Multi-replica docs
        sum counters, sum per-replica QPS, weight the service rate by
        dispatched rows, and merge the latency HISTOGRAMS element-wise
        before estimating percentiles (a percentile of percentiles
        would be meaningless). Both carry a ``replicas`` list with each
        replica's slim occupancy/rate/health row."""
        per = [st.snapshot(q) for st, q in zip(sts, queues)]
        if len(per) == 1:
            doc = per[0]
        else:
            doc = {k: sum(p[k] for p in per)
                   for k in ("requests", "rows", "batches", "batched_rows",
                             "rejected", "timeouts", "errors",
                             "deadline_exceeded", "dispatcher_restarts",
                             "queue_rows")}
            doc["quarantined"] = (
                1 if all(p["quarantined"] for p in per) else 0)
            doc["qps"] = round(sum(p["qps"] for p in per), 3)
            doc["mean_batch_rows"] = (
                round(doc["batched_rows"] / doc["batches"], 3)
                if doc["batches"] else 0.0)
            br = doc["batched_rows"]
            doc["service_us_per_row"] = (
                round(sum(p["service_us_per_row"] * p["batched_rows"]
                          for p in per) / br, 3) if br else 0.0)
            life = [sum(v) for v in
                    zip(*(st.lat_buckets for st in sts))]
            window = [sum(v) for v in zip(
                *([a + b for a, b in zip(st._lat_prev, st._lat_recent)]
                  for st in sts))]
            source = window if sum(window) else life

            def pct(q: float) -> Optional[float]:
                est = profiling.quantile_from_buckets(source, q)
                return None if est is None else round(est * 1e3, 3)

            doc["p50_ms"] = pct(0.50)
            doc["p99_ms"] = pct(0.99)
            doc["latency"] = {
                "buckets": life,
                "sum_s": round(sum(st.lat_sum_s for st in sts), 6)}
        doc["replicas"] = [
            {"replica": i,
             "queue_rows": p["queue_rows"],
             "qps": p["qps"],
             "service_us_per_row": p["service_us_per_row"],
             "requests": p["requests"],
             "rows": p["rows"],
             "batches": p["batches"],
             "batched_rows": p["batched_rows"],
             "mean_batch_rows": p["mean_batch_rows"],
             "dispatcher_restarts": p["dispatcher_restarts"],
             "quarantined": p["quarantined"]}
            for i, p in enumerate(per)]
        return doc

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            names = list(self._stats)
            queue = {n: ([b.queue_rows() for b in self._batchers[n]]
                         if n in self._batchers
                         else [0] * len(self._stats[n])) for n in names}
        with _stats_lock:
            models = {n: self._model_snapshot(self._stats[n], queue[n])
                      for n in names}
        agg: Dict[str, Any] = {
            "requests": sum(m["requests"] for m in models.values()),
            "rows": sum(m["rows"] for m in models.values()),
            "batches": sum(m["batches"] for m in models.values()),
            "rejected": sum(m["rejected"] for m in models.values()),
            "timeouts": sum(m["timeouts"] for m in models.values()),
            "errors": sum(m["errors"] for m in models.values()),
            "deadline_exceeded": sum(m["deadline_exceeded"]
                                     for m in models.values()),
            "dispatcher_restarts": sum(m["dispatcher_restarts"]
                                       for m in models.values()),
            "quarantined": sum(m["quarantined"] for m in models.values()),
            "queue_rows": sum(m["queue_rows"] for m in models.values()),
            "qps": round(sum(m["qps"] for m in models.values()), 3),
        }
        batches = agg["batches"]
        agg["mean_batch_rows"] = (
            round(sum(m["mean_batch_rows"] * m["batches"]
                      for m in models.values()) / batches, 3)
            if batches else 0.0)
        return {**agg, "aot": self.aot.snapshot(), "models": models}

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            batchers = [b for bs in self._batchers.values() for b in bs]
            self._batchers.clear()
        for b in batchers:
            b.stop()
