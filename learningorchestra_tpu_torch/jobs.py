"""Async job manager — the framework's completion/failure protocol.

The reference's async model: an HTTP request returns 201 immediately, work
continues on daemon threads, and completion is signaled *only* by the
dataset's metadata ``finished`` flag flipping true, which clients poll every
3 s (reference database.py:199-216, client __init__.py:14-32). There is no
failure signal — a crashed job leaves ``finished: false`` forever
(SURVEY.md §5).

This manager keeps the same observable contract (request returns, poll the
metadata) and adds: a job registry with status/timing, guaranteed terminal
state (``finished`` always flips, with ``error`` set on failure), and a
bounded worker pool replacing unbounded daemon-thread spawning.
"""

from __future__ import annotations

import contextvars
import json
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from learningorchestra_tpu_torch.utils import failpoints, tracing
from learningorchestra_tpu_torch.utils.profiling import op_timer
from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("jobs")

#: Deterministic fault-injection site: the head of every progress mark
#: (``heartbeat``) — ``hang``/``slow`` here simulates a wedge at a
#: round/pass boundary, which is exactly what the watchdog must catch.
FP_JOB_PRE_HEARTBEAT = failpoints.declare("job.pre_heartbeat")

#: The currently-running job's record: its body (and anything it calls
#: on the same thread) records profiling counters — streamed-fit pass
#: counts, per-family device seconds — that surface on the job's /jobs
#: doc. A ContextVar, not a thread-local: the JobManager pool thread
#: owns the context for the job's whole body.
_job_record: contextvars.ContextVar = contextvars.ContextVar(
    "lo_job_record", default=None)

#: Serializes profile merges: watermark updates arrive from concurrent
#: family threads (builder's pipelined sweep) and from the SPMD span
#: drain, and a lost read-modify-write would silently drop a family's
#: entry. Every merge still publishes a FRESH dict (never mutates the
#: published one), so /jobs listings stay safe to copy lock-free.
_profile_lock = threading.Lock()


def current_job_record():
    """The ambient managed-job record, or None outside one — capture it
    before fanning work out to a thread pool (pool threads carry no
    ContextVar context) and re-attach with :func:`attach_job_record`,
    the same discipline as ``tracing.attach``."""
    return _job_record.get()


@contextmanager
def attach_job_record(rec):
    """Make an explicitly captured job record ambient on this thread, so
    profile/watermark recording from fan-out threads (the builder's
    per-family fit threads) lands on the right job. None = no-op."""
    if rec is None:
        yield
        return
    token = _job_record.set(rec)
    try:
        yield
    finally:
        _job_record.reset(token)


def record_job_profile(**entries: Any) -> None:
    """Merge profiling metadata into the current job's record (no-op when
    called outside a managed job, e.g. from the synchronous test path).
    Publishes by swapping in a fresh merged dict — never mutating the
    published one in place — so a concurrent /jobs listing copying
    ``profile`` can never see it change size mid-iteration."""
    rec = _job_record.get()
    if rec is not None:
        with _profile_lock:
            rec.profile = {**rec.profile, **entries}


def record_job_watermarks(*, peak_hbm_bytes: Optional[int] = None,
                          compile_s: Optional[float] = None,
                          host_rss_delta: Optional[int] = None,
                          family: Optional[str] = None,
                          family_stats: Optional[Dict[str, Any]] = None
                          ) -> None:
    """Merge resource watermarks into the current job's profile with
    watermark semantics (utils/resources.py is the sampler): peaks
    max-merge, ``compile_s`` max-merges too (phase deltas are subsets of
    the whole-job window, so the largest observed window wins — never a
    double-counting sum), ``host_rss_delta`` takes the latest whole-job
    figure, and per-family ``fit_resources`` entries accumulate
    (compile sums across a family's phases, peak maxes). No-op outside
    a managed job."""
    rec = _job_record.get()
    if rec is None:
        return
    with _profile_lock:
        prof = dict(rec.profile)
        if peak_hbm_bytes is not None:
            prof["peak_hbm_bytes"] = max(
                int(peak_hbm_bytes), int(prof.get("peak_hbm_bytes", 0)))
        if compile_s is not None:
            prof["compile_s"] = round(
                max(float(compile_s), float(prof.get("compile_s", 0.0))), 6)
        if host_rss_delta is not None:
            prof["host_rss_delta"] = int(host_rss_delta)
        if family is not None and family_stats:
            fr = dict(prof.get("fit_resources", {}))
            ent = dict(fr.get(family, {"compile_s": 0.0,
                                       "peak_hbm_bytes": 0}))
            ent["compile_s"] = round(
                float(ent.get("compile_s", 0.0))
                + float(family_stats.get("compile_s", 0.0)), 6)
            ent["peak_hbm_bytes"] = max(
                int(ent.get("peak_hbm_bytes", 0)),
                int(family_stats.get("peak_hbm_bytes", 0)))
            fr[family] = ent
            prof["fit_resources"] = fr
        rec.profile = prof

#: Job-tier fault counters (process-wide, monotone — the alert engine
#: reads deltas): watchdog kills and checkpoint resumes. Module-level so
#: trainers/preprocess can count a resume without holding a JobManager.
_fault_lock = threading.Lock()
_fault = {"watchdog_fired_total": 0, "jobs_resumed_total": 0}


def fault_snapshot() -> Dict[str, int]:
    """The ``job_fault`` section of ``/metrics``."""
    with _fault_lock:
        return dict(_fault)


def heartbeat() -> None:
    """Progress mark: the running job is ALIVE and advancing. Called at
    natural boundaries — gb boost-round/checkpoint batches, rf tree
    batches, mlp iteration segments, streamed-fit pass boundaries, SPMD
    dispatch round completion — it resets the watchdog's liveness clock
    (``LO_TPU_JOB_DEADLINE_S`` bounds the gap BETWEEN marks, so a slow
    but progressing fit survives while a wedged program dies). No-op
    outside a managed job."""
    failpoints.fire(FP_JOB_PRE_HEARTBEAT)
    rec = _job_record.get()
    if rec is not None:
        rec.progress_mono = time.monotonic()


def record_job_resume(label: str, doc: Dict[str, Any]) -> None:
    """A fit (or the streamed design fit) resumed from a checkpoint:
    count it and surface the provenance on the job profile as
    ``resumed_from[label]`` (round/pass reached, writing epoch) so
    ``/jobs`` shows what a retry actually skipped."""
    with _fault_lock:
        _fault["jobs_resumed_total"] += 1
    rec = _job_record.get()
    if rec is None:
        return
    with _profile_lock:
        prof = dict(rec.profile)
        resumed = dict(prof.get("resumed_from", {}))
        resumed[label] = dict(doc)
        prof["resumed_from"] = resumed
        rec.profile = prof


#: Error prefixes marking a job killed by INFRASTRUCTURE — a pod worker
#: death (watchdog flag, parallel/spmd.py) or a process restart mid-job
#: (catalog load_all) — rather than by its own inputs. Only these are
#: safe and useful to retry automatically: a deterministic input error
#: would just fail identically again.
RETRYABLE_ERROR_PREFIXES = ("pod failure:", "interrupted:")


def select_retry_groups(docs: List[Dict[str, Any]],
                        max_retries: int) -> List[Dict[str, Any]]:
    """Pick the failed jobs worth re-running after a restart.

    ``docs`` are catalog metadata docs (``DatasetStore.metadata_docs``).
    A dataset is retryable when it reached a terminal FAILED state from an
    infrastructure cause (:data:`RETRYABLE_ERROR_PREFIXES`), carries the
    ``job`` spec the serving layer recorded at submission (enough to
    re-run it), and has been retried fewer than ``max_retries`` times.
    Datasets sharing one job spec (a model build owns one prediction
    dataset per classifier) group into a single re-run. Returns
    ``[{"spec": job_spec, "datasets": [names...]}, ...]``.
    """
    groups: Dict[str, Dict[str, Any]] = {}
    for doc in docs:
        err = doc.get("error")
        if not doc.get("finished") or not err:
            continue
        if not any(err.startswith(p) for p in RETRYABLE_ERROR_PREFIXES):
            continue
        spec = doc.get("job")
        if not isinstance(spec, dict) or "kind" not in spec:
            continue
        if int(doc.get("retries", 0) or 0) >= max_retries:
            continue
        key = json.dumps(spec, sort_keys=True, default=str)
        group = groups.setdefault(key, {"spec": spec, "datasets": []})
        group["datasets"].append(doc["filename"])
    return list(groups.values())


@dataclass
class JobRecord:
    job_id: str
    dataset: str
    kind: str
    status: str = "running"          # running | done | failed
    error: Optional[str] = None
    started_at: float = field(default_factory=time.time)
    finished_at: Optional[float] = None
    #: The job's trace id: the submitting HTTP request's trace when one
    #: was ambient at submit (one trace spans accept → job completion),
    #: else freshly minted — either way, ``GET /trace/{id}`` resolves it.
    trace_id: Optional[str] = None
    #: Profiling metadata the job body recorded (record_job_profile):
    #: streamed-fit pass counts, per-family device_s, ...
    profile: Dict[str, Any] = field(default_factory=dict)
    #: Liveness deadline (seconds of no progress before the watchdog
    #: fails the job); None/0 = unbounded (today's behavior).
    deadline_s: Optional[float] = None
    #: Monotonic clock of the last progress mark (``heartbeat``).
    progress_mono: float = field(default_factory=time.monotonic)
    #: The body actually began executing: the watchdog only judges
    #: STARTED jobs — pool queue-wait is a capacity condition, not a
    #: hung device program, and must never poison the pod.
    body_started: bool = False

    def to_doc(self) -> Dict[str, Any]:
        doc = {
            "job_id": self.job_id, "dataset": self.dataset, "kind": self.kind,
            "status": self.status, "error": self.error,
            "started_at": self.started_at, "finished_at": self.finished_at,
            "duration": (self.finished_at or time.time()) - self.started_at,
            "trace_id": self.trace_id,
        }
        if self.deadline_s:
            doc["deadline_s"] = self.deadline_s
        if self.profile:
            doc["profile"] = dict(self.profile)
        return doc


class JobManager:
    """Bounded-pool async job runner with per-dataset failure recording."""

    #: Terminal job records kept for /jobs observability; oldest evicted
    #: beyond this so a long-lived server doesn't leak a record per job.
    MAX_RECORDS = 1000

    #: Watchdog scan cadence, seconds — cheap (a lock + a few clock
    #: reads per running job) and fine-grained enough for sub-second
    #: test deadlines.
    WATCHDOG_POLL_S = 0.1

    def __init__(self, store, max_workers: int = 8, cfg=None):
        from learningorchestra_tpu_torch.config import settings as global_settings

        self.store = store
        self.cfg = cfg or global_settings
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="lo-job")
        self._lock = threading.Lock()
        self._jobs: Dict[str, JobRecord] = {}
        self._seq = 0
        self._watchdog_started = False

    # -- the device-program watchdog ----------------------------------------

    def _ensure_watchdog(self) -> None:
        """Start the liveness watchdog lazily on the first deadline'd
        job — a server with LO_TPU_JOB_DEADLINE_S unset never spawns the
        thread at all."""
        with self._lock:
            if self._watchdog_started:
                return
            self._watchdog_started = True
        # thread-lifecycle: owner=JobManager; daemon scan loop that
        # lives for the process (the manager has no shutdown seam and
        # the loop only reads/flips job records); exceptions are caught
        # per scan so the sanitizer never sees it die.
        threading.Thread(target=self._watchdog_loop, daemon=True,
                         name="lo-job-watchdog").start()

    def _watchdog_loop(self) -> None:
        while True:
            time.sleep(self.WATCHDOG_POLL_S)
            try:
                self._watchdog_scan()
            except Exception:  # noqa: BLE001 — the watchdog must outlive bugs
                log.exception("job watchdog scan failed")

    def _watchdog_scan(self) -> None:
        now = time.monotonic()
        expired: List[JobRecord] = []
        with self._lock:
            for rec in self._jobs.values():
                if (rec.status != "running" or not rec.deadline_s
                        or not rec.body_started):
                    continue
                if now - rec.progress_mono > rec.deadline_s:
                    rec.status = "failed"
                    rec.error = (
                        f"interrupted: watchdog: job {rec.job_id} "
                        f"({rec.kind}) made no progress for "
                        f"{rec.deadline_s:.1f}s — device program "
                        "presumed hung")
                    rec.finished_at = time.time()
                    expired.append(rec)
        for rec in expired:
            self._expire(rec)

    def _expire(self, rec: JobRecord) -> None:
        """Post-transition actions for one watchdog-killed job: pollable
        failure records (the retryable ``interrupted:`` prefix — the
        restarted pod's rescan re-runs the job, which then resumes from
        its fit checkpoint), pod poison (the supervisor's health poll
        sees the degradation and restarts the pod under a fresh mesh
        epoch, which is what actually tears down the hung program), and a
        flight-recorder evidence bundle. The hung thread itself cannot be
        killed from Python — bounding its damage is the supervisor
        restart's job."""
        from learningorchestra_tpu_torch.parallel import spmd
        from learningorchestra_tpu_torch.utils import flightrec

        with _fault_lock:
            _fault["watchdog_fired_total"] += 1
        log.error("%s", rec.error)
        for name in [n for n in rec.dataset.split(",") if n]:
            try:
                if not self.store.get(name).metadata.finished:
                    self.store.fail(name, rec.error)
            except Exception:  # noqa: BLE001 — best-effort flagging
                pass
        spmd.poison_pod(f"watchdog: job {rec.job_id} ({rec.kind}) hung "
                        f"past its {rec.deadline_s:.1f}s deadline")
        flightrec.incident(
            "job:watchdog",
            detail={"job_id": rec.job_id, "kind": rec.kind,
                    "dataset": rec.dataset,
                    "deadline_s": rec.deadline_s,
                    "trace_id": rec.trace_id})
        op_timer.record(f"job.{rec.kind}",
                        rec.finished_at - rec.started_at)

    def _settle(self, rec: JobRecord, status: str,
                error: Optional[str] = None) -> bool:
        """Atomically move a RUNNING record to a terminal state; False
        when something else (the watchdog) already terminated it — the
        woken-up job body must never overwrite the watchdog's verdict
        (or resurrect a job whose datasets were already failed)."""
        with self._lock:
            if rec.status != "running":
                return False
            rec.status = status
            rec.error = error
            return True

    def submit(self, kind: str, dataset,
               fn: Callable[[], Any]) -> JobRecord:
        """Run ``fn`` async. On exception, mark the job's dataset(s) failed
        in the catalog (finished=True + error) so pollers terminate.

        ``dataset`` may be one name or a sequence of names — a model build
        owns one prediction dataset per classifier and all of them must
        reach a terminal state if the job dies before (or after) creating
        them.
        """
        datasets: List[str] = ([dataset] if isinstance(dataset, str)
                               else list(dataset))
        deadline_s = float(self.cfg.job_deadline_s or 0.0) or None
        # Capture the submitting thread's trace position NOW: the pool
        # thread running the job has no ambient context of its own, and
        # the HTTP request whose handler submitted us will be long gone.
        parent_ctx = tracing.current()
        with self._lock:
            self._seq += 1
            rec = JobRecord(job_id=f"{kind}-{self._seq}",
                            dataset=",".join(datasets), kind=kind,
                            trace_id=(parent_ctx.trace_id if parent_ctx
                                      else tracing.new_id()),
                            deadline_s=deadline_s)
            self._jobs[rec.job_id] = rec
            if len(self._jobs) > self.MAX_RECORDS:
                for jid, r in list(self._jobs.items()):
                    if len(self._jobs) <= self.MAX_RECORDS:
                        break
                    if r.status != "running":
                        del self._jobs[jid]

        def _fail_datasets():
            for name in datasets:
                # Only unfinished datasets get the failure flag — ones
                # that completed before the crash keep their results.
                try:
                    if not self.store.get(name).metadata.finished:
                        self.store.fail(name, rec.error)
                except Exception:
                    pass

        def run():
            from learningorchestra_tpu_torch.parallel.spmd import PodDegraded

            token = _job_record.set(rec)
            # The liveness clock starts HERE, not at submit: time spent
            # queued behind the bounded pool never reads as a hang.
            rec.progress_mono = time.monotonic()
            rec.body_started = True
            settled = False
            try:
                # The job's root span: joins the submitting request's
                # trace when one was ambient, else roots a new trace
                # under rec.trace_id. Everything the job body records
                # (design.build, fit.*, journal.commit) nests under it; a
                # raise marks the span status=error before the handling
                # below. resources.job_phase is the resource-sampling
                # seam: every managed job's profile carries
                # peak_hbm_bytes / compile_s / host_rss_delta, refined
                # mid-job by the builder's per-phase samples.
                from learningorchestra_tpu_torch import config
                from learningorchestra_tpu_torch.utils import resources

                with tracing.job_trace(
                        f"job.{kind}", trace_id=rec.trace_id,
                        parent=parent_ctx,
                        attrs={"kind": kind, "dataset": rec.dataset,
                               "job_id": rec.job_id,
                               "mesh_epoch": config.mesh_epoch()}), \
                        resources.job_phase():
                    fn()
                settled = self._settle(rec, "done")
            except PodDegraded as exc:
                # A job refused (or interrupted) because the pod is
                # degraded failed from INFRASTRUCTURE, exactly like one
                # the watchdog flagged — record it under the retryable
                # prefix so the restarted pod's rescan re-runs it, e.g.
                # a build queued behind the one whose worker died.
                settled = self._settle(rec, "failed",
                                       f"pod failure: {exc}")
                traceback.print_exc()
                if settled:
                    _fail_datasets()
            except Exception as exc:  # noqa: BLE001 — job boundary
                settled = self._settle(rec, "failed",
                                       f"{type(exc).__name__}: {exc}")
                traceback.print_exc()
                if settled:
                    _fail_datasets()
            finally:
                _job_record.reset(token)
                # A record the watchdog already terminated keeps its
                # verdict (and its finished_at — the moment the OPERATOR
                # learned the job died, not the moment the hung thread
                # finally woke up).
                if settled:
                    rec.finished_at = time.time()
                    op_timer.record(f"job.{kind}",
                                    rec.finished_at - rec.started_at)

        if deadline_s:
            self._ensure_watchdog()
        future: Future = self._pool.submit(run)
        rec._future = future  # type: ignore[attr-defined]
        return rec

    def wait_all(self, timeout: Optional[float] = None) -> None:
        """Block until all submitted jobs reach a terminal state (tests)."""
        deadline = None if timeout is None else time.time() + timeout
        for rec in list(self._jobs.values()):
            fut = getattr(rec, "_future", None)
            if fut is not None:
                remaining = None if deadline is None else max(
                    0.0, deadline - time.time())
                fut.result(timeout=remaining)

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.to_doc() for r in self._jobs.values()]

    def running_count(self) -> int:
        """Jobs not yet terminal (includes pool-queued ones — their
        record is minted "running" at submit): the drain loop's quiesce
        probe for the job plane."""
        with self._lock:
            return sum(1 for r in self._jobs.values()
                       if r.status == "running")
