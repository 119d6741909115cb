"""End-to-end request tracing — correlated spans from HTTP to device.

The aggregate tier (``OpTimer`` means/maxes on ``/metrics``) answers
"how slow is this operation on average"; it cannot answer "where did
THIS request/job spend its time" — the blind spot that makes a sweep
regression a human archaeology job, and exactly the per-stage
attribution tf.data's authors used to find input-pipeline stalls
(PAPERS 2101.12127). The Spark study (PAPERS 1612.01437) shows aggregate
stage timers mis-attribute scheduler/queue time to compute; spans with
parent links are the fix.

Design (stdlib-only, like lolint):

- every HTTP request and async job mints a **trace id** (honoring an
  inbound ``X-Request-Id``); the id flows through contextvars on one
  process, explicitly captured contexts across thread pools
  (``attach``), and the SPMD job-channel spec across processes
  (``to_wire``/``from_wire``) — workers ship their spans back over the
  channel and :func:`ingest` merges them, so ``GET /trace/{id}`` on the
  coordinator shows the whole pod;
- **spans** record name, parent link, start and duration, attributes
  (dataset, model, rows, ...), status, and the recording process;
- every span takes both ends from :func:`now` (wall seconds on a
  monotonic base), so a child's [start, end] lies inside its parent's;
- a sampled span also opens ``torch.profiler.record_function(name)``
  while a profiler runs, so a profile with CPU activity carries the
  program's spans on the profiler's own clock beside the kernels they
  launched;
- spans land in a bounded **ring buffer** (``LO_TPU_TRACE_BUFFER_SPANS``,
  FIFO eviction — a long-lived server holds a recent window, never
  leaks); ``GET /traces`` lists recent root spans, ``GET /trace/{id}``
  returns one trace's span tree;
- **sampling** (``LO_TPU_TRACE_SAMPLE``): the record/skip decision is
  made once per trace; unsampled traces still mint + propagate ids (the
  response's ``X-Request-Id`` must always be quotable) but record
  nothing and skip all child-span bookkeeping — the bench's overhead
  A/B flips exactly this knob.

The port's span names beyond the taxonomy in docs/observability.md
(each sampled-only; attributes in parentheses):

- ``catalog.consolidate`` (catalog/dataset.py; rows, chunks, bytes): a
  dataset's chunks materialized and concatenated; a cached consolidation
  records nothing;
- ``design.steps`` (ops/preprocess.py; rows, steps, fill_one_read,
  fill_full): label handling and the preprocessing steps of a resident
  design; the float columns whose fillna fill was fitted by one read, and
  the full way;
- ``design.stack`` (ops/preprocess.py; rows, cols, blocks, threads): the
  feature columns stacked into the float32 design matrix, in ``blocks``
  row blocks over ``threads`` threads (1 and 1 for a small design);
- ``design.build`` also in viz/service.py (parent, rows): the embed's
  design;
- ``runtime.put`` (parallel/runtime.py; bytes, pinned): one host→device
  copy — a put, a lazy design's block feed, a tune driver's masks; a
  transfer-cache hit records nothing;
- ``tree.edges`` (models/trees.py; rows_sampled, n_bins): host quantile
  bin edges;
- ``registry.save`` (models/persistence.py; name, bytes): one model
  persisted;
- ``tune.masks`` (models/tune.py; rows, members): a sweep's (folds, rows)
  fold masks built on the host and copied to the device once, then each
  wave's tiling of them to its members on the device;
- ``tune.wave`` (models/tune.py; wave, members): one wave's set-up, from
  its masks' tiling on the device through its driver (edges, copies, the
  binning launch);
- ``tune.promotion`` (models/builder.py): the winner's edges, its refit
  (the ``tune.promote`` timer) and its save;
- ``viz.edge_table`` (viz/tsne.py; edges, in_cols, overflow_edges,
  device): the descent's edge table, built on the device that holds the
  kNN; like the other ``viz.<stage>`` spans it ends when the device has
  finished the stage;
- ``tx.init`` (models/sequence.py; params, bytes): a tx fit's parameters
  drawn; ``tx.predict`` (rows): one predict chunk;
- ``tx.step`` (models/sequence.py; tokens, loss, load_ratio, pairs_held,
  kda_ms, mla_ms, moe_ms): one training step, ending when its loss has
  been read back. ``<region>_ms`` is the device time of a region the
  block marks (utils/regions.py: CUDA events at the region's boundaries,
  forward, recomputation and backward; on a card only): ``kda`` the Kimi
  Delta Attention layers (models/kda.py), ``mla`` the latent attention,
  ``moe`` the expert layers. ``load_ratio`` is the busiest expert's
  pairs over the mean, the largest over the expert layers;
  ``pairs_held`` the (token, expert) pairs the experts this rank holds
  computed in the step — the expert layer's counters
  (``moe.counts()``: tokens_routed, tokens_dropped, bias_updates,
  pairs_held, pairs_elsewhere) count them over the process.

Recording is cheap by construction: one ``os.urandom`` id + a dict and
a deque-append under a short lock per span, no I/O, no serialization
until a ``/traces`` read. The serving hot path adds ~4 spans per traced
request; see bench.py's ``tracing_overhead`` section for the measured
cost.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "TraceContext", "Timing", "current", "new_id", "now", "trace", "span",
    "timing", "job_trace",
    "attach", "record_span", "to_wire", "from_wire", "ingest",
    "spans_for", "pop_spans", "trace_tree", "recent_traces",
    "counters_snapshot", "attribution_snapshot", "recent_span_docs",
    "reset", "set_sample", "set_capacity", "set_process",
]


#: The wall clock and the performance counter, read once at import: the
#: anchors of ``now``.
_WALL0 = time.time()
_PERF0 = time.perf_counter()


def now() -> float:
    """Wall seconds on a monotonic base: ``time.time()`` at import plus
    the performance counter's advance since. Every span takes its start
    and its end from here, so a step of the system clock never makes a
    child end outside its parent."""
    return _WALL0 + (time.perf_counter() - _PERF0)


class TraceContext:
    """The ambient trace position of the current logical operation:
    which trace, which span is the would-be parent, and whether this
    trace records at all."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "duration_s", "attrs", "status", "error", "process")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, start: float,
                 duration_s: float, attrs: Optional[Dict[str, Any]],
                 status: str = "ok", error: Optional[str] = None,
                 process: Optional[int] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.duration_s = duration_s
        self.attrs = attrs
        self.status = status
        self.error = error
        self.process = _process() if process is None else process

    def to_doc(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "start": round(self.start, 6),
            "duration_ms": round(self.duration_s * 1e3, 3),
            "process": self.process, "status": self.status,
        }
        if self.attrs:
            doc["attrs"] = dict(self.attrs)
        if self.error:
            doc["error"] = self.error
        return doc

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "Span":
        return cls(str(doc["trace_id"]), str(doc["span_id"]),
                   doc.get("parent_id"), str(doc.get("name", "?")),
                   float(doc.get("start", 0.0)),
                   float(doc.get("duration_ms", 0.0)) / 1e3,
                   doc.get("attrs"), str(doc.get("status", "ok")),
                   doc.get("error"), int(doc.get("process", 0)))


_ctx: "ContextVar[Optional[TraceContext]]" = ContextVar(
    "lo_trace_ctx", default=None)

_lock = threading.Lock()
_spans: "deque[Span]" = deque()
_counters = {"spans_recorded": 0, "spans_dropped": 0, "spans_ingested": 0,
             "traces_started": 0, "traces_unsampled": 0}
#: None = read the knob from config.settings on use; tests/bench pin via
#: set_sample / set_capacity (the readpipe set_cache_budget pattern).
_sample_override: Optional[float] = None
_capacity_override: Optional[int] = None
#: This process's rank on recorded spans. The package runs as one
#: process, so it is 0 unless a caller pins it with set_process.
_process_override: Optional[int] = None


def new_id() -> str:
    """A fresh 64-bit hex id (trace or span)."""
    return os.urandom(8).hex()


def _process() -> int:
    return _process_override or 0


def set_process(index: int) -> None:
    """Pin the process rank stamped on this process's spans."""
    global _process_override
    _process_override = int(index)


def _sample_rate() -> float:
    if _sample_override is not None:
        return _sample_override
    from learningorchestra_tpu_torch.config import settings

    return float(settings.trace_sample)


def set_sample(rate: Optional[float]) -> None:
    """Pin the sampling rate (tests, bench A/B); None restores the
    ``LO_TPU_TRACE_SAMPLE`` process default."""
    global _sample_override
    _sample_override = rate


def _capacity() -> int:
    if _capacity_override is not None:
        return _capacity_override
    from learningorchestra_tpu_torch.config import settings

    return int(settings.trace_buffer_spans)


def set_capacity(spans: Optional[int]) -> None:
    """Pin the ring-buffer capacity (tests); None restores the
    ``LO_TPU_TRACE_BUFFER_SPANS`` process default. Shrinking evicts."""
    global _capacity_override
    with _lock:
        _capacity_override = spans
        cap = _capacity()
        while len(_spans) > max(0, cap):
            _spans.popleft()
            _counters["spans_dropped"] += 1


def current() -> Optional[TraceContext]:
    return _ctx.get()


# -- latency attribution ------------------------------------------------------

#: Span names aggregated into the per-model/per-phase histogram table,
#: mapped to the attribute carrying their label. ``fit.<family>.<sub>``
#: names are handled structurally (phase ``fit.<sub>``, label family).
_ATTR_PHASES = {"queue.wait": "model", "dispatch.device": "model",
                "design.build": "model", "batch.coalesce": "model",
                "http.handle": "route"}
#: Cardinality bound on (phase, label) entries: past it, new labels are
#: dropped (counted) instead of letting a scanner of made-up model
#: names grow /metrics without bound.
_ATTR_MAX_ENTRIES = 512
#: (phase, label) -> {count, total_s, max_s, buckets}. The seam that
#: turns the span taxonomy into "where did the p99 go" without grepping
#: /traces: every recorded span whose name is in the taxonomy ALSO
#: lands in a log-bucketed histogram keyed by phase and model/family.
_attrib: Dict[tuple, Dict[str, Any]] = {}


def _attrib_key(name: str,
                attrs: Optional[Dict[str, Any]]) -> Optional[tuple]:
    label_attr = _ATTR_PHASES.get(name)
    if label_attr is not None:
        label = (attrs or {}).get(label_attr)
        if label:
            return (name, str(label))
        # Only http.handle collapses label-less spans into "-"
        # (unmatched 404s carry no route by design). Model-labeled
        # phases SKIP instead: SPMD workers' job-path dispatch.device
        # spans carry no model, and folding multi-second sweep programs
        # into a "serving" phase would wildly inflate its percentiles.
        return (name, "-") if name == "http.handle" else None
    if name.startswith("fit."):
        parts = name.split(".")
        if len(parts) == 3:                 # fit.<family>.<sub-phase>
            return (f"fit.{parts[2]}", parts[1])
        if len(parts) == 2:                 # fit.<family>
            return ("fit", parts[1])
    return None


def _attrib_observe(span_obj: Span) -> None:
    """Fold one span into the attribution table (caller holds _lock).
    Deliberately independent of ring capacity: a server with span
    retention off still answers the aggregate question."""
    key = _attrib_key(span_obj.name, span_obj.attrs)
    if key is None:
        return
    ent = _attrib.get(key)
    if ent is None:
        if len(_attrib) >= _ATTR_MAX_ENTRIES:
            _counters["attribution_dropped"] = \
                _counters.get("attribution_dropped", 0) + 1
            return
        from learningorchestra_tpu_torch.utils import profiling

        ent = _attrib[key] = {"count": 0, "total_s": 0.0, "max_s": 0.0,
                              "buckets": profiling.new_histogram()}
    from learningorchestra_tpu_torch.utils import profiling

    ent["count"] += 1
    ent["total_s"] += span_obj.duration_s
    ent["max_s"] = max(ent["max_s"], span_obj.duration_s)
    profiling.observe(ent["buckets"], span_obj.duration_s)


def attribution_snapshot() -> Dict[str, Dict[str, Any]]:
    """The ``latency_attribution`` section of ``/metrics``: per-phase,
    per-model (or per-family, per-route) latency histograms aggregated
    from the span taxonomy — ``queue.wait`` / ``dispatch.device`` /
    ``design.build`` / ``batch.coalesce`` by model, ``fit.*`` by
    family, ``http.handle`` by route. Derived from SAMPLED spans, so
    under ``LO_TPU_TRACE_SAMPLE<1`` it attributes the sampled subset."""
    from learningorchestra_tpu_torch.utils import profiling

    with _lock:
        items = [(k, dict(v, buckets=list(v["buckets"])))
                 for k, v in _attrib.items()]
    out: Dict[str, Dict[str, Any]] = {}
    for (phase, label), ent in sorted(items):
        p50 = profiling.quantile_from_buckets(ent["buckets"], 0.50)
        p99 = profiling.quantile_from_buckets(ent["buckets"], 0.99)
        out.setdefault(phase, {})[label] = {
            "count": ent["count"],
            "total_s": round(ent["total_s"], 6),
            "max_s": round(ent["max_s"], 6),
            "mean_ms": round(ent["total_s"] / ent["count"] * 1e3, 3),
            "p50_ms": None if p50 is None else round(p50 * 1e3, 3),
            "p99_ms": None if p99 is None else round(p99 * 1e3, 3),
            "buckets": ent["buckets"],
        }
    return out


def _record(span_obj: Span, ingested: bool = False) -> None:
    with _lock:
        cap = _capacity()
        _counters["spans_ingested" if ingested else "spans_recorded"] += 1
        _attrib_observe(span_obj)
        if cap <= 0:
            _counters["spans_dropped"] += 1
            return
        while len(_spans) >= cap:
            _spans.popleft()
            _counters["spans_dropped"] += 1
        _spans.append(span_obj)


class Timing:
    """The two ends of a region on :func:`now`: ``start``, and
    ``seconds`` once the region has closed."""

    __slots__ = ("start", "seconds")


def _mirror(name: str):
    """``torch.profiler.record_function(name)``, entered, while a
    profiler runs in this process; None otherwise (torch not loaded, or
    no profiler on)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


@contextmanager
def _recorded(ctx: TraceContext, parent_id: Optional[str], name: str,
              attrs: Optional[Dict[str, Any]],
              t: Timing) -> Iterator[TraceContext]:
    """Make ``ctx`` ambient for the block, mirror it into a running
    profiler, and record it as a span of ``t``'s extent. An exception
    escaping the block records ``status="error"`` and re-raises."""
    token = _ctx.set(ctx)
    rf = _mirror(name)
    t.start = now()
    status, err = "ok", None
    try:
        yield ctx
    except BaseException as exc:
        status, err = "error", f"{type(exc).__name__}: {exc}"
        raise
    finally:
        t.seconds = now() - t.start
        if rf is not None:
            rf.__exit__(None, None, None)
        _ctx.reset(token)
        _record(Span(ctx.trace_id, ctx.span_id, parent_id, name, t.start,
                     t.seconds, attrs, status, err))


@contextmanager
def trace(name: str, trace_id: Optional[str] = None,
          attrs: Optional[Dict[str, Any]] = None,
          sampled: Optional[bool] = None) -> Iterator[TraceContext]:
    """Open a ROOT span and make its trace the ambient context. The
    ``attrs`` dict is recorded by reference at exit, so callers may keep
    mutating it inside the block (e.g. stamping the HTTP status late).
    An exception escaping the block records the span with
    ``status="error"`` and re-raises."""
    if sampled is None:
        rate = _sample_rate()
        sampled = rate >= 1.0 or (rate > 0.0 and random.random() < rate)
    ctx = TraceContext(trace_id or new_id(), new_id(), sampled)
    with _lock:
        _counters["traces_started"] += 1
        if not sampled:
            _counters["traces_unsampled"] += 1
    if not sampled:
        token = _ctx.set(ctx)
        try:
            yield ctx
        finally:
            _ctx.reset(token)
        return
    with _recorded(ctx, None, name, attrs, Timing()):
        yield ctx


@contextmanager
def span(name: str, attrs: Optional[Dict[str, Any]] = None,
         **kw: Any) -> Iterator[Optional[TraceContext]]:
    """Open a child span under the ambient trace. No ambient trace (or
    an unsampled one) ⇒ near-zero-cost no-op — instrumented code needs
    no guards. ``attrs``/keyword attrs merge; the dict is recorded by
    reference so the block may keep filling it in."""
    parent = _ctx.get()
    if parent is None or not parent.sampled:
        yield parent
        return
    if kw:
        attrs = {**(attrs or {}), **kw}
    with _recorded(TraceContext(parent.trace_id, new_id(), True),
                   parent.span_id, name, attrs, Timing()) as ctx:
        yield ctx


@contextmanager
def timing(name: Optional[str],
           attrs: Optional[Dict[str, Any]] = None) -> Iterator[Timing]:
    """Time a region on :func:`now` and, under a sampled ambient trace,
    record it as the span ``name`` (``attrs`` on it) of the same extent,
    open across the block so that spans opened inside are its children.
    Yields the ``Timing``, whose ``seconds`` is set once the block exits
    — how ``timed`` and ``device_span`` report the very duration their
    span records. ``name=None`` only times."""
    t = Timing()
    parent = _ctx.get() if name is not None else None
    if parent is None or not parent.sampled:
        t.start = now()
        try:
            yield t
        finally:
            t.seconds = now() - t.start
        return
    with _recorded(TraceContext(parent.trace_id, new_id(), True),
                   parent.span_id, name, attrs, t):
        yield t


@contextmanager
def job_trace(name: str, trace_id: Optional[str] = None,
              parent: Optional[TraceContext] = None,
              attrs: Optional[Dict[str, Any]] = None
              ) -> Iterator[Optional[TraceContext]]:
    """An async job's root scope: when the submitting request's context
    was captured, the job's span joins THAT trace (one trace spans HTTP
    accept → job completion); otherwise the job becomes a trace of its
    own under ``trace_id`` (internal submissions: retries, resumed
    ingests)."""
    if parent is not None:
        with attach(parent), span(name, attrs=attrs) as ctx:
            yield ctx
    else:
        with trace(name, trace_id=trace_id, attrs=attrs) as ctx:
            yield ctx


@contextmanager
def attach(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Make an explicitly captured context ambient on this thread — how
    trace position crosses thread pools (builder fit threads, job
    workers) and, via the wire form, processes."""
    if ctx is None:
        yield None
        return
    token = _ctx.set(ctx)
    try:
        yield ctx
    finally:
        _ctx.reset(token)


def record_span(name: str, duration_s: float, *,
                ctx: Optional[TraceContext] = None,
                parent_id: Optional[str] = None,
                span_id: Optional[str] = None,
                t_wall: Optional[float] = None,
                attrs: Optional[Dict[str, Any]] = None,
                status: str = "ok",
                error: Optional[str] = None) -> Optional[str]:
    """Record a span with an EXACT externally measured duration, ending
    now unless ``t_wall`` gives its start — how instrumentation points
    that already time themselves (the batcher's queue-wait bookkeeping)
    emit spans that agree with their metrics to the digit. Nothing
    opened inside the measured region can be its child: a region that
    can be a ``with`` block uses ``span`` or ``timing`` instead. Returns
    the span id, or None when the (explicit or ambient) context is
    absent/unsampled.

    ``parent_id=""`` records a ROOT span (parent None) — how the
    front-end worker's event loop emits its ``http.handle`` root after
    the fact (an async request has no enclosing ``with trace(...)``
    frame to root it)."""
    c = ctx if ctx is not None else _ctx.get()
    if c is None or not c.sampled:
        return None
    sid = span_id or new_id()
    pid: Optional[str] = (parent_id if parent_id is not None
                          else c.span_id)
    if pid == "":
        pid = None
    _record(Span(c.trace_id, sid,
                 pid,
                 name,
                 t_wall if t_wall is not None else now() - duration_s,
                 duration_s, attrs, status, error))
    return sid


# -- cross-process propagation ------------------------------------------------

def to_wire(ctx: Optional[TraceContext] = None) -> Optional[Dict[str, Any]]:
    """The JSON-safe carrier stamped onto SPMD job specs."""
    c = ctx if ctx is not None else _ctx.get()
    if c is None:
        return None
    return {"trace_id": c.trace_id, "span_id": c.span_id,
            "sampled": bool(c.sampled)}


def from_wire(doc: Optional[Dict[str, Any]]) -> Optional[TraceContext]:
    if not isinstance(doc, dict) or "trace_id" not in doc:
        return None
    return TraceContext(str(doc["trace_id"]),
                        str(doc.get("span_id") or new_id()),
                        bool(doc.get("sampled", True)))


def ingest(docs: List[Dict[str, Any]]) -> int:
    """Merge span docs recorded by ANOTHER process (workers ship theirs
    over the job channel after each dispatched job) into this buffer, so
    the coordinator's ``GET /trace/{id}`` covers the whole pod. Returns
    how many were accepted."""
    n = 0
    for doc in docs:
        try:
            s = Span.from_doc(doc)
        except (KeyError, TypeError, ValueError):
            continue
        _record(s, ingested=True)
        n += 1
    return n


# -- queries ------------------------------------------------------------------

def _snapshot() -> List[Span]:
    with _lock:
        return list(_spans)


def spans_for(trace_id: str) -> List[Dict[str, Any]]:
    """All buffered spans of one trace, as docs, sorted by start time —
    the flat list ``/trace/{id}`` serves."""
    spans = [s for s in _snapshot() if s.trace_id == trace_id]
    spans.sort(key=lambda s: s.start)
    return [s.to_doc() for s in spans]


def pop_spans(trace_id: str) -> List[Dict[str, Any]]:
    """Remove and return one trace's spans (start-ordered docs) — the
    wire form SPMD workers ship to the coordinator. Popping (not
    copying) means a trace that dispatches several jobs never re-ships
    an earlier job's spans, and worker buffers stay lean."""
    with _lock:
        keep, out = deque(), []
        for s in _spans:
            (out if s.trace_id == trace_id else keep).append(s)
        _spans.clear()
        _spans.extend(keep)
    out.sort(key=lambda s: s.start)
    return [s.to_doc() for s in out]


def trace_tree(trace_id: str) -> Optional[Dict[str, Any]]:
    """One trace's span tree: flat ``spans`` (start-ordered) plus nested
    ``roots`` where each span doc carries its ``children``. Spans whose
    parent was evicted (or lives only on a process whose spans never
    merged) surface as roots rather than disappearing."""
    docs = spans_for(trace_id)
    if not docs:
        return None
    # Dedupe by span id (a worker shipment that merged twice — late
    # drain + next-round ack path — must not double nodes).
    seen_ids: set = set()
    docs = [d for d in docs
            if d["span_id"] not in seen_ids
            and not seen_ids.add(d["span_id"])]
    by_id = {d["span_id"]: dict(d, children=[]) for d in docs}
    roots = []
    for d in docs:
        node = by_id[d["span_id"]]
        parent = d.get("parent_id")
        if parent and parent in by_id and parent != d["span_id"]:
            by_id[parent]["children"].append(node)
        else:
            roots.append(node)
    start = min(d["start"] for d in docs)
    end = max(d["start"] + d["duration_ms"] / 1e3 for d in docs)
    return {
        "trace_id": trace_id,
        "span_count": len(docs),
        "processes": sorted({d["process"] for d in docs}),
        "start": round(start, 6),
        "duration_ms": round((end - start) * 1e3, 3),
        "spans": docs,
        "roots": roots,
    }


def recent_traces(route: Optional[str] = None, kind: Optional[str] = None,
                  min_ms: Optional[float] = None,
                  limit: int = 50) -> List[Dict[str, Any]]:
    """Recent traces (newest first), one summary per trace id. The
    summary is the trace's root span (parent-less; earliest span when
    the root was evicted) plus the trace's span count, full wall extent
    (``duration_ms`` — an async job trace is as long as its job, not its
    201 response), and the ``kinds`` of any job spans it contains.

    ``route`` filters on the root's ``route`` attribute (HTTP traces);
    ``kind`` matches the trace's job kinds — async jobs JOIN their
    submitting request's trace, so the sweep you're hunting is a child
    span, not a root; ``min_ms`` filters on the trace extent — the
    "show me every slow sweep" query."""
    groups: Dict[str, List[Span]] = {}
    for s in _snapshot():
        groups.setdefault(s.trace_id, []).append(s)
    out: List[Dict[str, Any]] = []
    for _tid, spans in sorted(groups.items(),
                              key=lambda kv: -max(s.start
                                                  for s in kv[1])):
        root = next((s for s in spans if s.parent_id is None),
                    min(spans, key=lambda s: s.start))
        attrs = root.attrs or {}
        kinds = sorted({str((s.attrs or {}).get("kind", ""))
                        for s in spans if s.name.startswith("job.")} - {""})
        extent_ms = (max(s.start + s.duration_s for s in spans)
                     - min(s.start for s in spans)) * 1e3
        if route is not None and route not in str(attrs.get("route", "")) \
                and route not in str(attrs.get("path", "")):
            # "route" is the matched route PATTERN on HTTP spans (one
            # label per route); "path" keeps the concrete URL, so both
            # "/files/{name}" and "/files/my_dataset" filters work.
            continue
        if kind is not None and kind not in kinds \
                and kind not in root.name:
            continue
        if min_ms is not None and extent_ms < min_ms:
            continue
        doc = root.to_doc()
        doc["spans"] = len(spans)
        doc["duration_ms"] = round(extent_ms, 3)
        if kinds:
            doc["kinds"] = kinds
        out.append(doc)
        if len(out) >= max(1, limit):
            break
    return out


def recent_span_docs(limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """The newest ``limit`` buffered spans as docs (buffer order =
    completion order) — what the flight recorder freezes into a
    bundle's ``spans.json``."""
    spans = _snapshot()
    if limit is not None and len(spans) > limit:
        spans = spans[-limit:]
    return [s.to_doc() for s in spans]


def counters_snapshot() -> Dict[str, Any]:
    """Tracing's own health counters for ``/metrics``."""
    with _lock:
        out: Dict[str, Any] = dict(_counters)
        out["buffer_spans"] = len(_spans)
        out["buffer_capacity"] = _capacity()
        return out


def reset() -> None:
    """Drop every span, the attribution table, and zero counters (test
    isolation)."""
    with _lock:
        _spans.clear()
        _attrib.clear()
        for k in _counters:
            _counters[k] = 0
