"""Prometheus text exposition (version 0.0.4) for ``GET /metrics``.

One registry, two formats: the JSON ``/metrics`` document (op timer,
jobs, read pipeline, serving, integrity, tracing) is ALSO rendered as
Prometheus exposition text when the scrape asks for
``?format=prometheus`` — generated from the identical snapshot, so the
two views can never disagree. stdlib-only renderer; no client library.

Mapping conventions:

- ``ops`` entries → ``lo_op_seconds`` histograms labeled ``op=...``
  (cumulative ``_bucket`` series over the shared
  :data:`~learningorchestra_tpu_torch.utils.profiling.BUCKETS_S` ladder, plus
  ``_sum``/``_count``) and a ``lo_op_max_seconds`` gauge;
- ``jobs`` → ``lo_jobs{status=...}`` gauge;
- ``read_pipeline`` / ``integrity`` / ``tracing`` counters →
  ``lo_read_pipeline_*`` / ``lo_integrity_*`` / ``lo_trace_*``;
- ``serving`` per-model counters → ``lo_serving_*_total{model=...}``,
  live gauges (``queue_rows``, ``qps``), and the request-latency
  histogram ``lo_serving_latency_seconds{model=...}`` — the log-bucketed
  histogram that replaced the old rolling-sample p50/p99 (the JSON
  view's ``p50_ms``/``p99_ms`` are estimated from the same buckets);
- ``resources`` → ``lo_resource_*`` gauges: host RSS/fds/threads,
  per-device HBM (``{device=...}`` where the backend reports it, plus
  process totals), and chunk-store disk usage/free (``{root=...}``);
- ``compile`` → ``lo_compile_*`` counters (backend compiles = cache
  misses, cumulative compile seconds, cache hits);
- ``alerts`` → ``lo_alert_firing{alert=...}`` 0/1 gauges with
  ``lo_alert_value``/``lo_alert_threshold`` next to them, plus engine
  counters; ``pod`` → ``lo_pod_degraded``;
- ``latency_attribution`` (the span-taxonomy aggregation,
  utils/tracing.py) → ``lo_phase_seconds{phase=...,label=...}``
  histograms — queue wait / device dispatch / design build per model,
  fit sub-phases per family, handling per route;
- ``telemetry`` (utils/timeseries.py) → ``lo_telemetry_*`` gauges;
  ``flightrec`` (utils/flightrec.py) → ``lo_flightrec_*`` counters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from learningorchestra_tpu_torch.utils.profiling import BUCKETS_S

_COUNTER = "counter"
_GAUGE = "gauge"
_HISTOGRAM = "histogram"


def _esc(value: Any) -> str:
    """Escape a label value per the exposition format."""
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(value: Any) -> str:
    """Render a sample value; integers stay integral for readability."""
    f = float(value)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _labels(labels: Optional[Dict[str, Any]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


class _Writer:
    def __init__(self):
        self.lines: List[str] = []
        self._typed: set = set()

    def header(self, name: str, mtype: str, help_text: str) -> None:
        if name in self._typed:
            return
        self._typed.add(name)
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {mtype}")

    def sample(self, name: str, labels: Optional[Dict[str, Any]],
               value: Any) -> None:
        self.lines.append(f"{name}{_labels(labels)} {_fmt(value)}")

    def histogram(self, name: str, labels: Dict[str, Any],
                  buckets: Sequence[int], total_s: float,
                  count: int) -> None:
        """Cumulative ``_bucket`` series from non-cumulative counts."""
        cum = 0
        for bound, c in zip(BUCKETS_S, buckets):
            cum += c
            self.sample(f"{name}_bucket", {**labels, "le": repr(bound)},
                        cum)
        self.sample(f"{name}_bucket", {**labels, "le": "+Inf"}, count)
        self.sample(f"{name}_sum", labels, total_s)
        self.sample(f"{name}_count", labels, count)

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def _flat_counters(w: _Writer, prefix: str, doc: Dict[str, Any],
                   mtype: str, help_text: str) -> None:
    for key, val in sorted(doc.items()):
        if not isinstance(val, (int, float)) or isinstance(val, bool):
            continue
        name = f"{prefix}_{key}"
        w.header(name, mtype, f"{help_text} ({key})")
        w.sample(name, None, val)


def render(doc: Dict[str, Any]) -> str:
    """The exposition text for one ``/metrics`` JSON document."""
    w = _Writer()

    ops = doc.get("ops") or {}
    if ops:
        w.header("lo_op_seconds", _HISTOGRAM,
                 "Wall-clock of framework operations by op name")
        for op, s in sorted(ops.items()):
            buckets = s.get("buckets")
            if buckets is None:
                continue
            w.histogram("lo_op_seconds", {"op": op}, buckets,
                        s.get("total_s", 0.0), s.get("count", 0))
        w.header("lo_op_max_seconds", _GAUGE,
                 "Max observed wall-clock per op name")
        for op, s in sorted(ops.items()):
            w.sample("lo_op_max_seconds", {"op": op}, s.get("max_s", 0.0))

    jobs = doc.get("jobs") or {}
    if jobs:
        w.header("lo_jobs", _GAUGE, "Job records by status")
        for status, n in sorted(jobs.items()):
            w.sample("lo_jobs", {"status": status}, n)

    fault = doc.get("job_fault") or {}
    if fault:
        w.header("lo_job_watchdog_fired_total", _COUNTER,
                 "Jobs killed by the liveness watchdog (no progress "
                 "past LO_TPU_JOB_DEADLINE_S — hung device program)")
        w.sample("lo_job_watchdog_fired_total", None,
                 fault.get("watchdog_fired_total", 0))
        w.header("lo_jobs_resumed_total", _COUNTER,
                 "Fits resumed from a mid-fit checkpoint instead of "
                 "restarting from scratch")
        w.sample("lo_jobs_resumed_total", None,
                 fault.get("jobs_resumed_total", 0))

    fck = doc.get("fit_checkpoints") or {}
    if fck:
        w.header("lo_fit_checkpoint_bytes", _GAUGE,
                 "Bytes of fit-progress checkpoints under "
                 "<store_root>/_fitckpt")
        w.sample("lo_fit_checkpoint_bytes", None, fck.get("bytes", 0))
        w.header("lo_fit_checkpoint_files", _GAUGE,
                 "Checkpoint payload/sidecar files on disk")
        w.sample("lo_fit_checkpoint_files", None, fck.get("files", 0))
        for key in ("writes", "resumes", "discarded"):
            name = f"lo_fit_checkpoint_{key}_total"
            w.header(name, _COUNTER,
                     f"Fit-checkpoint store {key} this process")
            w.sample(name, None, fck.get(key, 0))

    for section, prefix, mtype, help_text in (
            ("read_pipeline", "lo_read_pipeline", _COUNTER,
             "Chunk-read pipeline counter"),
            ("tune", "lo_tune", _COUNTER,
             "Hyperparameter-search plane counter"),
            ("integrity", "lo_integrity", _COUNTER,
             "Data-plane integrity counter"),
            ("ingest", "lo_ingest", _COUNTER,
             "Range-partitioned ingest plane counter"),
            # Mixed live values (buffer occupancy) and monotone totals:
            # gauge is the honest common type.
            ("tracing", "lo_trace", _GAUGE, "Tracing subsystem metric")):
        sec = doc.get(section) or {}
        if sec:
            _flat_counters(w, prefix, sec, mtype, help_text)

    shard = doc.get("shard") or {}
    if shard:
        for key in ("local_reads", "remote_reads"):
            name = f"lo_shard_{key}_total"
            w.header(name, _COUNTER,
                     f"Shard-placement planner {key.replace('_', ' ')} "
                     "(rows of shard_chunked feed classified against the "
                     "dataset shard map)")
            w.sample(name, None, shard.get(key, 0))

    rep = doc.get("replication") or {}
    if rep.get("enabled"):
        for key in ("pushes", "push_bytes", "fetches", "repairs",
                    "errors"):
            name = f"lo_replica_{key}_total"
            w.header(name, _COUNTER,
                     f"Peer replication plane {key} this process")
            w.sample(name, None, (rep.get("counters") or {}).get(key, 0))
        w.header("lo_replica_lag_bytes", _GAUGE,
                 "Journal bytes committed locally but not yet acked by "
                 "the worst-lagging peer, per dataset")
        for dname, d in sorted((rep.get("datasets") or {}).items()):
            w.sample("lo_replica_lag_bytes", {"dataset": dname},
                     d.get("lag_bytes", 0))
        w.header("lo_replica_under_replicated", _GAUGE,
                 "(dataset, peer) pairs with replication lag and a "
                 "failed last push")
        w.sample("lo_replica_under_replicated", None,
                 len(rep.get("under_replicated") or []))
        w.header("lo_replica_peers", _GAUGE,
                 "Configured peer replica targets")
        w.sample("lo_replica_peers", None, len(rep.get("peers") or []))

    serving = doc.get("serving") or {}
    models = serving.get("models") or {}
    if models:
        for key in ("requests", "rows", "batches", "batched_rows",
                    "rejected", "timeouts", "errors", "deadline_exceeded",
                    "dispatcher_restarts"):
            name = f"lo_serving_{key}_total"
            w.header(name, _COUNTER,
                     f"Online predict tier {key} per model")
            for model, m in sorted(models.items()):
                w.sample(name, {"model": model}, m.get(key, 0))
        # quarantined is a LEVEL (0/1 per model), not a monotone count.
        w.header("lo_serving_quarantined", _GAUGE,
                 "1 while the model is quarantined (dispatcher crashed "
                 "past its threshold; predicts answer a terminal 503)")
        for model, m in sorted(models.items()):
            w.sample("lo_serving_quarantined", {"model": model},
                     m.get("quarantined", 0))
        for key in ("queue_rows", "qps", "mean_batch_rows"):
            name = f"lo_serving_{key}"
            w.header(name, _GAUGE,
                     f"Online predict tier live {key} per model")
            for model, m in sorted(models.items()):
                w.sample(name, {"model": model}, m.get(key) or 0)
        w.header("lo_serving_latency_seconds", _HISTOGRAM,
                 "End-to-end online predict latency per model")
        for model, m in sorted(models.items()):
            hist = m.get("latency") or {}
            buckets = hist.get("buckets")
            if buckets is None:
                continue
            w.histogram("lo_serving_latency_seconds", {"model": model},
                        buckets, hist.get("sum_s", 0.0),
                        m.get("requests", 0))
        # Per-replica plane (serve_replicas): each replica's dispatcher
        # occupancy, routing inputs, and health, labeled
        # {model=...,replica=...}. Rendered for every topology — at
        # replicas=1 the single replica-0 row equals the model row.
        for key in ("batches", "batched_rows", "dispatcher_restarts"):
            name = f"lo_serving_replica_{key}_total"
            w.header(name, _COUNTER,
                     f"Online predict tier {key} per device replica")
            for model, m in sorted(models.items()):
                for r in m.get("replicas") or []:
                    w.sample(name,
                             {"model": model, "replica": r["replica"]},
                             r.get(key, 0))
        for key in ("queue_rows", "qps", "service_us_per_row",
                    "mean_batch_rows"):
            name = f"lo_serving_replica_{key}"
            w.header(name, _GAUGE,
                     f"Online predict tier live {key} per device replica "
                     "(the router's cost inputs)")
            for model, m in sorted(models.items()):
                for r in m.get("replicas") or []:
                    w.sample(name,
                             {"model": model, "replica": r["replica"]},
                             r.get(key) or 0)
        w.header("lo_serving_replica_quarantined", _GAUGE,
                 "1 while this device replica is quarantined (its "
                 "siblings keep serving; the model-level gauge only "
                 "rises when every replica is down)")
        for model, m in sorted(models.items()):
            for r in m.get("replicas") or []:
                w.sample("lo_serving_replica_quarantined",
                         {"model": model, "replica": r["replica"]},
                         r.get("quarantined", 0))
    aot = serving.get("aot") or {}
    if aot:
        _flat_counters(w, "lo_serving_aot", aot, _COUNTER,
                       "AOT predict-program cache counter")

    frontend = doc.get("frontend") or {}
    if frontend:
        # Multi-worker front end (LO_TPU_HTTP_WORKERS > 1): accept-
        # process liveness + respawns and row-channel frame counters.
        # Gauge is the honest common type — live worker counts sit next
        # to monotone frame totals.
        _flat_counters(w, "lo_frontend", frontend, _GAUGE,
                       "Multi-worker serving front end metric")

    res = doc.get("resources") or {}
    host = res.get("host") or {}
    if host:
        _flat_counters(w, "lo_resource_host", host, _GAUGE,
                       "Host process resource gauge")
    devices = res.get("devices") or {}
    if devices:
        for key in ("total_bytes_in_use", "peak_bytes_in_use"):
            val = devices.get(key)
            if isinstance(val, (int, float)):
                name = f"lo_resource_device_{key}"
                w.header(name, _GAUGE,
                         f"Device memory across local devices ({key})")
                w.sample(name, None, val)
        for dev in devices.get("devices") or []:
            for key in ("bytes_in_use", "peak_bytes_in_use",
                        "bytes_limit"):
                val = dev.get(key)
                if isinstance(val, (int, float)):
                    name = f"lo_resource_device_{key}_by_device"
                    w.header(name, _GAUGE,
                             f"Per-device memory gauge ({key})")
                    w.sample(name, {"device": dev.get("id", "?")}, val)
    disk = res.get("disk") or {}
    if disk:
        for key in ("total_bytes", "free_bytes", "used_bytes",
                    "store_bytes"):
            val = disk.get(key)
            if isinstance(val, (int, float)):
                name = f"lo_resource_disk_{key}"
                w.header(name, _GAUGE,
                         f"Chunk-store filesystem gauge ({key})")
                w.sample(name, {"root": disk.get("root", "?")}, val)

    comp = doc.get("compile") or {}
    if comp:
        _flat_counters(w, "lo_compile", comp, _COUNTER,
                       "XLA compile accounting counter")

    attrib = doc.get("latency_attribution") or {}
    if attrib:
        w.header("lo_phase_seconds", _HISTOGRAM,
                 "Latency attributed per phase of the span taxonomy "
                 "(queue wait / device dispatch / design build per "
                 "model, fit sub-phases per family, handling per route)")
        for phase, labels in sorted(attrib.items()):
            for label, ent in sorted(labels.items()):
                buckets = ent.get("buckets")
                if buckets is None:
                    continue
                w.histogram("lo_phase_seconds",
                            {"phase": phase, "label": label}, buckets,
                            ent.get("total_s", 0.0), ent.get("count", 0))

    tele = doc.get("telemetry") or {}
    if tele:
        # Mixed live values (ring occupancy) and monotone totals:
        # gauge is the honest common type, like lo_trace_*.
        _flat_counters(w, "lo_telemetry", tele, _GAUGE,
                       "Telemetry history store metric")
    rec = doc.get("flightrec") or {}
    if rec:
        _flat_counters(w, "lo_flightrec", rec, _GAUGE,
                       "Flight recorder metric")

    pod = doc.get("pod") or {}
    if pod:
        w.header("lo_pod_degraded", _GAUGE,
                 "1 while the pod is degraded (worker death pending "
                 "supervisor restart)")
        w.sample("lo_pod_degraded", None,
                 1 if pod.get("degraded") else 0)

    al = doc.get("alerts") or {}
    rules = al.get("rules") or {}
    if rules:
        w.header("lo_alert_firing", _GAUGE,
                 "1 while the named alert rule is firing")
        for name, r in sorted(rules.items()):
            w.sample("lo_alert_firing", {"alert": name},
                     1 if r.get("firing") else 0)
        w.header("lo_alert_value", _GAUGE,
                 "Last evaluated value of the named alert rule")
        for name, r in sorted(rules.items()):
            if isinstance(r.get("value"), (int, float)):
                w.sample("lo_alert_value", {"alert": name}, r["value"])
        w.header("lo_alert_threshold", _GAUGE,
                 "Configured threshold of the named alert rule")
        for name, r in sorted(rules.items()):
            w.sample("lo_alert_threshold", {"alert": name},
                     r.get("threshold", 0))
        _flat_counters(
            w, "lo_alert", {k: al[k] for k in
                            ("evaluations", "fired_total",
                             "resolved_total") if k in al},
            _COUNTER, "Alert engine counter")

    return w.text()
