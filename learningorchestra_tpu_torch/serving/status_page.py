"""Cluster status page — the HTML view of /cluster + /jobs + /files.

The reference ships a live Docker Swarm visualizer on port 80
(docker-compose.yml:109-121) so operators can see cluster topology and
task placement in a browser. Here the equivalent operator surface is one
self-refreshing HTML page over the same data the JSON routes serve:
process/mesh topology, the job ledger, and the dataset catalog. No
JavaScript framework, no assets — a single stdlib-rendered page, because
the deployment story is "one binary" (SURVEY.md §7).
"""

from __future__ import annotations

from html import escape
from typing import Any, Dict, List, Optional

_STYLE = """
body { font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a2e;
       background: #f7f7fb; }
h1 { font-size: 1.4rem; } h2 { font-size: 1.1rem; margin-top: 1.6rem; }
table { border-collapse: collapse; width: 100%; background: #fff;
        box-shadow: 0 1px 2px rgba(0,0,0,.08); }
th, td { text-align: left; padding: .35rem .6rem; font-size: .85rem;
         border-bottom: 1px solid #e8e8ef; }
th { background: #eceff6; }
.badge { display: inline-block; padding: .1rem .45rem; border-radius: .6rem;
         font-size: .75rem; color: #fff; }
.done { background: #2e7d32; } .failed { background: #c62828; }
.running { background: #1565c0; } .queued { background: #8d6e63; }
.kv { display: inline-block; margin-right: 1.2rem; }
.kv b { color: #444; }
"""

_STATUS_CLASS = {"done": "done", "failed": "failed",
                 "running": "running", "queued": "queued",
                 "firing": "failed", "ok": "done",
                 "quarantined": "failed", "draining": "queued",
                 "serving": "done"}


def _fmt_bytes(n: Any) -> str:
    if not isinstance(n, (int, float)):
        return ""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return ""


def _badge(status: str) -> str:
    cls = _STATUS_CLASS.get(status, "queued")
    return f'<span class="badge {cls}">{escape(status)}</span>'


def _table(headers: List[str], rows: List[List[str]]) -> str:
    head = "".join(f"<th>{escape(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>"
        for row in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


def _phase_breakdown(attribution: Optional[Dict[str, Any]],
                     model: str) -> str:
    """One cell answering "where did this model's p99 go": the per-
    phase p99s the span-taxonomy aggregation attributes to it
    (queue wait / device dispatch / design build)."""
    if not attribution:
        return ""
    parts = []
    for phase, short in (("queue.wait", "queue"),
                         ("dispatch.device", "device"),
                         ("design.build", "design")):
        ent = (attribution.get(phase) or {}).get(model)
        if ent and ent.get("p99_ms") is not None:
            parts.append(f"{short} {ent['p99_ms']:g}")
    return escape(" / ".join(parts))


def _sparkline(points: List[List[float]], width: int = 140,
               height: int = 28) -> str:
    """One series as an inline SVG polyline — no JS, no assets, exactly
    like the rest of the page. Flat series render mid-height so 'no
    traffic' looks calm, not broken."""
    if len(points) < 2:
        return '<span style="color:#aaa">no history</span>'
    ts = [p[0] for p in points]
    vs = [p[1] for p in points]
    t0, t1 = min(ts), max(ts)
    v0, v1 = min(vs), max(vs)
    tspan = (t1 - t0) or 1.0
    vspan = (v1 - v0) or 1.0
    coords = " ".join(
        f"{(t - t0) / tspan * (width - 2) + 1:.1f},"
        f"{height - 1 - (v - v0) / vspan * (height - 2):.1f}"
        for t, v in zip(ts, vs))
    return (f'<svg width="{width}" height="{height}" '
            f'viewBox="0 0 {width} {height}">'
            f'<polyline points="{coords}" fill="none" '
            f'stroke="#1565c0" stroke-width="1.5"/></svg>')


def _history_section(history: Optional[Dict[str, Any]]) -> str:
    """Sparklines over the telemetry history store — the page's answer
    to "what happened while nobody was watching" (the JSON form lives
    at /metrics/history)."""
    if not history or not history.get("series"):
        return ""
    cells = []
    for name, points in sorted(history["series"].items()):
        last = points[-1][1] if points else ""
        cells.append(
            f'<span class="kv"><b>{escape(str(name))}</b> '
            f'{_sparkline(points)} {escape(f"{last:g}")}</span>')
    span = ""
    if history.get("from") and history.get("to"):
        span = (f'<p style="color:#888;font-size:.75rem">'
                f'{history.get("samples", 0)} samples over '
                f'{history["to"] - history["from"]:.0f}s — full series '
                f'at <a href="/metrics/history">/metrics/history</a></p>')
    return f"<h2>History</h2><p>{''.join(cells)}</p>{span}"


def _serving_section(serving: Optional[Dict[str, Any]],
                     attribution: Optional[Dict[str, Any]] = None) -> str:
    """The online-inference panel: queue depth, p99, QPS per model — so
    backpressure is visible at a glance without curling /metrics. The
    phase column decomposes each model's latency (queue / device /
    design p99s from the span-taxonomy aggregation)."""
    if not serving:
        return ""
    agg = "".join(
        f'<span class="kv"><b>{escape(str(k))}</b> {escape(str(v))}</span>'
        for k, v in serving.items()
        if k not in ("models", "aot") and v is not None)
    rows = []
    for name, m in sorted((serving.get("models") or {}).items()):
        rows.append([
            escape(str(name)),
            _badge("quarantined" if m.get("quarantined") else "ok"),
            _replica_cells(m.get("replicas")),
            escape(str(m.get("requests", 0))),
            escape(str(m.get("qps", 0))),
            escape(str(m.get("mean_batch_rows", 0))),
            escape(str(m.get("queue_rows", 0))),
            escape("" if m.get("p50_ms") is None else str(m["p50_ms"])),
            escape("" if m.get("p99_ms") is None else str(m["p99_ms"])),
            _phase_breakdown(attribution, str(name)),
            escape(str(m.get("rejected", 0))),
            escape(str(m.get("deadline_exceeded", 0))),
            escape(str(m.get("dispatcher_restarts", 0))),
        ])
    table = _table(["model", "state", "replicas", "requests", "qps",
                    "rows/batch", "queue", "p50 (ms)", "p99 (ms)",
                    "phase p99s (ms)", "rejected (503)", "expired (504)",
                    "restarts"], rows)
    return (f"<h2>Online predict ({len(rows)} models)</h2>"
            f"<p>{agg}</p>{table}")


def _replica_cells(replicas: Optional[List[Dict[str, Any]]]) -> str:
    """One compact line per device replica: index, queue depth, qps and
    quarantine flag — the router's view of the replica plane, readable
    without curling the per-replica Prometheus series."""
    if not replicas:
        return ""
    parts = []
    for r in replicas:
        state = " ⛔" if r.get("quarantined") else ""
        parts.append(escape(
            f"r{r.get('replica', '?')}: q={r.get('queue_rows', 0)} "
            f"qps={r.get('qps', 0)}{state}"))
    return "<br>".join(parts)


def _alerts_section(alerts: Optional[Dict[str, Any]]) -> str:
    """The SLO panel: every rule with its state, so 'is the service
    healthy against its SLOs' is answerable without curling /alerts."""
    if not alerts or not alerts.get("rules"):
        return ""
    firing = alerts.get("firing") or []
    rows = []
    for name, r in sorted(alerts["rules"].items()):
        rows.append([
            escape(str(name)),
            escape(str(r.get("severity", ""))),
            _badge("firing" if r.get("firing") else "ok"),
            escape("" if r.get("value") is None
                   else f"{r['value']:.6g}"),
            escape(f"{r.get('op', '>')} {r.get('threshold'):.6g}"),
            escape(str(r.get("fired_count", 0))),
        ])
    head = (f'<p><span class="kv"><b>firing</b> '
            f'{escape(", ".join(firing) or "none")}</span></p>')
    return (f"<h2>Alerts ({len(firing)} firing)</h2>{head}"
            + _table(["rule", "severity", "state", "value", "threshold",
                      "times fired"], rows))


def _resources_section(res: Optional[Dict[str, Any]]) -> str:
    """One line of capacity vitals: host RSS/fds, device bytes, disk
    headroom, compile totals — the /resources snapshot at a glance."""
    if not res:
        return ""
    host = res.get("host") or {}
    dev = res.get("devices") or {}
    disk = res.get("disk") or {}
    comp = res.get("compile") or {}
    kvs = [
        ("host rss", _fmt_bytes(host.get("rss_bytes"))),
        ("open fds", host.get("open_fds")),
        ("device bytes", _fmt_bytes(dev.get("total_bytes_in_use"))),
        # Per-device occupancy as compact d<i>=<bytes> pairs — with
        # replicated serving params every replica's device shows up,
        # not just device 0; devices holding nothing are elided.
        ("per device", " ".join(
            f"d{i}={_fmt_bytes(d['bytes_in_use'])}"
            for i, d in enumerate(dev.get("devices") or [])
            if d.get("bytes_in_use")) or None),
        ("device source", dev.get("source")),
        ("store", _fmt_bytes(disk.get("store_bytes"))),
        ("disk free", _fmt_bytes(disk.get("free_bytes"))),
        ("compiles", comp.get("compiles")),
        ("compile s", comp.get("compile_s")),
    ]
    line = "".join(
        f'<span class="kv"><b>{escape(str(k))}</b> {escape(str(v))}</span>'
        for k, v in kvs if v not in (None, ""))
    return f"<h2>Resources</h2><p>{line}</p>"


def render_status(cluster: Dict[str, Any], jobs: List[Dict[str, Any]],
                  datasets: List[Dict[str, Any]],
                  refresh_seconds: int = 5,
                  serving: Optional[Dict[str, Any]] = None,
                  alerts: Optional[Dict[str, Any]] = None,
                  resources: Optional[Dict[str, Any]] = None,
                  attribution: Optional[Dict[str, Any]] = None,
                  history: Optional[Dict[str, Any]] = None) -> str:
    """Render the operator page. Inputs are exactly what the JSON routes
    return, so the page can never disagree with the API."""
    mesh = cluster.get("mesh") or {}
    mesh_txt = " × ".join(f"{escape(str(k))}={escape(str(v))}"
                          for k, v in mesh.items()) or "—"
    cluster_kvs = "".join(
        f'<span class="kv"><b>{escape(str(k))}</b> {escape(str(v))}</span>'
        for k, v in cluster.items() if k != "mesh")

    job_rows = []
    for j in sorted(jobs, key=lambda j: j.get("started_at", 0),
                    reverse=True):
        job_rows.append([
            escape(str(j.get("job_id", ""))),
            escape(str(j.get("kind", ""))),
            escape(str(j.get("dataset", ""))),
            _badge(str(j.get("status", ""))),
            escape(f"{j['duration']:.1f}"
                   if j.get("duration") is not None else ""),
            escape(str(j.get("error") or "")),
        ])

    ds_rows = []
    for d in sorted(datasets, key=lambda d: str(d.get("filename", ""))):
        state = ("failed" if d.get("error")
                 else "done" if d.get("finished") else "running")
        ds_rows.append([
            escape(str(d.get("filename", ""))),
            escape(str(d.get("parent_filename") or d.get("url") or "")),
            _badge(state),
            escape(str(len(d.get("fields") or []))),
            escape(str(d.get("error") or "")),
        ])

    return f"""<!doctype html>
<html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="{refresh_seconds}">
<title>learningorchestra-tpu cluster</title>
<style>{_STYLE}</style></head>
<body>
<h1>learningorchestra-tpu — cluster status</h1>
<p>{cluster_kvs}<span class="kv"><b>mesh</b> {mesh_txt}</span></p>
{_alerts_section(alerts)}
{_resources_section(resources)}
{_serving_section(serving, attribution)}
{_history_section(history)}
<h2>Jobs ({len(jobs)})</h2>
{_table(["job", "kind", "target datasets", "status", "runtime (s)",
         "error"], job_rows)}
<h2>Datasets ({len(datasets)})</h2>
{_table(["name", "origin", "state", "fields", "error"], ds_rows)}
<p style="color:#888;font-size:.75rem">auto-refreshes every
{refresh_seconds}s — JSON at <a href="/cluster">/cluster</a>,
<a href="/jobs">/jobs</a>, <a href="/files">/files</a>,
<a href="/metrics">/metrics</a>,
<a href="/metrics/history">/metrics/history</a>,
<a href="/traces">/traces</a>,
<a href="/debug/flightrec">/debug/flightrec</a>,
<a href="/resources">/resources</a>,
<a href="/alerts">/alerts</a>,
<a href="/healthz">/healthz</a>; Prometheus at
<a href="/metrics?format=prometheus">/metrics?format=prometheus</a></p>
</body></html>"""
