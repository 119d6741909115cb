"""Telemetry history — persistent time-series over the metrics registry.

Every signal of the tracing and resource planes is point-in-time and
process-lifetime: a restart, a crash, or simply not being scraped at the
right second erases the evidence. Production pipelines are debugged
from *retained* telemetry (PAPERS 1909.10389's pipeline monitoring;
1612.01437's post-hoc bottleneck analysis), and a multi-tenant
scheduler needs historical queue/latency series as its cost signal.
This module is that memory:

- :class:`TelemetryHistory` flattens the ``/metrics`` registry document
  into named numeric series (``serving.models.<m>.p99_ms``,
  ``resources.host.rss_bytes``, ...) and appends one sample per
  ``LO_TPU_TELEMETRY_SAMPLE_S`` into a bounded in-memory ring — fed by
  a background sampler thread, so history accrues whether or not
  anything scrapes the server (registry reads also contribute, gated to
  the same cadence, so the two feeds never double-sample);
- every ``LO_TPU_TELEMETRY_SEGMENT_SAMPLES`` samples the ring rotates a
  **delta-encoded segment** (first record full, subsequent records only
  the keys whose value changed) to ``<store_root>/_telemetry/``, with
  bounded retention — history survives restarts without ever growing
  unboundedly;
- :meth:`TelemetryHistory.query` merges disk segments with the live
  ring and serves ``GET /metrics/history?series=&window=``, the burn-
  rate alert rules (utils/alerts.py), the status-page sparklines, and
  the flight recorder's "surrounding window" capture.

Samples are wall-clock stamped (``time.time()``) because they must be
comparable across restarts; the monotonic clock resets with the
process.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("timeseries")

#: Series-name paths excluded from flattening: per-rule alert state is
#: bookkeeping about evaluation, not a signal worth a series each, and
#: per-dataset disk byte walks would mint one series per dataset name.
_EXCLUDE_PREFIXES = ("alerts.rules.", "resources.disk.datasets.",
                     "ops.")


def flatten_doc(doc: Dict[str, Any], prefix: str = "",
                out: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Flatten nested numeric leaves of a metrics document into
    ``{"a.b.c": value}`` series samples. Lists (histogram buckets),
    strings and booleans are skipped — series are scalars by
    construction."""
    if out is None:
        out = {}
    for key, val in doc.items():
        name = f"{prefix}{key}"
        if any(name.startswith(p) for p in _EXCLUDE_PREFIXES):
            continue
        if isinstance(val, dict):
            flatten_doc(val, f"{name}.", out)
        elif isinstance(val, (int, float)) and not isinstance(val, bool):
            out[name] = float(val)
    return out


def _encode_segment(samples: List[Tuple[float, Dict[str, float]]]) -> str:
    """Delta-encode one segment: the first record carries the full
    sample (``v``), later records only the keys whose value changed
    (``d``) plus the keys that disappeared (``x``) — counters mostly
    move a few keys per tick, so segments stay small without a binary
    format."""
    lines: List[str] = []
    prev: Optional[Dict[str, float]] = None
    for t, values in samples:
        if prev is None:
            lines.append(json.dumps({"t": round(t, 3), "v": values},
                                    sort_keys=True))
        else:
            delta = {k: v for k, v in values.items() if prev.get(k) != v}
            gone = sorted(k for k in prev if k not in values)
            rec: Dict[str, Any] = {"t": round(t, 3), "d": delta}
            if gone:
                rec["x"] = gone
            lines.append(json.dumps(rec, sort_keys=True))
        prev = values
    return "\n".join(lines) + "\n"


def _decode_segment(text: str) -> List[Tuple[float, Dict[str, float]]]:
    """Inverse of :func:`_encode_segment`. A torn tail line (crash mid
    write) is dropped rather than poisoning the whole segment."""
    out: List[Tuple[float, Dict[str, float]]] = []
    current: Dict[str, float] = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            break                       # torn tail: keep the good prefix
        if "v" in rec:
            current = dict(rec["v"])
        else:
            current = dict(current)
            current.update(rec.get("d") or {})
            for k in rec.get("x") or ():
                current.pop(k, None)
        out.append((float(rec["t"]), current))
    return out


class TelemetryHistory:
    """Bounded metric time-series: in-memory ring + rotating on-disk
    delta segments under ``<store_root>/_telemetry/``.

    ``source`` is the snapshot thunk the background sampler invokes
    (the App's ``_metrics_doc`` — whose body calls :meth:`observe`, so
    thread ticks and operator scrapes feed one gated recording path).
    """

    def __init__(self, cfg: Settings,
                 source: Optional[Callable[[], Any]] = None):
        self.cfg = cfg
        self._source = source
        self._lock = threading.Lock()
        self._ring: "deque[Tuple[float, Dict[str, float]]]" = deque(
            maxlen=max(1, int(cfg.telemetry_ring_samples)))
        #: Samples recorded since the last segment rotation (suffix of
        #: the ring — kept separately so rotation never re-writes what a
        #: previous segment already persisted).
        self._pending: List[Tuple[float, Dict[str, float]]] = []
        self._last_sample: Optional[float] = None
        self._counters = {"samples": 0, "segments_written": 0,
                          "segments_loaded": 0, "sampler_errors": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._segments: List[str] = []
        if self.enabled:
            self._load_segments()

    # -- properties ----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return float(self.cfg.telemetry_sample_s) >= 0

    @property
    def root(self) -> str:
        return os.path.join(self.cfg.store_root, "_telemetry")

    # -- recording -----------------------------------------------------------

    def observe(self, doc: Dict[str, Any],
                now: Optional[float] = None) -> bool:
        """Record one flattened sample of ``doc``, gated to at most one
        per ``telemetry_sample_s`` (0 = every call — how tests drive
        history deterministically). Returns whether a sample landed."""
        if not self.enabled:
            return False
        # Millisecond-rounded at the source so the ring and the disk
        # encoding carry the IDENTICAL timestamp — the window() merge
        # dedupes rotated samples by exact t.
        now = round(time.time() if now is None else now, 3)
        gate = float(self.cfg.telemetry_sample_s)
        with self._lock:
            # Cheap pre-check BEFORE flattening: under frequent
            # scraping nearly every read is gated out, and walking
            # hundreds of doc leaves just to discard the result would
            # tax the scrape path for nothing.
            if (self._last_sample is not None
                    and now - self._last_sample < gate):
                return False
        values = flatten_doc(doc)
        rotate: Optional[List[Tuple[float, Dict[str, float]]]] = None
        with self._lock:
            if (self._last_sample is not None
                    and now - self._last_sample < gate):
                return False              # raced another recorder
            self._last_sample = now
            self._ring.append((now, values))
            self._pending.append((now, values))
            self._counters["samples"] += 1
            if len(self._pending) >= max(
                    1, int(self.cfg.telemetry_segment_samples)):
                rotate, self._pending = self._pending, []
        if rotate:
            self._write_segment(rotate)
        return True

    def flush(self) -> None:
        """Persist the partial pending segment (graceful shutdown — the
        restarted process serves this window from disk)."""
        with self._lock:
            rotate, self._pending = self._pending, []
        if rotate:
            self._write_segment(rotate)

    # -- disk segments -------------------------------------------------------

    def _write_segment(self, samples: List[Tuple[float, Dict[str, float]]]
                       ) -> None:
        try:
            os.makedirs(self.root, exist_ok=True)
            t0 = samples[0][0]
            path = os.path.join(self.root, f"seg-{int(t0 * 1000):015d}.jsonl")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(_encode_segment(samples))
            os.replace(tmp, path)
            with self._lock:
                self._counters["segments_written"] += 1
                self._segments.append(path)
                self._segments.sort()
                doomed = self._segments[:-max(
                    1, int(self.cfg.telemetry_retention_segments))]
                self._segments = self._segments[len(doomed):]
            for old in doomed:
                try:
                    os.unlink(old)
                except OSError:
                    pass
        except OSError as exc:
            # History is best-effort: a full disk must degrade telemetry,
            # never the serving path that happened to trigger a rotation.
            log.warning("telemetry segment write failed: %s", exc)

    def _load_segments(self) -> None:
        """Index existing segments at startup — queries decode them on
        demand, so ``/metrics/history`` serves the pre-restart window
        immediately without reading every file up front."""
        try:
            if not os.path.isdir(self.root):
                return
            self._segments = sorted(
                os.path.join(self.root, fn)
                for fn in os.listdir(self.root)
                if fn.startswith("seg-") and fn.endswith(".jsonl"))
            self._counters["segments_loaded"] = len(self._segments)
        except OSError as exc:
            log.warning("telemetry segment scan failed: %s", exc)

    @staticmethod
    def _segment_t0(path: str) -> float:
        try:
            return int(os.path.basename(path)[4:-6]) / 1000.0
        except ValueError:
            return 0.0

    def _disk_samples(self, since: float, until: float
                      ) -> List[Tuple[float, Dict[str, float]]]:
        out: List[Tuple[float, Dict[str, float]]] = []
        with self._lock:
            segments = list(self._segments)
        starts = [self._segment_t0(p) for p in segments]
        for i, path in enumerate(segments):
            if starts[i] > until:
                continue
            # Segments are chronological: everything in this one
            # precedes the NEXT segment's first sample, so a segment
            # entirely before the window is skipped WITHOUT decoding —
            # the hot paths (burn windows, sparklines, bundles) must
            # not re-parse hours of dead history per call. The newest
            # segment has no upper bound and always decodes.
            if i + 1 < len(segments) and starts[i + 1] <= since:
                continue
            try:
                with open(path, encoding="utf-8") as f:
                    samples = _decode_segment(f.read())
            except OSError:
                continue
            out.extend(s for s in samples if since <= s[0] <= until)
        return out

    # -- queries -------------------------------------------------------------

    def window(self, window_s: Optional[float] = None,
               now: Optional[float] = None
               ) -> List[Tuple[float, Dict[str, float]]]:
        """Samples within the trailing window (disk + ring, start-
        ordered, deduplicated by timestamp — rotated samples exist in
        both)."""
        now = time.time() if now is None else now
        since = now - float(window_s) if window_s else 0.0
        with self._lock:
            ring = [s for s in self._ring if since <= s[0] <= now]
        ring_start = ring[0][0] if ring else now
        disk = self._disk_samples(since, min(now, ring_start))
        seen = {t for t, _ in ring}
        merged = [s for s in disk if s[0] not in seen] + ring
        merged.sort(key=lambda s: s[0])
        return merged

    def query(self, series: Optional[List[str]] = None,
              window_s: Optional[float] = None,
              now: Optional[float] = None) -> Dict[str, Any]:
        """The ``GET /metrics/history`` body: per-series ``[t, value]``
        points. ``series`` entries match exactly or as dotted prefixes
        (``serving`` matches every ``serving.*`` series)."""
        samples = self.window(window_s, now)

        def match(name: str) -> bool:
            if not series:
                return True
            return any(name == s or name.startswith(s.rstrip(".") + ".")
                       for s in series)

        out: Dict[str, List[List[float]]] = {}
        for t, values in samples:
            for name, val in values.items():
                if match(name):
                    out.setdefault(name, []).append([round(t, 3), val])
        return {
            "window_s": window_s,
            "samples": len(samples),
            "from": round(samples[0][0], 3) if samples else None,
            "to": round(samples[-1][0], 3) if samples else None,
            "series": out,
        }

    def series_names(self) -> List[str]:
        with self._lock:
            newest = self._ring[-1][1] if self._ring else {}
        return sorted(newest)

    def snapshot(self) -> Dict[str, Any]:
        """The ``telemetry`` section of ``/metrics``."""
        with self._lock:
            doc = dict(self._counters)
            doc["ring_samples"] = len(self._ring)
            doc["pending_samples"] = len(self._pending)
            doc["segments"] = len(self._segments)
            doc["series"] = len(self._ring[-1][1]) if self._ring else 0
        doc["sample_s"] = float(self.cfg.telemetry_sample_s)
        return doc

    # -- the sampler thread --------------------------------------------------

    def start(self) -> None:
        """Start the background sampler (idempotent; no-op when the
        cadence knob is 0 — read-driven mode — or negative)."""
        if self._source is None or float(self.cfg.telemetry_sample_s) <= 0:
            return
        with self._lock:
            if self._thread is not None:
                return
            # A previous stop() latched the event; a serve→stop→serve
            # cycle must get a live sampler again, not a thread that
            # exits on its first wait.
            self._stop.clear()
            # thread-lifecycle: owner=TelemetryHistory; exits when
            # stop() sets the _stop event (joined there, bounded);
            # daemon so an App that never serves cannot hang interpreter
            # exit behind a sleeping sampler.
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="lo-telemetry")
            self._thread.start()

    def _run(self) -> None:
        period = float(self.cfg.telemetry_sample_s)
        while not self._stop.wait(period):
            try:
                # The source (App._metrics_doc) calls observe() itself —
                # one recording seam whether the tick or a scrape fires.
                self._source()
            except Exception as exc:  # noqa: BLE001 — sampling never kills
                with self._lock:
                    self._counters["sampler_errors"] += 1
                log.warning("telemetry sampler tick failed: %s", exc)

    def stop(self) -> None:
        """Stop the sampler and flush the partial segment so a restart
        serves this window from disk."""
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        if self.enabled:
            self.flush()
