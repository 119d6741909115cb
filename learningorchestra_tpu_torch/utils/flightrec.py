"""Flight recorder — bounded post-incident evidence bundles.

When something goes wrong on a live server, the evidence is spread over
volatile surfaces: the trace ring is evicting, the alert engine's state
moves on, the process may be about to die. The flight recorder freezes
that evidence AT the incident: on an alert transitioning to firing, a
``/healthz`` flip to 503, a dispatcher quarantine, or a job the watchdog
expired, it dumps a bundle to ``<store_root>/_flightrec/<bundle-id>/``:

- ``manifest.json`` — reason, detail, wall time, versions (python /
  numpy / torch, its CUDA version and the card's name), the full
  ``Settings`` snapshot, and the alert engine's state at the instant of
  the dump;
- ``spans.json`` — the trace ring's recent spans (the failing request's
  trace included, since the incident just happened);
- ``history.json`` — the surrounding telemetry window
  (``LO_TPU_FLIGHTREC_WINDOW_S`` of utils/timeseries.py series);
- ``resources.json`` — the resource/compile snapshot;
- ``metrics.json`` — the metrics registry document that triggered the
  dump, when the trigger had one in hand.

Retention is bounded (``LO_TPU_FLIGHTREC_KEEP`` newest bundles) and
automatic dumps are rate-limited (``LO_TPU_FLIGHTREC_MIN_INTERVAL_S``)
so a flapping alert records its first transition instead of filling the
disk. ``POST /debug/flightrec`` forces a bundle on demand; ``GET
/debug/flightrec`` lists them. Dumping is best-effort by construction:
a recorder failure logs and returns None — it must never turn an
incident into a second incident.

The module-level :func:`incident` hook lets components that cannot see
the App (the predict batcher's quarantine path, the job watchdog)
trigger the process's recorder.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import re
import shutil
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("flightrec")

_SLUG_RE = re.compile(r"[^a-z0-9._-]+")


def _slug(reason: str) -> str:
    return _SLUG_RE.sub("-", reason.lower()).strip("-")[:48] or "incident"


def _versions() -> Dict[str, Any]:
    doc: Dict[str, Any] = {"python": platform.python_version(),
                           "platform": platform.platform()}
    for mod in ("numpy", "torch"):
        m = sys.modules.get(mod)
        if m is not None:
            doc[mod] = getattr(m, "__version__", "?")
    torch = sys.modules.get("torch")
    if torch is not None:
        # Read only where torch is already loaded: a process without it
        # (a front-end worker) records none of this.
        doc["cuda"] = torch.version.cuda
        doc["device"] = (torch.cuda.get_device_name(0)
                         if torch.cuda.is_available() else "cpu")
    return doc


def _config_doc(cfg: Settings) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if isinstance(val, (str, int, float, bool)) or val is None:
            out[f.name] = val
    return out


def bundle_root(store_root: str) -> str:
    return os.path.join(store_root, "_flightrec")


class FlightRecorder:
    """One server process's recorder. ``gather`` maps artifact names to
    thunks producing their JSON payloads (spans, history, resources,
    alerts) — the App wires these so the recorder never imports the
    serving layer."""

    def __init__(self, cfg: Settings,
                 gather: Optional[Dict[str, Callable[[], Any]]] = None):
        self.cfg = cfg
        self.gather = dict(gather or {})
        self._lock = threading.Lock()
        self._last_auto: Optional[float] = None
        self._seq = 0
        self._counters = {"dumped": 0, "suppressed": 0, "errors": 0,
                          "pruned": 0}
        #: Staging dirs of dumps currently being written: two triggers
        #: can dump concurrently (the batcher's quarantine incident and
        #: the alert engine's firing transition race on real servers),
        #: and the completing dump's prune must sweep only ORPHANED
        #: ``.tmp-`` debris, never a live sibling's staging dir.
        self._inflight: set = set()

    @property
    def root(self) -> str:
        return bundle_root(self.cfg.store_root)

    @property
    def enabled(self) -> bool:
        return int(self.cfg.flightrec_keep) > 0

    # -- dumping -------------------------------------------------------------

    def dump(self, reason: str, detail: Any = None,
             doc: Optional[Dict[str, Any]] = None,
             force: bool = False) -> Optional[str]:
        """Write one bundle; returns its id, or None when disabled,
        rate-limited (automatic triggers only), or failed. Never
        raises."""
        if not self.enabled:
            return None
        now = time.time()
        with self._lock:
            if not force and self._last_auto is not None and (
                    now - self._last_auto
                    < float(self.cfg.flightrec_min_interval_s)):
                self._counters["suppressed"] += 1
                return None
            if not force:
                self._last_auto = now
            self._seq += 1
            seq = self._seq
        bundle_id = (time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
                     + f"-{seq:03d}-{_slug(reason)}")
        with self._lock:
            self._inflight.add(f".tmp-{bundle_id}")
        try:
            return self._write(bundle_id, reason, detail, doc, now)
        except Exception as exc:  # noqa: BLE001 — never a second incident
            with self._lock:
                self._counters["errors"] += 1
            log.error("flight-recorder dump failed (%s): %s", reason, exc)
            return None
        finally:
            with self._lock:
                self._inflight.discard(f".tmp-{bundle_id}")

    def _write(self, bundle_id: str, reason: str, detail: Any,
               doc: Optional[Dict[str, Any]], now: float) -> str:
        tmp = os.path.join(self.root, f".tmp-{bundle_id}")
        final = os.path.join(self.root, bundle_id)
        os.makedirs(tmp, exist_ok=True)
        manifest: Dict[str, Any] = {
            "bundle": bundle_id,
            "reason": reason,
            "detail": detail,
            "at": round(now, 3),
            "at_iso": time.strftime("%Y-%m-%dT%H:%M:%S",
                                    time.localtime(now)),
            "versions": _versions(),
            "config": _config_doc(self.cfg),
        }
        artifacts = {"manifest.json": manifest}
        if doc is not None:
            artifacts["metrics.json"] = doc
        for name, thunk in self.gather.items():
            try:
                artifacts[f"{name}.json"] = thunk()
            except Exception as exc:  # noqa: BLE001 — partial bundles win
                artifacts[f"{name}.json"] = {"error": str(exc)}
        for fname, payload in artifacts.items():
            with open(os.path.join(tmp, fname), "w",
                      encoding="utf-8") as f:
                json.dump(payload, f, indent=1, default=str)
        # Staged rename: a bundle either exists completely or not at all
        # (a crash mid-dump leaves only a .tmp- dir the next prune
        # sweeps away).
        os.replace(tmp, final)
        with self._lock:
            self._counters["dumped"] += 1
        log.warning("flight-recorder bundle %s dumped (%s)",
                    bundle_id, reason)
        self._prune()
        return bundle_id

    def _prune(self) -> None:
        try:
            entries = sorted(
                e for e in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, e)))
        except OSError:
            return
        keep = max(1, int(self.cfg.flightrec_keep))
        with self._lock:
            inflight = set(self._inflight)
        stale = [e for e in entries
                 if e.startswith(".tmp-") and e not in inflight]
        live = [e for e in entries if not e.startswith(".tmp-")]
        doomed = stale + live[:-keep] if len(live) > keep else stale
        for e in doomed:
            shutil.rmtree(os.path.join(self.root, e), ignore_errors=True)
        if doomed:
            with self._lock:
                self._counters["pruned"] += len(doomed)

    # -- views ---------------------------------------------------------------

    def list(self) -> List[Dict[str, Any]]:
        """Bundle summaries, newest first — the ``GET /debug/flightrec``
        body and the client's ``flight_recordings()``."""
        out: List[Dict[str, Any]] = []
        try:
            entries = sorted(os.listdir(self.root), reverse=True)
        except OSError:
            return out
        for e in entries:
            path = os.path.join(self.root, e)
            if e.startswith(".tmp-") or not os.path.isdir(path):
                continue
            summary: Dict[str, Any] = {"bundle": e, "path": path}
            try:
                with open(os.path.join(path, "manifest.json"),
                          encoding="utf-8") as f:
                    man = json.load(f)
                summary.update({k: man.get(k) for k in
                                ("reason", "at", "at_iso", "detail")})
                summary["files"] = sorted(os.listdir(path))
            except (OSError, ValueError):
                summary["error"] = "unreadable manifest"
            out.append(summary)
        return out

    def _bundle_ids(self) -> List[str]:
        """Bundle ids, newest first (no manifest reads — ids sort by
        their timestamp prefix)."""
        try:
            return sorted(
                (e for e in os.listdir(self.root)
                 if not e.startswith(".tmp-")
                 and os.path.isdir(os.path.join(self.root, e))),
                reverse=True)
        except OSError:
            return []

    def latest(self) -> Optional[str]:
        """Freshest bundle id (the one client error messages quote)."""
        ids = self._bundle_ids()
        return ids[0] if ids else None

    def snapshot(self) -> Dict[str, Any]:
        """The ``flightrec`` section of ``/metrics`` — cheap by design
        (one directory listing, no manifest reads: it runs per
        scrape)."""
        with self._lock:
            doc: Dict[str, Any] = dict(self._counters)
        ids = self._bundle_ids()
        doc["bundles"] = len(ids)
        doc["latest"] = ids[0] if ids else None
        return doc


# -- process-global incident hook ---------------------------------------------

#: The serving process's recorder (set by App). Components below the
#: serving layer (the predict batcher's quarantine path) report
#: incidents through :func:`incident` without importing the App.
_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def set_recorder(rec: Optional[FlightRecorder]) -> None:
    global _recorder
    with _recorder_lock:
        _recorder = rec


def incident(reason: str, detail: Any = None) -> Optional[str]:
    """Trigger the process recorder (no-op without one). Best-effort
    like every recorder path — callers never guard it."""
    with _recorder_lock:
        rec = _recorder
    if rec is None:
        return None
    return rec.dump(reason, detail=detail)



def dump_minimal(store_root: str, reason: str,
                 detail: Any = None, keep: int = 8) -> Optional[str]:
    """A manifest-only bundle for processes without a recorder (the
    supervisor observing a child death): reason + detail + versions,
    same bundle layout and retention, no in-process telemetry to
    capture."""
    cfg = Settings()
    cfg.store_root = store_root
    cfg.flightrec_keep = keep
    cfg.flightrec_min_interval_s = 0.0
    return FlightRecorder(cfg).dump(reason, detail=detail, force=True)
