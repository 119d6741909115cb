"""Resource accounting — the capacity leg of the observability plane.

The tracing plane answers *where time went*; this module answers *what
resources a job consumed* and *how much headroom the host has*. It is
the one sampling seam every surface reads from:

- **Device memory**: per-device ``torch.cuda.memory_stats`` on a card
  (``allocated_bytes.all.current`` / ``.peak``, with ``bytes_limit`` the
  card's memory). Without a card (the CPU test rig)
  the number is the bytes of the live tensors that
  ``parallel/runtime.DeviceRuntime`` placed — so ``source`` in the
  snapshot says which number you are reading (``memory_stats`` or
  ``live_buffers``).
- **Host**: RSS/VMS from ``/proc/self/statm``, open-fd and thread counts
  from ``/proc/self`` — the signals that catch fd leaks and host-RAM
  creep before the OOM killer does.
- **Disk**: filesystem totals via ``shutil.disk_usage(store_root)`` plus
  a per-dataset byte breakdown of the chunk store (TTL-cached — walking
  a terabyte store per scrape would be its own regression).
- **Compile time**: PyTorch compiles nothing behind the caller's back,
  so ``compile_s`` / ``compiles`` count the package's two real compile
  steps: the kernels' ``nvcc`` builds (ops/_cuda_build.py; a library
  found already built counts as a ``persistent_cache_hits``) and the
  warm-up of each online model's bucket ladder (models/aot.py, one
  compile per warmed bucket). Cache *hits* are counted at the seams
  that know them: the AOT model cache and device phases that complete
  without a single new compile.

Job watermarks: :func:`job_phase` (wrapped around every managed job's
body by jobs.JobManager) and :func:`family_phase` / the ``device_span``
hook (models/builder.py, utils/profiling.py) sample compile-seconds,
RSS, and device bytes around compute phases and merge them into the
current job's profile — ``peak_hbm_bytes`` (max), ``compile_s`` (the
job window's compile total), ``host_rss_delta``, and per-family
``fit_resources`` on sweeps.

Counters are process-global (one server process = one metrics surface,
the OpTimer convention); concurrent jobs' compile windows overlap, so a
job's ``compile_s`` reads "compile seconds this process spent during the
job's window" — exact when jobs serialize, an honest upper bound when
they overlap.

This module imports no torch at import time: front-end worker processes
load the serving modules without it.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

from learningorchestra_tpu_torch.config import (
    Settings, settings as global_settings)
from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("resources")

_lock = threading.Lock()

# -- compile accounting -------------------------------------------------------

#: Cumulative compile counters: misses (real compiles — nvcc builds and
#: warmed buckets) with their seconds, fed by :func:`note_compile`, and
#: the hits the cache seams report.
_compile = {"compiles": 0, "compile_s": 0.0, "cache_hits": 0,
            "persistent_cache_hits": 0}


def note_compile(seconds: float, n: int = 1) -> None:
    """Count ``n`` real compiles that took ``seconds`` of wall time in
    all: an ``nvcc`` build of a kernel library, or the warm-up of an
    online model's bucket ladder (``n`` = buckets × replicas)."""
    with _lock:
        _compile["compiles"] += int(n)
        _compile["compile_s"] += float(seconds)


def note_persistent_hit() -> None:
    """A kernel library found already built on disk (no ``nvcc`` run)."""
    with _lock:
        _compile["persistent_cache_hits"] += 1


def compile_seconds() -> float:
    with _lock:
        return _compile["compile_s"]


def note_cache_hit(n: int = 1) -> None:
    """Count a cache hit observed at a seam that knows one: an online
    model served from the AOT cache, or a device phase that completed
    without a single new compile."""
    with _lock:
        _compile["cache_hits"] += int(n)


def compile_snapshot() -> Dict[str, Any]:
    """The ``compile`` section of ``/metrics``: real compiles (= cache
    misses), their cumulative seconds, and cache hits."""
    with _lock:
        out = dict(_compile)
    out["compile_s"] = round(out["compile_s"], 6)
    out["cache_misses"] = out["compiles"]
    return out


# -- host (/proc/self) --------------------------------------------------------

def host_rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            parts = f.read().split()
        return int(parts[1]) * (os.sysconf("SC_PAGE_SIZE")
                                if hasattr(os, "sysconf") else 4096)
    except (OSError, IndexError, ValueError):
        return 0


def host_snapshot() -> Dict[str, Any]:
    """RSS/VMS, open fds, thread count from ``/proc/self`` (zeros on
    platforms without procfs — keys stay present so dashboards never
    branch)."""
    rss = vms = 0
    try:
        page = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
        with open("/proc/self/statm") as f:
            parts = f.read().split()
        vms, rss = int(parts[0]) * page, int(parts[1]) * page
    except (OSError, IndexError, ValueError):
        pass
    try:
        open_fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        open_fds = 0
    return {"rss_bytes": rss, "vms_bytes": vms, "open_fds": open_fds,
            "threads": threading.active_count()}


# -- device memory ------------------------------------------------------------

def device_snapshot() -> Dict[str, Any]:
    """Per-device memory accounting. ``source`` says where the numbers
    came from: ``memory_stats`` (the CUDA caching allocator's counters,
    with true peaks) or ``live_buffers`` (bytes of the live tensors the
    runtime placed — the CPU rig's reading, attributed to the host)."""
    try:
        import torch

        from learningorchestra_tpu_torch.parallel import runtime
    except Exception as exc:  # noqa: BLE001 — a host without torch
        return {"devices": [], "source": "unavailable", "error": str(exc),
                "total_bytes_in_use": 0, "peak_bytes_in_use": None}
    if torch.cuda.is_available():
        docs, total, peak_total = [], 0, 0
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            cur = int(stats.get("allocated_bytes.all.current", 0))
            peak = int(stats.get("allocated_bytes.all.peak", cur))
            props = torch.cuda.get_device_properties(i)
            docs.append({"id": f"cuda:{i}", "platform": "gpu",
                         "name": props.name, "bytes_in_use": cur,
                         "peak_bytes_in_use": peak,
                         "bytes_limit": int(props.total_memory)})
            total += cur
            peak_total += peak
        return {"devices": docs, "source": "memory_stats",
                "total_bytes_in_use": total, "peak_bytes_in_use": peak_total}
    total = runtime.placed_bytes()
    return {"devices": [{"id": "cpu", "platform": "cpu",
                         "bytes_in_use": total}],
            "source": "live_buffers",
            "total_bytes_in_use": total, "peak_bytes_in_use": None}


def hbm_bytes_in_use() -> int:
    """One number for watermark sampling: CURRENT device bytes in use
    (summed across devices; live placed bytes without a card).
    Deliberately not the allocator's peak — that peak is process-lifetime
    (and resetting it would clobber the concurrent family threads'
    readings), so sampling it would stamp every job after the hungriest
    one with the hungriest one's footprint. Per-job peaks come from
    max-merging this current reading at each device phase end, when the
    phase's tensors are still live."""
    snap = device_snapshot()
    return int(snap.get("total_bytes_in_use") or 0)


# -- disk (chunk store) -------------------------------------------------------

#: Disk-walk TTL cache: (root) -> (expires_monotonic, doc). Walking the
#: store per scrape is O(store size); 5 s staleness is invisible to a
#: 15 s alert window.
_DISK_TTL_S = 5.0
_disk_cache: Dict[str, tuple] = {}


def disk_snapshot(cfg: Optional[Settings] = None,
                  ttl_s: float = _DISK_TTL_S) -> Dict[str, Any]:
    """Filesystem totals for the chunk-store root plus per-dataset byte
    usage (top-level directories under ``store_root``, including
    ``_models``). ``free_bytes`` is what the disk-headroom alert and
    ``/healthz`` judge against."""
    cfg = cfg or global_settings
    root = cfg.store_root
    now = time.monotonic()
    with _lock:
        hit = _disk_cache.get(root)
        if hit is not None and hit[0] > now:
            return dict(hit[1])
    doc: Dict[str, Any] = {"root": root}
    try:
        usage = shutil.disk_usage(root if os.path.isdir(root) else
                                  os.path.dirname(root) or "/")
        doc.update(total_bytes=usage.total, free_bytes=usage.free,
                   used_bytes=usage.used)
    except OSError as exc:
        doc.update(total_bytes=0, free_bytes=0, used_bytes=0,
                   error=str(exc))
    datasets: Dict[str, int] = {}
    store_bytes = 0
    if os.path.isdir(root):
        for entry in sorted(os.listdir(root)):
            path = os.path.join(root, entry)
            if not os.path.isdir(path):
                try:
                    store_bytes += os.path.getsize(path)
                except OSError:
                    pass
                continue
            size = 0
            for dirpath, _dirs, files in os.walk(path):
                for fname in files:
                    try:
                        size += os.path.getsize(
                            os.path.join(dirpath, fname))
                    except OSError:
                        pass
            datasets[entry] = size
            store_bytes += size
    doc["store_bytes"] = store_bytes
    doc["datasets"] = datasets
    with _lock:
        _disk_cache[root] = (now + max(0.0, ttl_s), dict(doc))
    return doc


# -- full snapshots -----------------------------------------------------------

def process_snapshot(cfg: Optional[Settings] = None,
                     lite: bool = False) -> Dict[str, Any]:
    """Everything ``GET /resources`` serves for this process. ``lite``
    drops the per-dataset disk walk — the form workers ship over the
    SPMD job channel and ``/cluster`` displays per process."""
    from learningorchestra_tpu_torch import config

    doc: Dict[str, Any] = {
        "process": config.process_id() or 0,
        "host": host_snapshot(),
        "devices": device_snapshot(),
        "compile": compile_snapshot(),
    }
    if not lite:
        doc["disk"] = disk_snapshot(cfg)
    return doc


#: Last-known snapshots of OTHER pod processes, keyed by pod rank —
#: shipped over the SPMD job channel (hello handshake + per-job span
#: shipments) so ``GET /cluster`` compares the whole pod at a glance.
_remote: Dict[int, Dict[str, Any]] = {}


def note_remote(process: Any, doc: Any) -> None:
    """Record a worker process's shipped resource snapshot (coordinator
    side of the job channel). Malformed shipments are dropped — the
    channel peer is trusted code, but a half-dead worker must never
    corrupt the pod view."""
    if not isinstance(doc, dict):
        return
    try:
        idx = int(process)
    except (TypeError, ValueError):
        return
    with _lock:
        _remote[idx] = {"at": time.time(), **doc}


def remote_snapshots() -> Dict[int, Dict[str, Any]]:
    with _lock:
        return {k: dict(v) for k, v in _remote.items()}


# -- phase sampling (the seam jobs/builder/profiling hook into) ---------------

#: Per-family watermark table accumulated across sweeps — read by
#: callers that build outside a managed job.
_families: Dict[str, Dict[str, Any]] = {}


def family_watermarks() -> Dict[str, Dict[str, Any]]:
    with _lock:
        return {k: dict(v) for k, v in _families.items()}


def _merge_family(family: str, compile_s: float, peak_hbm: int) -> None:
    with _lock:
        ent = _families.setdefault(
            family, {"compile_s": 0.0, "peak_hbm_bytes": 0, "phases": 0})
        ent["compile_s"] = round(ent["compile_s"] + compile_s, 6)
        ent["peak_hbm_bytes"] = max(ent["peak_hbm_bytes"], int(peak_hbm))
        ent["phases"] += 1


def observe_device_phase(name: Optional[str],
                         compile_delta_s: Optional[float],
                         peak_hbm: int) -> None:
    """Merge one device phase's watermarks into the module table and the
    current job's profile. ``name`` follows the span taxonomy —
    ``fit.<family>.device`` attributes the phase to its family.
    ``compile_delta_s`` None means the phase's compile window OVERLAPPED
    another phase's (the process-global counter can't attribute the
    seconds to one family) — the peak still merges, compile attribution
    is skipped rather than double-counted."""
    from learningorchestra_tpu_torch import jobs

    family = None
    if name:
        parts = name.split(".")
        if len(parts) >= 2 and parts[0] == "fit":
            family = parts[1]
    if compile_delta_s is not None and compile_delta_s <= 0.0:
        note_cache_hit()        # warm phase: it compiled nothing
    if family is not None:
        _merge_family(family, compile_delta_s or 0.0, peak_hbm)
        stats = {"peak_hbm_bytes": int(peak_hbm)}
        if compile_delta_s is not None:
            stats["compile_s"] = round(compile_delta_s, 6)
        jobs.record_job_watermarks(family=family, family_stats=stats)
    jobs.record_job_watermarks(peak_hbm_bytes=peak_hbm)


#: Currently-open device-phase tokens and the subset that overlapped
#: another phase at any point of their window. Compile seconds are a
#: process-global counter, so only a phase that was the SOLE open window
#: for its whole duration can attribute its delta to one family — a
#: pipelined sweep's concurrent phases record peaks only.
_open_phases: set = set()
_overlapped_phases: set = set()


@contextmanager
def device_phase(name: Optional[str]):
    """The one device-phase sampling window, shared by ``family_phase``
    and ``profiling.device_span``: compile-seconds delta (None when the
    window overlapped another phase — attribution would double-count)
    and a current-device-bytes sample at exit, merged via
    :func:`observe_device_phase`. Exception-transparent — a failing
    phase still records what it consumed before dying."""
    token = object()
    with _lock:
        if _open_phases:
            _overlapped_phases.update(_open_phases)
            _overlapped_phases.add(token)
        _open_phases.add(token)
    c0 = compile_seconds()
    try:
        yield
    finally:
        delta = compile_seconds() - c0
        with _lock:
            _open_phases.discard(token)
            overlapped = token in _overlapped_phases
            _overlapped_phases.discard(token)
        try:
            observe_device_phase(name, None if overlapped else delta,
                                 hbm_bytes_in_use())
        except Exception:  # noqa: BLE001 — sampling must never fail a fit
            pass


def family_phase(family: str):
    """Wrap one classifier family's dispatch region (models/builder.py);
    see :func:`device_phase` for the attribution rules."""
    return device_phase(f"fit.{family}.device")


@contextmanager
def job_phase():
    """Wrap a managed job's whole body (jobs.JobManager): at exit, the
    job's profile carries ``peak_hbm_bytes`` (max of the end sample and
    whatever device phases recorded mid-job), ``compile_s`` (the job
    window's process compile total), and ``host_rss_delta``."""
    from learningorchestra_tpu_torch import jobs

    c0 = compile_seconds()
    rss0 = host_rss_bytes()
    jobs.record_job_watermarks(peak_hbm_bytes=hbm_bytes_in_use())
    try:
        yield
    finally:
        jobs.record_job_watermarks(
            peak_hbm_bytes=hbm_bytes_in_use(),
            compile_s=compile_seconds() - c0,
            host_rss_delta=host_rss_bytes() - rss0)


# -- on-demand device profile (POST /debug/profile) ---------------------------

#: Hard cap on one capture — /debug/profile is an operator tool, not a
#: way to leave the profiler running forever.
PROFILE_MAX_SECONDS = 60.0


class ProfilerBusy(RuntimeError):
    """Another profiler trace is running in this process (PyTorch runs
    one at a time); ``POST /debug/profile`` answers it 409."""


def profiler_busy() -> bool:
    from learningorchestra_tpu_torch.utils import profiling

    return profiling._trace_lock.locked()


def capture_profile(out_dir: str, seconds: float) -> str:
    """Capture a ``torch.profiler`` trace of this process — CPU
    operators and, on a card, its kernels — for ``seconds`` into
    ``out_dir/trace.json`` (Chrome trace format). Raises
    :class:`ProfilerBusy` when another trace (``profile_dir`` jobs or a
    second capture) holds the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from learningorchestra_tpu_torch.utils import profiling

    seconds = min(max(0.0, float(seconds)), PROFILE_MAX_SECONDS)
    os.makedirs(out_dir, exist_ok=True)
    if not profiling._trace_lock.acquire(blocking=False):
        raise ProfilerBusy("a profiler trace is already running in this "
                           "process; retry when it ends")
    try:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            time.sleep(seconds)
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
    finally:
        profiling._trace_lock.release()
    log.info("device profile captured: %s (%.1fs)", path, seconds)
    return out_dir

