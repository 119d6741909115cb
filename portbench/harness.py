"""The general harness: it finds a cell's configuration, traffic mix,
kind module and metric readers by the names in ``BENCHMARK.json``, runs
set-up, the measured window and the correctness check, and assembles
the result line.

A cell is one entry of ``workloads``. Its configuration is the JSON file
the ``configs`` entry names; its traffic mix is
``portbench/traffic/<traffic>.json``, whose ``kind`` names the module
under ``portbench/kinds/`` that runs it; each per-layer metric is read
by ``portbench/metrics/<name>.py``. A later cell, mix or metric is new
files and new entries, never an edit here.

A kind module has four functions:

- ``setup(run)``: make the data from the seed, start the program, warm
  up every shape the window uses;
- ``window(run)``: run the measured window; returns the end-to-end
  values by metric name, and the counts ``attempted`` and ``failed``;
- ``release(run)``: free the program's state once the window has closed
  and the memory peak has been read;
- ``judge(run)``: the numbers compared with the plain reference, each
  as ``(name, value, limit)``; the run is correct when every value is at
  most its limit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent

#: Top-level module names that no process of the benchmark may load: the
#: JAX stack, the JAX package the port was made from, and the
#: repository's JAX-era benchmark scripts.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "learningorchestra_tpu",
                     "benchmarks", "bench", "bench_serving", "chip_smoke")


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_spec(bench: dict, root: Path, workload: str) -> dict:
    """The cell's entry with its configuration, traffic mix and the
    metrics it reports, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload named {workload!r}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return {"cell": cell, "config": config, "traffic": traffic,
            "seconds": bench["run_seconds"],
            "end_to_end": [m for m in bench["end_to_end"]
                           if applies(m, workload)],
            "per_layer": [m for m in bench["per_layer"]
                          if applies(m, workload)]}


def reader(name: str) -> Callable:
    """The ``read(run)`` function of per-layer metric ``name``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """One run of one cell: what its kind module makes and what the readers
    read."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.spec = spec
        self.cell = spec["cell"]
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        #: The checkout the run started in.
        self.root = BENCH_DIR.parent
        self.work = Path(tempfile.mkdtemp(prefix="portbench-"))
        # The program's default roots, for code that reads the global
        # settings: the run's own directory, and no dataset persisted.
        os.environ["LO_TPU_STORE_ROOT"] = str(self.work / "store")
        os.environ["LO_TPU_IMAGE_ROOT"] = str(self.work / "images")
        os.environ["LO_TPU_PERSIST"] = "0"
        #: Steps of the window: (wall start, wall end, trace id or None).
        self.steps: List[tuple] = []
        self.values: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.state: Dict = {}
        self.kernel_work = None
        self.device_trace = None
        self.trace_summary: Dict = {}
        self.spans: List[dict] = []
        self.window_wall = (0.0, 0.0)

    @property
    def on_card(self) -> bool:
        return self.device.startswith("cuda")

    def sync(self) -> None:
        if self.on_card:
            import torch

            torch.cuda.synchronize()

    def step(self, label: str, fn: Callable) -> None:
        """One step of the window, in a sampled trace of its own when the
        run is traced, so the program's spans record under it."""
        t0 = time.time()
        if self.trace:
            from learningorchestra_tpu_torch.utils import tracing

            with tracing.trace(f"portbench.{label}", sampled=True) as ctx:
                fn()
            tid = ctx.trace_id
        else:
            fn()
            tid = None
        self.steps.append((t0, time.time(), tid))

    def closed_loop(self, label: str, fn: Callable) -> tuple:
        """Whole steps one after another until the deadline; the step
        running at the deadline finishes and counts. Returns (seconds,
        steps)."""
        t0 = time.monotonic()
        deadline = t0 + self.seconds
        n = 0
        while True:
            self.step(label, fn)
            n += 1
            if time.monotonic() >= deadline:
                break
        return time.monotonic() - t0, n

    def settings(self):
        """The program's settings for this run: its catalog and images in
        the run's own directory, datasets never persisted."""
        from learningorchestra_tpu_torch.config import Settings

        cfg = Settings()
        cfg.store_root = str(self.work / "store")
        cfg.image_root = str(self.work / "images")
        cfg.persist = False
        return cfg

    def step_seconds(self) -> List[float]:
        return [b - a for a, b, _ in self.steps]

    def span_seconds(self, name: str) -> Optional[float]:
        """Summed seconds of the program's spans called ``name`` over the
        window's steps, or None when none was recorded."""
        durs = [sp["duration_ms"] / 1e3 for sp in self.spans
                if sp["name"] == name]
        return sum(durs) if durs else None


def _device_doc(run: Run, chips: int) -> dict:
    if not run.on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """Set-up, window, release and judgement of one run; returns the
    result document (without printing it)."""
    t_start = time.monotonic() if t_start is None else t_start
    run = Run(spec, seed, seconds, trace, device, t_start)
    kind = importlib.import_module(
        f"portbench.kinds.{spec['traffic']['kind']}")
    try:
        kind.setup(run)
        run.sync()
        setup_s = time.monotonic() - t_start
        if trace:
            _start_trace(run)
        w0 = time.time()
        out = kind.window(run)
        run.sync()
        run.window_wall = (w0, time.time())
        if trace:
            _stop_trace(run)
        run.values.update(out)
        run.values["setup_s"] = setup_s
        device_doc = _device_doc(run, int(spec["cell"]["chips"]))
        metrics = _metrics(run)
        kind.release(run)
        t_judge = time.monotonic()
        checks = kind.judge(run)
        print(f"portbench: judged in {time.monotonic() - t_judge:.1f} s",
              file=sys.stderr)
    finally:
        shutil.rmtree(run.work, ignore_errors=True)
    correct = (run.failed == 0
               and all(v <= lim for _, v, lim in checks))
    if trace:
        device_doc["busy_s"] = run.trace_summary.get("busy_s", 0.0)
        device_doc["window_s"] = run.trace_summary.get(
            "window_s", run.window_wall[1] - run.window_wall[0])
    doc = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device_doc}
    if trace and run.trace_summary:
        doc["breakdown"] = {
            "device_ops": run.trace_summary["device_ops"],
            "idle_gaps": run.trace_summary["idle_gaps"]}
    doc["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return doc


def _start_trace(run: Run) -> None:
    from learningorchestra_tpu_torch.utils import tracing

    from portbench import devtrace

    # Every span of the window is kept, however many steps it holds.
    tracing.set_capacity(1 << 22)
    if run.on_card:
        run.kernel_work = devtrace.KernelWork()
        run.kernel_work.install()
        run.device_trace = devtrace.DeviceTrace()
        run.device_trace.start()


def _stop_trace(run: Run) -> None:
    from learningorchestra_tpu_torch.utils import tracing

    from portbench import devtrace

    if run.device_trace is not None:
        run.device_trace.stop()
        run.kernel_work.uninstall()
    w0, w1 = run.window_wall
    run.spans = [sp for sp in tracing.recent_span_docs()
                 if w0 <= sp["start"] <= w1]
    if run.device_trace is not None:
        import learningorchestra_tpu_torch

        pkg = Path(learningorchestra_tpu_torch.__file__).resolve().parent
        run.trace_summary = run.device_trace.summary(
            run.window_wall, run.spans, devtrace.port_kernel_names(pkg))


def _metrics(run: Run) -> dict:
    out = {}
    entries = run.spec["per_layer"] if run.trace else run.spec["end_to_end"]
    for m in entries:
        if run.trace:
            value = reader(m["name"])(run)
        else:
            value = run.values.get(m["name"])
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def emit(doc: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in doc["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(doc), flush=True)
