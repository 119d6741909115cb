"""Nothing a run loads may be the JAX stack, the JAX package or the
repository's JAX-era benchmark scripts, compared by whole top-level
name."""

import json
import subprocess
import sys

from portbench import harness

LOADS = """
import json, sys
from pathlib import Path
from portbench import (control, counts, data, devtrace, faults, harness,
                       readers, run)
from portbench.kinds import build, tsne, tune
from portbench.reference import build as rb, linear, trees, tsne as rt
from portbench.reference import tune as rtu
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.models.builder import ModelBuilder
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.viz.service import embed_dataset
from learningorchestra_tpu_torch.utils import tracing
b = harness.load_benchmark(Path.cwd())
for m in b["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted(sys.modules)))
"""


def test_whole_name_comparison():
    assert harness.forbidden_loaded(
        ["learningorchestra_tpu_torch", "learningorchestra_tpu_torch.ops",
         "jaxtyping", "benchmarks_extra", "numpy"]) == []
    assert harness.forbidden_loaded(
        ["jax.numpy", "learningorchestra_tpu.models", "bench",
         "chip_smoke", "flax"]) == ["bench", "chip_smoke", "flax",
                                    "jax.numpy",
                                    "learningorchestra_tpu.models"]


def test_a_run_loads_nothing_forbidden():
    out = subprocess.run([sys.executable, "-c", LOADS],
                         cwd=harness.BENCH_DIR.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "learningorchestra_tpu_torch" in modules
    assert harness.forbidden_loaded(modules) == []
