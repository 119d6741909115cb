"""Cells cut to a size a CPU test run holds, with the benchmark's own
limits."""

import json

from portbench import harness

SIZES = {
    "higgs11m.build_cold": {"data": {"train_rows": 20000, "test_rows": 4000},
                            "traffic": {"warmup_rows": 2000}},
    "higgs11m.tune_rf": {"data": {"train_rows": 6000, "test_rows": 1000},
                         "traffic": {"warmup_rows": 1500}},
    "mnist60k.tsne_image": {"data": {"rows": 500, "features": 64},
                            "traffic": {"warmup_rows": 128}},
}



def spec(workload: str) -> dict:
    root = harness.BENCH_DIR.parent
    s = harness.cell_spec(harness.load_benchmark(root), root, workload)
    s = json.loads(json.dumps(s))
    s["config"]["data"].update(SIZES[workload]["data"])
    s["traffic"].update(SIZES[workload]["traffic"])
    s["seconds"] = SIZES[workload].get("seconds", 0.0)
    return s


def run(workload: str, seed: int = 11) -> dict:
    return harness.run_cell(spec(workload), seed,
                            SIZES[workload].get("seconds", 0.0), False,
                            device="cpu")
