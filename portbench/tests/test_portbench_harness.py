"""The harness finds every configuration, traffic mix, kind module and metric
reader by the names in BENCHMARK.json, and the file keeps to the
contract's shape."""

import importlib
import json
import re
import subprocess
import sys

from portbench import harness

ROOT = harness.BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return harness.load_benchmark(ROOT)


def test_every_cell_finds_its_files_and_readers():
    b = bench()
    for w in b["workloads"]:
        spec = harness.cell_spec(b, ROOT, w["name"])
        assert spec["config"]["name"] == w["config"]
        importlib.import_module(
            f"portbench.kinds.{spec['traffic']['kind']}")
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert callable(harness.reader(m["name"]))
            assert m["moves"] in e2e


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    metrics = b["end_to_end"] + b["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["name"] == c["name"]
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert all(w["chips"] == 1 for w in b["workloads"])
    assert len(json.dumps(b)) < 64 * 1024


def test_unknown_workload_is_refused():
    try:
        harness.cell_spec(bench(), ROOT, "no.such_cell")
    except SystemExit as exc:
        assert "no.such_cell" in str(exc)
    else:
        raise AssertionError("an unknown workload ran")


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "higgs11m.build_cold", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""
