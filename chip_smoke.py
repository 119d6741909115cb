"""Drive the PyTorch package on one CUDA card and check it end to end.

    python3 chip_smoke.py [--train-rows N]

Phases, one JSON line each (any failure exits non-zero):

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compiles ``learningorchestra_tpu_torch/csrc/tree_kernels.cu``
   with nvcc for sm_90a, timed;
3. one line per tree kernel at the HIGGS-sweep shapes (n train rows,
   d=28, 32 bins, depth 5): the kernel against its plain PyTorch version
   on the same inputs (bit-identical for node ids and integer-valued
   histograms; rtol 1e-5 with atol 1e-6·Σ|stats| for float stats, whose
   summation order differs), and their times beside the card's bound;
4. small-input reference: dt and gb fitted on the card and on the CPU
   (the plain versions) from the same data give the same trees;
5. the main path: HIGGS-like train/test datasets in the catalog,
   ``ModelBuilder.build`` of all five families (lr, dt, rf, gb, nb) at
   their defaults, then ``ModelBuilder.predict`` with the saved gb model;
   accuracies above the floors, every tree family above lr, and every
   kernel launched during the run.

Then a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and
as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

#: Held-out accuracy floors per family (the HIGGS-like workload's gates).
ACC_FLOOR = {"lr": 0.62, "nb": 0.62, "dt": 0.66, "rf": 0.70, "gb": 0.75}
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
PALLAS = "learningorchestra_tpu/ops/pallas_kernels.py"
SOURCE = "learningorchestra_tpu_torch/csrc/tree_kernels.cu"
REPLACES = {
    "tree_histogram": f"{PALLAS}:208",
    "tree_leaf_stats": f"{PALLAS}:299",
    "tree_route_level": f"{PALLAS}:321",
    "tree_descend": f"{PALLAS}:372",
}
ROOT = os.path.dirname(os.path.abspath(__file__))
#: Held-out rows of the HIGGS-like sweep.
TEST_ROWS = 100_000


def check(ok, what) -> None:
    """A failed check ends the run (unlike ``assert``, kept under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(doc) -> None:
    print(json.dumps(doc), flush=True)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / FP32_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check_kernels(n: int, n_test: int, dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    d, nb, depth, S = 28, 32, 5, 2
    NL, M = 2 ** (depth - 1), 2 ** (depth + 1) - 1
    codes = torch.randint(0, nb, (n, d), generator=g, device=dev,
                          dtype=torch.uint8)
    rel = torch.randint(0, NL, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    active = torch.rand((n,), generator=g, device=dev) < 0.9
    rel = torch.where(active, rel, torch.zeros_like(rel))
    counts = torch.poisson(torch.ones((S, n), device=dev), generator=g)
    grads = torch.randn((S, n), generator=g, device=dev)
    assign = torch.randint(0, M, (n,), generator=g, device=dev,
                           dtype=torch.int32)
    results = {}

    def record(name, err, ms, plain_ms, nbytes, ops, library_ms, exact):
        b_ms, b_by = bound(nbytes, ops)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": library_ms}
        emit({"phase": "kernel", "name": name, "exact": exact,
              **results[name]})

    # K1, histogram form: integer-valued stats must match exactly; float
    # stats to rtol 1e-5 + atol 1e-6·Σ|stats| (summation order).
    kw = dict(n_nodes=NL, n_bins=nb)
    h_int = tk.tree_histogram(codes, counts, rel, active, **kw)
    r_int = tk.tree_histogram_ref(codes, counts, rel, active, **kw)
    check(torch.equal(h_int, r_int), "tree_histogram: integer stats differ")
    h = tk.tree_histogram(codes, grads, rel, active, **kw)
    r = tk.tree_histogram_ref(codes, grads, rel, active, **kw)
    atol = 1e-6 * float(grads.abs().sum())
    err = float((h - r).abs().max())
    check(torch.allclose(h, r, rtol=1e-5, atol=atol),
          f"tree_histogram: float stats err {err} > atol {atol}")
    key = (rel.long()[:, None] * (d * nb)
           + torch.arange(d, device=dev) * nb + codes.long())[active]
    src = grads.T[active][:, None, :].expand(-1, d, S).reshape(-1, S)
    flat_key = key.reshape(-1)
    lib_out = torch.zeros((NL * d * nb, S), device=dev)
    n_act = int(active.sum())
    record("tree_histogram", err,
           time_ms(lambda: tk.tree_histogram(codes, grads, rel, active, **kw),
                   10),
           time_ms(lambda: tk.tree_histogram_ref(codes, grads, rel, active,
                                                 **kw), 2),
           # Flags and node ids of every row; codes and stats of the
           # active rows; the histogram written once.
           n + 4 * n + n_act * (d + 4 * S) + 4 * NL * d * nb * S,
           n_act * d * S,
           time_ms(lambda: lib_out.index_add_(0, flat_key, src), 5), True)

    # K1, leaf form.
    l_int = tk.tree_leaf_stats(assign, counts, n_nodes=M)
    check(torch.equal(l_int, tk.tree_leaf_stats_ref(assign, counts,
                                                    n_nodes=M)),
          "tree_leaf_stats: integer stats differ")
    lk = tk.tree_leaf_stats(assign, grads, n_nodes=M)
    lr_ = tk.tree_leaf_stats_ref(assign, grads, n_nodes=M)
    err = float((lk - lr_).abs().max())
    check(torch.allclose(lk, lr_, rtol=1e-5, atol=atol),
          f"tree_leaf_stats: err {err}")
    leaf_out = torch.zeros((M, S), device=dev)
    along = assign.long()
    gT = grads.T
    record("tree_leaf_stats", err,
           time_ms(lambda: tk.tree_leaf_stats(assign, grads, n_nodes=M), 10),
           time_ms(lambda: tk.tree_leaf_stats_ref(assign, grads, n_nodes=M),
                   3),
           4 * n + 4 * S * n + 4 * M * S, n * S,
           time_ms(lambda: leaf_out.index_add_(0, along, gT), 5), True)

    # K2: routing at the deepest level's width.
    best_f = torch.randint(0, d, (NL,), generator=g, device=dev,
                           dtype=torch.int32)
    best_t = torch.randint(0, nb, (NL,), generator=g, device=dev,
                           dtype=torch.int32)
    split = torch.rand((NL,), generator=g, device=dev) < 0.7
    base = torch.full((n,), NL - 1, dtype=torch.int32, device=dev) + rel
    args = (codes, rel, active, base, best_f, best_t, split)
    out = tk.tree_route_level(*args)
    ref = tk.tree_route_level_ref(*args)
    check(torch.equal(out, ref), "tree_route_level differs")
    # Needed bytes: flags, node ids, ids in and out for every row, and one
    # code byte for each row that moves to a child.
    moved = int((active & split[rel.long()]).sum())
    record("tree_route_level", float((out - ref).abs().max()),
           time_ms(lambda: tk.tree_route_level(*args), 20),
           time_ms(lambda: tk.tree_route_level_ref(*args), 3),
           n + 3 * 4 * n + moved + 4 * 3 * NL, 0, None, True)

    # K3: a random full tree; one tree over the train rows (the gb fit's
    # per-round descent) and a 20-tree forest over the test rows (a
    # forest predict's single launch).
    feat = torch.randint(0, d, (20, M), generator=g, device=dev,
                         dtype=torch.int32)
    thr = torch.randint(0, nb, (20, M), generator=g, device=dev,
                        dtype=torch.int32)
    internal = torch.rand((20, M), generator=g, device=dev) < 0.8
    # A root that is a leaf would stop every row at once.
    internal[:, 0] = True
    one = (codes, feat[0], thr[0], internal[0])
    out = tk.tree_descend(*one, max_depth=depth)
    ref = tk.tree_descend_ref(*one, max_depth=depth)
    check(torch.equal(out, ref), "tree_descend differs (one tree)")
    test_codes = codes[:n_test]
    out_f = tk.tree_descend(test_codes, feat, thr, internal, max_depth=depth)
    ref_f = tk.tree_descend_ref(test_codes, feat, thr, internal,
                                max_depth=depth)
    check(torch.equal(out_f, ref_f), "tree_descend differs (forest)")
    # Needed bytes: one code byte per internal node a row passes through,
    # the table, and the leaf ids written.
    visits, a = 0, torch.zeros((n,), dtype=torch.long, device=dev)
    for _ in range(depth):
        go = internal[0].long()[a] != 0
        visits += int(go.sum())
        v = codes.gather(1, feat[0].long()[a][:, None])[:, 0]
        a = torch.where(go, 2 * a + 1 + (v > thr[0][a]).long(), a)
    record("tree_descend", float((out - ref).abs().max()),
           time_ms(lambda: tk.tree_descend(*one, max_depth=depth), 20),
           time_ms(lambda: tk.tree_descend_ref(*one, max_depth=depth), 3),
           visits + 4 * 3 * M + 4 * n, 0, None, True)
    return results


def check_small_reference(dev) -> None:
    """dt and gb fitted on the card and on the CPU from the same data."""
    import torch

    from benchmarks.workload import higgs_like_xy
    from learningorchestra_tpu_torch.config import Settings
    from learningorchestra_tpu_torch.models import trees
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

    X, y = higgs_like_xy(200_000, 3)
    cfg = Settings()
    gpu, cpu = DeviceRuntime(cfg, device=str(dev)), DeviceRuntime(
        cfg, device="cpu")
    dt_g = trees.fit_dt(gpu, X, y, 2)
    dt_c = trees.fit_dt(cpu, X, y, 2)
    for k in ("feat", "thr", "internal", "leaf"):
        check(torch.equal(dt_g.params[k].cpu(), dt_c.params[k]),
              f"dt {k} differs between the card and the CPU")
    gb_g = trees.fit_gb(gpu, X, y, 2, n_rounds=5)
    gb_c = trees.fit_gb(cpu, X, y, 2, n_rounds=5)
    Xt, _ = higgs_like_xy(20_000, 4)
    p_g = gb_g.predict_proba(gpu, Xt)
    p_c = gb_c.predict_proba(cpu, Xt)
    agree = float((p_g.argmax(1) == p_c.argmax(1)).mean())
    check(np.isfinite(p_g).all() and p_g.shape == (20_000, 2),
          "gb probabilities on the card: finite, (20000, 2)")
    check(agree >= 0.99, f"gb card/CPU class agreement {agree}")
    emit({"phase": "small_reference", "dt_trees_identical": True,
          "gb_class_agreement": agree,
          "gb_max_prob_diff": float(np.abs(p_g - p_c).max())})


def main_path(n_train: int, n_test: int, dev) -> dict:
    import torch

    from benchmarks.workload import higgs_like_columns
    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.config import Settings
    from learningorchestra_tpu_torch.models.builder import ModelBuilder
    from learningorchestra_tpu_torch.ops import tree_kernels as tk
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
    from learningorchestra_tpu_torch.utils import tracing

    work = os.path.join(ROOT, "build", "chip_smoke_store")
    shutil.rmtree(work, ignore_errors=True)
    cfg = Settings()
    cfg.store_root = os.path.join(work, "store")
    try:
        t0 = time.time()
        store = DatasetStore(cfg)
        store.create("train", columns=higgs_like_columns(n_train, 0),
                     finished=True)
        store.create("test", columns=higgs_like_columns(n_test, 1),
                     finished=True)
        emit({"phase": "datasets", "train_rows": n_train,
              "test_rows": n_test, "seconds": time.time() - t0})
        runtime = DeviceRuntime(cfg, device=str(dev))
        mb = ModelBuilder(store, runtime, cfg)
        families = ["lr", "dt", "rf", "gb", "nb"]
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        t0 = time.time()
        with tracing.trace("chip_smoke.build", sampled=True) as ctx:
            reports = mb.build("train", "test", "pred", families, "label")
        build_s = time.time() - t0
        spans = {}
        for sp in tracing.spans_for(ctx.trace_id):
            spans[sp["name"]] = (spans.get(sp["name"], 0.0)
                                 + sp["duration_ms"] / 1e3)
        build_counts = tk.launch_counts()
        t0 = time.time()
        mb.predict("pred_gb", "test", "pred_gb_again")
        torch.cuda.synchronize()
        predict_s = time.time() - t0
        counts = tk.launch_counts()
        acc = {}
        for r in reports:
            check("error" not in r.metrics, f"{r.kind} failed: {r.metrics}")
            doc = store.get(f"pred_{r.kind}").metadata.to_doc()
            check(doc["finished"] and not doc.get("error"), doc)
            for k in ("f1", "accuracy", "fit_time", "device_s"):
                check(k in doc, f"{r.kind} dataset lacks {k}")
            acc[r.kind] = r.metrics["accuracy"]
            emit({"phase": "fit", "family": r.kind,
                  "fit_time": r.fit_time,
                  "device_s": r.metrics["device_s"],
                  "accuracy": r.metrics["accuracy"], "f1": r.metrics["f1"]})
        for kind, floor in ACC_FLOOR.items():
            check(acc[kind] > floor, f"{kind} accuracy {acc[kind]} <= {floor}")
        for kind in ("dt", "rf", "gb"):
            check(acc[kind] > acc["lr"], f"{kind} does not beat lr: {acc}")
        again = store.get("pred_gb_again")
        check(again.metadata.finished and again.num_rows == n_test,
              "predict dataset finished with every test row")
        probs = np.array(list(again.columns["probability"]), np.float64)
        check(probs.shape == (n_test, 2) and np.isfinite(probs).all(),
              "predict probabilities finite, (n_test, 2)")
        check(np.allclose(probs.sum(1), 1.0, atol=1e-5),
              "predict probabilities sum to 1")
        for name, c in counts.items():
            check(c > 0, f"kernel {name} was not launched on the main path")
        emit({"phase": "main_path", "build_s": build_s,
              "predict_s": predict_s, "spans_s": spans,
              "launches_build": build_counts, "launches_total": counts,
              "peak_device_bytes": torch.cuda.max_memory_allocated(dev)})
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-rows", type=int, default=11_000_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    dev = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    # A fresh checkout has no library yet, so this is the whole nvcc build;
    # "fresh" says whether it was.
    fresh = not tk.library_path().exists()
    t0 = time.time()
    tk.build()
    emit({"phase": "build", "seconds": time.time() - t0, "fresh": fresh})
    results = check_kernels(args.train_rows, TEST_ROWS, dev)
    torch.cuda.empty_cache()
    check_small_reference(dev)
    counts = main_path(args.train_rows, TEST_ROWS, dev)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": counts[name],
         **results[name]} for name in tk.KERNELS]})
    # The card's name and power limit, as nvidia-smi prints them.
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
