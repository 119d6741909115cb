"""Drive the PyTorch package on one CUDA card and check it end to end.

    python3 chip_smoke.py [--train-rows N]

Phases, one JSON line each (any failure exits non-zero):

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compiles ``learningorchestra_tpu_torch/csrc/tree_kernels.cu``
   and ``csrc/tsne_kernels.cu`` with nvcc for sm_90a, one nvcc per
   source, all started together; each timed, ``fresh`` per source;
3. one line per tree kernel at the HIGGS-sweep shapes (n train rows,
   d=28, 32 bins, depth 5): the kernel against its plain PyTorch version
   on the same inputs (bit-identical for node ids and integer-valued
   histograms; rtol 1e-5 with atol 1e-6·Σ|stats| for float stats, whose
   summation order differs), and their times beside the card's bound;
4. the t-SNE repulsion kernel at the MNIST-60k shape (60,416 rows, 60,000
   valid) against its plain version (Z rtol 1e-4, max|F − F_ref| ≤
   1e-4·max|F_ref|), and its row form over two halves (Z partials sum to
   the whole Z within rtol 1e-5; F halves match the whole F);
5. small-input references: dt and gb fitted on the card and on the CPU
   (the plain versions) from the same data give the same trees; one
   t-SNE step on 2,048 rows agrees (rtol 1e-4, atol 1e-6) and a
   300-iteration embed's KL under exact affinities is within 3% of the
   CPU run's;
6. the sweep: HIGGS-like train/test datasets in the catalog,
   ``ModelBuilder.build`` of all five families (lr, dt, rf, gb, nb) at
   their defaults, then ``ModelBuilder.predict`` with the saved gb model;
   accuracies above the floors, every tree family above lr, and every
   tree kernel launched during the run;
7. the exploration path in the same catalog: projection of the train set
   to 5 fields, its label coerced to string and back (equal to the
   original), histograms equal to ``np.bincount``, a PCA of the 11M × 28
   train set against a float64 numpy PCA (|corr| > 0.9999 per
   component), and a t-SNE of a 60,000 × 784 dataset at the service
   defaults (750 iterations, the repulsion kernel launched once per
   iteration; its 10-NN class agreement above PCA-2's).

Then a ``{"kernels": [...]}`` line and, as the last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: Held-out accuracy floors per family (the HIGGS-like workload's gates).
ACC_FLOOR = {"lr": 0.62, "nb": 0.62, "dt": 0.66, "rf": 0.70, "gb": 0.75}
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
PALLAS = "learningorchestra_tpu/ops/pallas_kernels.py"
TREE_SOURCE = "learningorchestra_tpu_torch/csrc/tree_kernels.cu"
TSNE_SOURCE = "learningorchestra_tpu_torch/csrc/tsne_kernels.cu"
#: kernel → (source in the repo, the TPU kernel it replaces).
KERNELS = {
    "tree_histogram": (TREE_SOURCE, f"{PALLAS}:208"),
    "tree_leaf_stats": (TREE_SOURCE, f"{PALLAS}:299"),
    "tree_route_level": (TREE_SOURCE, f"{PALLAS}:321"),
    "tree_descend": (TREE_SOURCE, f"{PALLAS}:372"),
    "tsne_repulsion": (TSNE_SOURCE, f"{PALLAS}:51"),
}
#: The t-SNE workload: MNIST-60k's shape, padded to whole 1024-row tiles.
TSNE_ROWS, TSNE_DIMS, TSNE_PADDED = 60_000, 784, 60_416
#: Float operations per (row, column) pair of the repulsion kernel
#: (csrc/tsne_kernels.cu: two differences, two FMAs for the distance, the
#: reciprocal, the mask, q², the Z sum and two force FMAs).
TSNE_OPS_PER_PAIR = 14
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


def manifold_mix(n, d, rng, n_cls=10):
    """MNIST-60k stand-in (a copy of benchmarks/bench_scale.py's
    ``_manifold_mix``, which also returns the classes): each class a
    curved 10-D manifold embedded in d dims."""
    t = rng.normal(size=(n, 10)).astype(np.float32)
    cls = rng.integers(0, n_cls, n)
    X = np.zeros((n, d), np.float32)
    for c in range(n_cls):
        m = cls == c
        A = rng.normal(size=(10, d)).astype(np.float32) * 0.8
        B = rng.normal(size=(10, d)).astype(np.float32) * 0.4
        off = rng.normal(size=d).astype(np.float32) * 3.0
        X[m] = t[m] @ A + np.tanh(t[m]) @ B + off
    return X + rng.normal(size=(n, d)).astype(np.float32) * 0.2, cls


def check_tsne_kernel(dev) -> dict:
    """The repulsion kernel against its plain version at the 60k embed's
    shape, whole and as two row halves."""
    import torch

    from learningorchestra_tpu_torch.ops import tsne_kernels as tsk

    n, nv = TSNE_PADDED, TSNE_ROWS
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    # Spread like a late embedding (the explore line's embed_abs_max);
    # padding rows masked.
    Y = torch.randn((n, 2), generator=g, device=dev) * 10.0
    valid = (torch.arange(n, device=dev) < nv).float()
    Z, F = tsk.tsne_repulsion(Y, valid)
    Zr, Fr = tsk.tsne_repulsion_ref(Y, valid)
    f_tol = 1e-4 * float(Fr.abs().max())
    err = float((F - Fr).abs().max())
    check(abs(float(Z) - float(Zr)) <= 1e-4 * abs(float(Zr)),
          f"tsne_repulsion Z {float(Z)} vs plain {float(Zr)}")
    check(err <= f_tol, f"tsne_repulsion F err {err} > {f_tol}")
    h = n // 2
    Z0, F0 = tsk.tsne_repulsion_rows(Y[:h], valid[:h], Y, valid, 0)
    Z1, F1 = tsk.tsne_repulsion_rows(Y[h:], valid[h:], Y, valid, h)
    split_err = float((torch.cat([F0, F1]) - F).abs().max())
    check(abs(float(Z0 + Z1) - float(Z)) <= 1e-5 * abs(float(Z)),
          f"row halves' Z {float(Z0 + Z1)} vs whole {float(Z)}")
    check(split_err <= f_tol, f"row halves' F err {split_err}")
    # Needed bytes: Y and valid read once, F and Z written once. Needed
    # operations: every pair of valid rows.
    b_ms, b_by = bound(20 * n + 4, TSNE_OPS_PER_PAIR * nv * (nv - 1))
    result = {"max_abs_err": err, "ms": time_ms(
        lambda: tsk.tsne_repulsion(Y, valid), 50),
        "plain_ms": time_ms(lambda: tsk.tsne_repulsion_ref(Y, valid), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    emit({"phase": "kernel", "name": "tsne_repulsion", "n": n,
          "n_valid": nv, "Z": float(Z), "Z_plain": float(Zr),
          "f_tol": f_tol, "halves_Z": float(Z0 + Z1),
          "halves_max_abs_err": split_err, **result})
    return result


def exact_joint_P(X, perplexity: float):
    """Exact symmetrized t-SNE affinities in float64 on X's device: full
    pairwise distances and a per-row bisection, as tests/test_viz.py's
    numpy yardstick computes them, all rows at once."""
    import torch

    n = X.shape[0]
    sq = (X * X).sum(1)
    D = (sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)).clamp_min(0.0)
    off = 1.0 - torch.eye(n, dtype=X.dtype, device=X.device)
    D = D * off
    target = float(np.log(perplexity))
    lo = torch.zeros(n, dtype=X.dtype, device=X.device)
    hi = torch.full((n,), float("inf"), dtype=X.dtype, device=X.device)
    beta = torch.ones(n, dtype=X.dtype, device=X.device)
    for _ in range(60):
        w = torch.exp(-D * beta[:, None]) * off
        s = w.sum(1)
        h = torch.log(s) + beta * (D * w).sum(1) / s
        high = h > target
        lo = torch.where(high, beta, lo)
        hi = torch.where(high, hi, beta)
        beta = torch.where(high & torch.isinf(hi), beta * 2.0,
                           (lo + hi) / 2.0)
    P = w / s[:, None]
    return ((P + P.T) / (2.0 * n)).clamp_min(1e-12)


def kl_divergence(P, Y):
    """KL(P || Q) of an embedding under affinities P (float64)."""
    import torch

    Y = Y.to(P)
    sq = (Y * Y).sum(1)
    q = 1.0 / (1.0 + (sq[:, None] + sq[None, :] - 2.0 * (Y @ Y.T))
               .clamp_min(0.0))
    q.fill_diagonal_(0.0)
    Q = (q / q.sum()).clamp_min(1e-12)
    return float((P * (torch.log(P) - torch.log(Q))).sum())


def check_tsne_small_reference(dev) -> None:
    """t-SNE on 2,048 rows on the card (kernel) and on the CPU (plain)."""
    import torch

    from learningorchestra_tpu_torch.config import Settings
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
    from learningorchestra_tpu_torch.viz import tsne as tt

    n = 2048
    X, _ = manifold_mix(n, TSNE_DIMS, np.random.default_rng(1))
    cfg = Settings()
    gpu, cpu = DeviceRuntime(cfg, device=str(dev)), DeviceRuntime(
        cfg, device="cpu")
    # One step from the same state and edge table, built on the CPU from
    # the first 50 columns.
    Xc = torch.from_numpy(X[:, :50].copy())
    d2k, idx = tt._knn(Xc, k=90, tile=1024)
    P = tt._calibrate(d2k, 30.0)
    table = tt._edge_table(idx.numpy(), P.numpy(), n, n)
    rng = np.random.default_rng(2)
    state = [rng.normal(scale=1e-2, size=(n, 2)).astype(np.float32),
             rng.normal(scale=1e-3, size=(n, 2)).astype(np.float32),
             rng.uniform(0.5, 2.0, size=(n, 2)).astype(np.float32)]
    args = [*state, *(a.astype(np.int64) if a.dtype == np.int32 else a
                      for a in table)]
    card, host = ([t.cpu().numpy() for t in tt._step(
        *(rt.replicate(a) for a in args), n, 12.0, 200.0, 0.5)]
        for rt in (gpu, cpu))
    step_diff = {}
    for name, a, b in zip(("Y", "vel", "gains"), card, host):
        step_diff[name] = float(np.abs(a - b).max())
        check(np.allclose(a, b, rtol=1e-4, atol=1e-6),
              f"t-SNE step {name}: card vs CPU max diff {step_diff[name]}")
    kw = dict(iters=300, exaggeration_iters=100)
    emb_g = tt.tsne_embed(gpu, X, **kw)
    emb_c = tt.tsne_embed(cpu, X, **kw)
    check(np.isfinite(emb_g).all() and emb_g.shape == (n, 2),
          "t-SNE on the card: finite, (2048, 2)")
    Pe = exact_joint_P(torch.from_numpy(X).to(dev).double(), 30.0)
    kl_g = kl_divergence(Pe, torch.from_numpy(emb_g))
    kl_c = kl_divergence(Pe, torch.from_numpy(emb_c))
    check(abs(kl_g - kl_c) <= 0.03 * kl_c,
          f"t-SNE KL card {kl_g} vs CPU {kl_c}")
    emit({"phase": "tsne_small_reference", "rows": n,
          "step_max_diff": step_diff, "kl_card": kl_g, "kl_cpu": kl_c})


def knn_class_agreement(emb: np.ndarray, cls: np.ndarray, dev,
                        k: int = 10) -> float:
    """Share of each row's k nearest rows (Euclidean, among the rows
    given) that have its class."""
    import torch

    E = torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(dev)
    d = torch.cdist(E, E)
    d.fill_diagonal_(float("inf"))
    nn = d.topk(k, largest=False).indices.cpu().numpy()
    return float((cls[nn] == cls[:, None]).mean())


def explore_path(store, runtime, dev) -> dict:
    """Projection → coercion → histogram → PCA → t-SNE through the
    package's entry points, in the sweep's catalog. Returns the kernel
    launches of the run."""
    import torch

    from learningorchestra_tpu_torch.ops import tsne_kernels as tsk
    from learningorchestra_tpu_torch.ops.dtypes import convert_fields
    from learningorchestra_tpu_torch.ops.histogram import create_histogram
    from learningorchestra_tpu_torch.ops.preprocess import design_matrix
    from learningorchestra_tpu_torch.ops.projection import create_projection
    from learningorchestra_tpu_torch.utils import tracing
    from learningorchestra_tpu_torch.viz.service import embed_dataset

    Xm, cls = manifold_mix(TSNE_ROWS, TSNE_DIMS, np.random.default_rng(0))
    store.create("mnist_like", columns={
        **{f"p{i}": Xm[:, i] for i in range(TSNE_DIMS)},
        "label": cls.astype(np.int64)}, finished=True)
    del Xm
    train = store.get("train")
    doc = {"phase": "explore"}
    torch.cuda.synchronize()
    tsk.reset_launch_counts()

    fields = ["f10", "f11", "f12", "f13", "label"]
    t0 = time.time()
    create_projection(store, "train", "train_proj", fields)
    doc["projection_s"] = time.time() - t0
    proj = store.get("train_proj")
    check(proj.metadata.finished and proj.metadata.fields == fields
          and proj.metadata.parent == "train", "projection metadata")
    for f in fields:
        check(np.array_equal(proj.columns[f], train.columns[f]),
              f"projected column {f} differs from the parent's")

    t0 = time.time()
    convert_fields(store, "train_proj", {"label": "string"})
    check(proj.columns["label"].dtype == object, "label coerced to string")
    convert_fields(store, "train_proj", {"label": "number"})
    doc["coercion_s"] = time.time() - t0
    back = proj.columns["label"]
    check(back.dtype == np.int64
          and np.array_equal(back, train.columns["label"]),
          "label → string → number is not the original column")

    t0 = time.time()
    create_histogram(store, "train", "hist_train", ["label"])
    create_histogram(store, "pred_gb", "hist_pred", ["label", "prediction"])
    doc["histogram_s"] = time.time() - t0
    for name, parent in (("hist_train", "train"), ("hist_pred", "pred_gb")):
        hist = store.get(name)
        for f, counts in zip(hist.columns["field"], hist.columns["counts"]):
            col = store.get(parent).columns[f]
            want = {int(v): int(c) for v, c in enumerate(np.bincount(col))
                    if c}
            check(counts == want, f"{name} {f}: {counts} != {want}")

    t0 = time.time()
    emb_pca, _ = embed_dataset(store, runtime, "pca", "train", label="label")
    doc["pca_s"] = time.time() - t0
    X, _, _, _ = design_matrix(train, "label")
    X64 = X.astype(np.float64)
    del X
    X64 -= X64.mean(axis=0)
    _, evecs = np.linalg.eigh(X64.T @ X64 / len(X64))
    ref = X64 @ evecs[:, ::-1][:, :2]
    del X64
    corr = [abs(float(np.corrcoef(emb_pca[:, j], ref[:, j])[0, 1]))
            for j in range(2)]
    doc["pca_abs_corr"] = corr
    check(min(corr) > 0.9999, f"PCA vs float64 numpy PCA: |corr| {corr}")
    del emb_pca, ref

    t0 = time.time()
    with tracing.trace("chip_smoke.tsne", sampled=True) as ctx:
        emb, labels = embed_dataset(store, runtime, "tsne", "mnist_like",
                                    label="label")
    doc["embed_s"] = time.time() - t0
    counts = tsk.launch_counts()
    spans = {}
    for sp in tracing.spans_for(ctx.trace_id):
        if sp["name"].startswith("viz."):
            spans[sp["name"]] = (spans.get(sp["name"], 0.0)
                                 + sp["duration_ms"] / 1e3)
    doc["embed_spans_s"] = spans
    check(emb.shape == (TSNE_ROWS, 2) and np.isfinite(emb).all(),
          "t-SNE embedding: finite, (60000, 2)")
    check(counts["tsne_repulsion"] == 750,
          f"repulsion launches {counts} != one per iteration (750)")
    emb_pca2, _ = embed_dataset(store, runtime, "pca", "mnist_like",
                                label="label")
    rows = np.random.default_rng(3).choice(TSNE_ROWS, min(5000, TSNE_ROWS),
                                           replace=False)
    agree = knn_class_agreement(emb[rows], labels[rows], dev)
    agree_pca = knn_class_agreement(emb_pca2[rows], labels[rows], dev)
    check(agree > agree_pca,
          f"t-SNE 10-NN agreement {agree} <= PCA-2's {agree_pca}")
    # The card's machine has no matplotlib or seaborn, so the PNG step of
    # create_embedding_image is checked by the CPU tests; the embed runs
    # here through the service's own embed_dataset.
    emit({**doc, "embed_abs_max": float(np.abs(emb).max()),
          "knn10_agreement": agree, "knn10_agreement_pca2": agree_pca,
          "launches": counts})
    return counts


def main_path(n_train: int, n_test: int, dev) -> dict:
    """The sweep, then the exploration path in the same catalog; each
    path's launch counts are reset just before it and read just after."""
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
        return {**counts, **explore_path(store, runtime, dev)}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def build_all() -> None:
    """Both kernel sources, one nvcc each, started together."""
    from learningorchestra_tpu_torch.ops import tree_kernels as tk
    from learningorchestra_tpu_torch.ops import tsne_kernels as tsk

    def one(mod):
        # A fresh checkout has no library yet, so this is the whole nvcc
        # build; "fresh" says whether it was.
        fresh = not mod.library_path().exists()
        t0 = time.time()
        mod.build()
        return {"source": os.path.relpath(mod.SOURCE, ROOT),
                "seconds": time.time() - t0, "fresh": fresh}

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        builds = list(pool.map(one, (tk, tsk)))
    emit({"phase": "build", "seconds": time.time() - t0,
          "sources": builds})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-rows", type=int, default=11_000_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    dev = torch.device("cuda", 0)
    emit({"phase": "card", "nvidia_smi": card_line(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    build_all()
    results = check_kernels(args.train_rows, TEST_ROWS, dev)
    results["tsne_repulsion"] = check_tsne_kernel(dev)
    torch.cuda.empty_cache()
    check_small_reference(dev)
    check_tsne_small_reference(dev)
    counts = main_path(args.train_rows, TEST_ROWS, dev)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **results[name]}
        for name, (src, rep) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
