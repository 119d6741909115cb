"""The forest's tree batches, on the CPU.

dt/rf fits and the tune's dt/rf populations grow each
``_forest_batch_shape`` batch of trees in one ``_build_trees`` call, the
batch's trees its slices, as the JAX package's vmapped ``_fit_forest``
runs each ``pallas_call`` once a level for a batch. Every tree must be
the one a one-tree-a-call build gives it: the reference is the same fit
with its batch width set to 1 (``chip_smoke.one_tree_a_call``, which
the card's check uses too), so it grows one ``_build_trees`` call a
tree (G = 1), drawing from the generators in the serial order.
Tolerances:

- every tree param (``feat``, ``thr``, ``internal``, ``leaf``)
  ``torch.equal`` to the reference's: the stats are small integers,
  whose sums are exact in any order, and each slice's arithmetic does
  not depend on the others;
- with the JAX package's draws injected, bit-identical to JAX's
  ``_fit_forest`` (test_torch_models.py's standard), a short last batch
  included;
- a fit crashed at its second batch boundary resumes to the reference's
  bits; on two gloo ranks the batched forest is each rank's
  one-tree-a-call forest;
- a population member's trees are its serial fit's, node for node up to
  its own depth and zero past it; a population whose batch holds more
  trees than ``tune_max_population`` grows it in calls of at most that
  many slices, to the bits of one call a batch.

The pod's ranks import this module, so JAX is imported inside the tests
only.
"""

import importlib.util
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models import trees, tune
from learningorchestra_tpu_torch.parallel import spmd
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import failpoints, fitckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TREE_KEYS = ("feat", "thr", "internal", "leaf")
DEPTH, BINS = 3, 16
#: n_trees → the batch widths ``_forest_batch_shape`` gives it: one tree;
#: one batch of 5 and of 7; 11 as a batch of 8 and a short one of 3; 20
#: as 4 × 5.
BATCHES = {1: [1], 5: [5], 7: [7], 11: [8, 3], 20: [5, 5, 5, 5]}
SPAWN_TIMEOUT_S = 120.0


def _blobs(n, d=6, classes=2, seed=0, sep=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * sep
    y = rng.integers(0, classes, size=n)
    X = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return X, y.astype(np.int32)


def _one_tree_a_call(fit, *args, **kw):
    """``fit``'s trees grown one ``_build_trees`` call a tree."""
    with chip_smoke.one_tree_a_call(), chip_smoke.build_slices() as calls:
        params = fit(*args, **kw).params
    assert set(calls) == {1}, calls
    return params


def _assert_trees_equal(params, ref, what):
    for k in TREE_KEYS:
        assert torch.equal(params[k], ref[k]), f"{what}: {k} differs"


@pytest.fixture
def trt():
    return DeviceRuntime(Settings(), device="cpu")


@pytest.fixture
def build_calls():
    """The slice count of every ``_build_trees`` call in the test."""
    with chip_smoke.build_slices() as calls:
        yield calls


@pytest.mark.parametrize("n_trees", sorted(BATCHES))
def test_batched_forest_is_one_tree_a_call(trt, build_calls, n_trees):
    X, y = _blobs(700, classes=3, seed=n_trees)
    fit = trees.fit_dt if n_trees == 1 else trees.fit_rf
    kw = {} if n_trees == 1 else {"n_trees": n_trees, "seed": 4}
    m = fit(trt, X, y, 3, max_depth=DEPTH, n_bins=BINS, **kw)
    assert build_calls == BATCHES[n_trees]
    ref = _one_tree_a_call(fit, trt, X, y, 3, max_depth=DEPTH,
                           n_bins=BINS, **kw)
    _assert_trees_equal(m.params, ref, f"{n_trees} trees")


@pytest.mark.parametrize("n_trees", [5, 11])
def test_batched_forest_with_jax_draws_is_jax_forest(trt, n_trees):
    """Injected draws: the batches (one of 5; 8 and a short 3, where JAX
    pads its second batch to 8 trees) give JAX's trees."""
    from learningorchestra_tpu.config import Settings as JaxSettings
    from learningorchestra_tpu.models import trees as jtrees
    from learningorchestra_tpu.parallel.mesh import DATA_AXIS, MeshRuntime
    from test_torch_models import _jax_forest_draws

    jrt = MeshRuntime(JaxSettings())
    n, d = 803, 6
    X, y = _blobs(n, d=d, seed=7)
    jm = jtrees.fit_rf(jrt, X, y, 2, n_trees=n_trees, max_depth=DEPTH,
                       n_bins=BINS, seed=9)
    w, a = _jax_forest_draws(9, n, d, n_trees, max(1, int(np.sqrt(d))),
                             jrt.mesh.shape[DATA_AXIS])
    tm = trees.fit_rf(trt, X, y, 2, n_trees=n_trees, max_depth=DEPTH,
                      n_bins=BINS, weights=w, feature_allowed=a)
    for k in TREE_KEYS:
        np.testing.assert_array_equal(tm.params[k].numpy(),
                                      np.asarray(jm.params[k]), err_msg=k)


def test_crash_at_second_batch_resumes_to_one_tree_a_call(tmp_path,
                                                         build_calls):
    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    cfg.persist = True
    cfg.fit_ckpt_rounds = 1
    rt = DeviceRuntime(cfg, device="cpu")
    X, y = _blobs(500, seed=2)
    ctx = fitckpt.context(cfg, dataset="d", family="rf",
                          config={"v": 1}, snapshot="s")
    failpoints.configure("fit.ckpt.pre_rename=raise:2")
    try:
        with pytest.raises(failpoints.FailpointError):
            trees.fit_rf(rt, X, y, 2, n_trees=20, max_depth=DEPTH,
                         n_bins=BINS, seed=1, ckpt=ctx)
    finally:
        failpoints.reset()
    assert ctx.load()[0] == 5
    build_calls.clear()
    resumed = trees.fit_rf(rt, X, y, 2, n_trees=20, max_depth=DEPTH,
                           n_bins=BINS, seed=1, ckpt=ctx)
    assert build_calls == [5, 5, 5]
    ref = _one_tree_a_call(trees.fit_rf, rt, X, y, 2, n_trees=20,
                           max_depth=DEPTH, n_bins=BINS, seed=1)
    _assert_trees_equal(resumed.params, ref, "resumed")


# -- two gloo ranks ---------------------------------------------------------

POD_N, POD_TREES = 1001, (1, 7, 11)


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        X, y = _blobs(POD_N, d=8, seed=3)
        rt = DeviceRuntime(Settings(), device="cpu")
        out = {}
        with spmd.mesh_scope():
            for n_trees in POD_TREES:
                fit = trees.fit_dt if n_trees == 1 else trees.fit_rf
                kw = {} if n_trees == 1 else {"n_trees": n_trees, "seed": 3}
                m = fit(rt, X, y, 2, max_depth=DEPTH, n_bins=BINS, **kw)
                ref = _one_tree_a_call(fit, rt, X, y, 2, max_depth=DEPTH,
                                       n_bins=BINS, **kw)
                for k in TREE_KEYS:
                    out[f"{n_trees}.{k}"] = m.params[k].numpy()
                    out[f"{n_trees}.{k}.ref"] = ref[k].numpy()
        np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_batch_as_one_tree_a_call(tmp_path):
    world = 2
    ctx = mp.start_processes(_rank, args=(world, str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"the {world} ranks did not finish within "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    outs = []
    for r in range(world):
        with np.load(os.path.join(tmp_path, f"out{r}.npz")) as f:
            outs.append(dict(f))
    for n_trees in POD_TREES:
        for k in TREE_KEYS:
            for r, out in enumerate(outs):
                np.testing.assert_array_equal(
                    out[f"{n_trees}.{k}"], out[f"{n_trees}.{k}.ref"],
                    err_msg=f"rank {r}, {n_trees} trees, {k}")
            # The histograms are all-reduced: every rank grows the same
            # trees.
            np.testing.assert_array_equal(outs[0][f"{n_trees}.{k}"],
                                          outs[1][f"{n_trees}.{k}"])


# -- tune populations ---------------------------------------------------------

POP_CASES = [
    ("dt", [{"max_depth": 2, "n_bins": 8}, {"max_depth": 3, "n_bins": 16}]),
    ("rf", [{"n_trees": 11, "max_depth": 3, "n_bins": 16, "seed": 2},
            {"n_trees": 11, "max_depth": 2, "n_bins": 8, "mtry": 4}]),
    ("rf", [{"n_trees": 5, "max_depth": 3, "n_bins": 16},
            {"n_trees": 5, "max_depth": 3, "n_bins": 16, "seed": 5},
            {"n_trees": 5, "max_depth": 2, "n_bins": 16, "mtry": 1}]),
]


@pytest.mark.parametrize("family,configs", POP_CASES,
                         ids=["dt", "rf11", "rf5"])
def test_population_batch_gives_each_member_its_serial_trees(
        trt, build_calls, family, configs):
    X, y = _blobs(600, seed=5)
    fold_ids, tr, ev = tune._fold_masks(len(X), len(X), 1)
    nc = len(configs)
    driver = tune._make_driver(family, trt, X, y, 2, configs, fold_ids,
                               np.tile(tr, (nc, 1)), np.tile(ev, (nc, 1)),
                               cfg=Settings())
    driver.run_segment(driver.total_units())
    n_trees = driver.n_trees
    # One call a batch, its slices every member's trees of the batch.
    assert build_calls == [nc * t for t in BATCHES[n_trees]]
    for ci, c in enumerate(configs):
        depth, n_bins = c["max_depth"], c["n_bins"]
        M = 2 ** (depth + 1) - 1
        if family == "dt":
            serial = trees.fit_dt(trt, X, y, 2, max_depth=depth,
                                  n_bins=n_bins).params
        else:
            serial = trees.fit_rf(trt, X, y, 2, n_trees=n_trees,
                                  max_depth=depth, n_bins=n_bins,
                                  mtry=c.get("mtry"),
                                  seed=c.get("seed", 0)).params
        for k in TREE_KEYS:
            got = driver.t[k][ci]
            assert torch.equal(got[:, :M], serial[k]), (c, k)
            assert not got[:, M:].any(), (c, k)


def test_population_calls_hold_at_most_max_population_slices(
        trt, build_calls):
    """64 members of 20-tree rf (batches of 5: 320 trees a batch) grow
    in calls of at most ``tune_max_population`` (64) slices, 12 members
    a call, and every member's trees are those of one call a batch."""
    X, y = _blobs(300, seed=6)
    fold_ids, tr, ev = tune._fold_masks(len(X), len(X), 1)
    configs = [{"n_trees": 20, "max_depth": 1 + i % 2, "n_bins": 8,
                "seed": i} for i in range(64)]
    cfg = Settings()
    assert cfg.tune_max_population == 64

    def grown(cfg):
        driver = tune._make_driver("rf", trt, X, y, 2, configs, fold_ids,
                                   np.tile(tr, (64, 1)),
                                   np.tile(ev, (64, 1)), cfg=cfg)
        driver.run_segment(driver.total_units())
        return driver.t

    capped = grown(cfg)
    assert build_calls == ([60] * 5 + [20]) * 4
    build_calls.clear()
    whole = grown(cfg.replace(tune_max_population=320))
    assert build_calls == [320] * 4
    for k in TREE_KEYS:
        assert torch.equal(capped[k], whole[k]), k
    # Through the sweep, at the default cap: 21 configs × 3 folds a
    # wave, no call past 64 slices.
    build_calls.clear()
    tune.sweep(trt, X, y, 2, "rf", configs[:21], cfg=cfg, folds=3,
               rungs=1)
    assert build_calls and max(build_calls) <= 64, build_calls
    assert build_calls[:6] == [60] * 5 + [15]


def test_per_member_bytes_count_a_tree_batch():
    """A dt/rf member's row state counts once a tree of its batch: dt's
    batch is its one tree, an rf of n_trees grows
    ``_forest_batch_shape(n_trees)[0]`` at once."""
    n, d = 100_000, 28
    dt = tune._per_member_bytes("dt", n, d, 2, 1)
    one = tune._per_member_bytes("rf", n, d, 2, n_trees=1)
    assert dt == one
    fixed = 8.0 * n + 2.0 * n * d                 # masks and codes
    for n_trees in (5, 7, 11, 20):
        tb = trees._forest_batch_shape(n_trees)[0]
        got = tune._per_member_bytes("rf", n, d, 2, n_trees=n_trees)
        assert got - fixed == pytest.approx(tb * (one - fixed))
    # A budget for three members of 20-tree rf: the 20-tree configs need
    # more waves than one-tree ones.
    cfg = Settings()
    cfg.tune_hbm_budget_mb = int(3 * tune._per_member_bytes(
        "rf", n, d, 2, n_trees=20) / (1 << 20)) + 1
    waves = tune.plan_waves("rf", [{"n_trees": 20}] * 6, n=n, d=d,
                            num_classes=2, folds=1, cfg=cfg)
    assert [len(w) for w in waves] == [3, 3]
    waves = tune.plan_waves("rf", [{"n_trees": 1}] * 6, n=n, d=d,
                            num_classes=2, folds=1, cfg=cfg)
    assert [len(w) for w in waves] == [6]
