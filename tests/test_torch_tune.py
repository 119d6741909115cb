"""The PyTorch package's hyperparameter search against its own serial fits
and against the JAX package's ``tune.sweep``, on the CPU.

Same numpy inputs (made from a seed) into both packages; the JAX side on
the 8-device CPU mesh of tests/conftest.py (its population programs run
the XLA oracle, no Pallas kernel), the PyTorch side on ``device="cpu"``
with the kernels' plain versions (the slice forms' plain versions loop
the one-slice plain functions). Tolerances:

- the port's population against the port's serial fits (folds=1, one
  rung: each config's fold score is its serial fit's self-accuracy):
  exact for dt, rf, lr (adam and newton) and mlp; gb within 0.02, the
  JAX package's standard for its own gb population;
- the port's leaderboard against JAX ``tune.sweep``: dt fold scores
  equal; rf equal when the port is fed the JAX package's bootstrap and
  feature draws; lr-newton within 0.01 a score; lr-adam and mlp (whose
  initial weights come from each package's own generator) within 0.03 a
  winner's score, and the same winner;
- halving, resume and the REST surface as the JAX package's tests hold
  them (tests/test_tune.py).
"""

import json

import numpy as np
import pytest
import torch

from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.models import trees as jtrees
from learningorchestra_tpu.models import tune as jtune
from learningorchestra_tpu.parallel.mesh import DATA_AXIS, MeshRuntime
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models import trees, tune
from learningorchestra_tpu_torch.models.registry import get_trainer
from learningorchestra_tpu_torch.ops import tree_kernels as tk
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import failpoints, fitckpt
from tests.test_torch_models import _jax_forest_draws


@pytest.fixture(scope="module")
def trt():
    return DeviceRuntime(Settings(), device="cpu")


@pytest.fixture(scope="module")
def jrt():
    return MeshRuntime(JaxSettings())


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    yield
    failpoints.reset()


def _blobs(n=240, d=6, classes=2, seed=0, sep=2.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * sep
    y = rng.integers(0, classes, size=n)
    X = centers[y] + rng.normal(size=(n, d))
    return X.astype(np.float32), y.astype(np.int32)


def _serial_score(runtime, family, config, X, y, num_classes):
    """One standalone fit + self-accuracy — what the sweep's folds=1
    fold (-1: train AND score every row) must reproduce."""
    trainer = get_trainer(family)
    prep = getattr(trainer, "host_prep", None)
    extra = prep(X, **config) if prep is not None else {}
    model = trainer(runtime, X, y, num_classes, **dict(config, **extra))
    preds = np.argmax(model.predict_proba(runtime, X), axis=1)
    return round(float((preds == y).mean()), 6)


def _by_config(board, config):
    for r in board["results"]:
        if r["config"] == config:
            return r
    raise AssertionError(f"config {config} missing from board")


def _mk_cfg(tmp_path=None, **knobs):
    cfg = Settings()
    if tmp_path is not None:
        cfg.store_root = str(tmp_path / "store")
        cfg.persist = True
    for k, v in knobs.items():
        setattr(cfg, k, v)
    return cfg


# -- unit layer ---------------------------------------------------------------

@pytest.mark.parametrize("n,padded,folds", [(10, 16, 3), (5, 8, 1),
                                            (300, 300, 4), (1000, 1024, 7),
                                            (64, 70, 64)])
def test_fold_masks_are_the_jax_masks(n, padded, folds):
    fids, tr, ev = tune._fold_masks(n, padded, folds)
    jf, jtr, jev = jtune._fold_masks(n, padded, folds)
    assert fids == jf
    for got, want in ((tr, jtr), (ev, jev)):
        # Byte for byte: the same shape, dtype and bits (no -0.0).
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
    valid = (np.arange(padded) < n).astype(np.float32)
    if folds > 1:
        # Each fold's train/eval split partitions the valid rows, and the
        # eval folds partition them across folds.
        np.testing.assert_array_equal(tr + ev, np.tile(valid, (folds, 1)))
        np.testing.assert_array_equal(ev.sum(axis=0), valid)
    else:
        np.testing.assert_array_equal(tr[0], valid)
        np.testing.assert_array_equal(ev[0], valid)


@pytest.mark.parametrize("family,configs,msg", [
    ("nb", [{}], "no population tune path"),
    ("dt", [], "non-empty list"),
    ("dt", [{"bogus": 1}], "bogus"),
    ("dt", [{"n_bins": 500}], "n_bins"),
    ("rf", [{"n_trees": 4}, {"n_trees": 8}], "share n_trees"),
    ("lr", [{"solver": "newton"}, {"solver": "adam"}], "one solver"),
    ("mlp", [{"hidden": 0}], "hidden"),
])
def test_validate_population_rejections(family, configs, msg):
    with pytest.raises(ValueError, match=msg):
        tune.validate_population(family, configs)


def test_validate_population_gb_binary_only():
    with pytest.raises(ValueError, match="binary"):
        tune.validate_population("gb", [{"n_rounds": 4}], num_classes=3)
    tune.validate_population("gb", [{"n_rounds": 4}], num_classes=2)


def test_plan_waves_budget_spill_covers_every_config_once():
    # A 1 MiB budget against a million-row design forces width 1: five
    # sequential waves, each config exactly once, spill counter bumped.
    before = tune.counters_snapshot()["hbm_spill_waves"]
    cfg = _mk_cfg(tune_hbm_budget_mb=1)
    cfgs = [{"max_depth": k} for k in range(2, 7)]
    waves = tune.plan_waves("dt", cfgs, n=1_000_000, d=8, num_classes=2,
                            folds=1, cfg=cfg)
    assert len(waves) > 1
    flat = [i for w in waves for i in w]
    assert sorted(flat) == list(range(5)) == flat
    assert tune.counters_snapshot()["hbm_spill_waves"] > before


@pytest.mark.parametrize("family", ["dt", "rf", "gb", "lr", "mlp"])
def test_plan_waves_budget_fits_the_modeled_members(family):
    """Each wave's modeled footprint (members × per-member bytes) stays
    within the budget, and one more config would not have fitted."""
    n, d, folds = 200_000, 28, 3
    per = tune._per_member_bytes(family, n, d, 2,
                                 tune.forest_size(family, [{}])) * folds
    cfg = _mk_cfg(tune_hbm_budget_mb=int(5.5 * per / (1 << 20)) + 1)
    waves = tune.plan_waves(family, [{} for _ in range(12)], n=n, d=d,
                            num_classes=2, folds=folds, cfg=cfg)
    width = len(waves[0])
    budget = cfg.tune_hbm_budget_mb * (1 << 20)
    assert width * per <= budget < (width + 1) * per
    assert sum(len(w) for w in waves) == 12


def test_plan_waves_population_cap_divides_by_folds():
    # cap = max_population // folds: 4 // 2 -> waves of two configs.
    cfg = _mk_cfg(tune_max_population=4)
    waves = tune.plan_waves("lr", [{} for _ in range(5)], n=100, d=4,
                            num_classes=2, folds=2, cfg=cfg)
    assert [len(w) for w in waves] == [2, 2, 1]
    jwaves = jtune.plan_waves("lr", [{} for _ in range(5)], n=100, d=4,
                              num_classes=2, folds=2,
                              cfg=JaxSettings(tune_max_population=4))
    assert waves == jwaves
    # Budget 0 with a roomy cap: a single wave.
    waves = tune.plan_waves("lr", [{} for _ in range(5)], n=100, d=4,
                            num_classes=2, folds=2, cfg=_mk_cfg())
    assert [len(w) for w in waves] == [5]


def test_config_knobs_are_the_jax_packages():
    cfg, jcfg = Settings(), JaxSettings()
    for k in ("tune_rungs", "tune_folds", "tune_hbm_budget_mb",
              "tune_max_population"):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    assert (cfg.tune_rungs, cfg.tune_folds, cfg.tune_hbm_budget_mb,
            cfg.tune_max_population) == (3, 3, 0, 64)


# -- the slice-axis kernels' plain versions -----------------------------------

def _slice_inputs(G=5, P=2, n=700, d=6, nb=16, depth=4, seed=0):
    rng = np.random.default_rng(seed)
    NL, M = 2 ** (depth - 1), 2 ** (depth + 1) - 1
    codes = torch.from_numpy(rng.integers(0, nb, (P, n, d)).astype(np.uint8))
    idx = [int(i) for i in rng.integers(0, P, G)]
    stats = torch.from_numpy(rng.normal(size=(G, 2, n)).astype(np.float32))
    rel = torch.from_numpy(rng.integers(0, NL, (G, n)).astype(np.int32))
    active = torch.from_numpy(rng.random((G, n)) < 0.8)
    assign = torch.from_numpy(rng.integers(0, M, (G, n)).astype(np.int32))
    i32 = lambda hi, shape: torch.from_numpy(
        rng.integers(0, hi, shape).astype(np.int32))
    tables = (i32(d, (G, 3, M)), i32(nb, (G, 3, M)),
              torch.from_numpy(rng.random((G, 3, M)) < 0.7))
    level = (torch.from_numpy(rng.integers(0, d, (G, NL)).astype(np.int32)),
             torch.from_numpy(rng.integers(0, nb, (G, NL)).astype(np.int32)),
             torch.from_numpy(rng.random((G, NL)) < 0.6))
    return codes, idx, stats, rel, active, assign, tables, level


@pytest.mark.parametrize("kernel", ["histogram", "leaf", "route",
                                    "descend"])
def test_slice_forms_are_their_one_slice_calls(kernel):
    codes, idx, stats, rel, active, assign, tables, level = _slice_inputs()
    G = len(idx)
    if kernel == "histogram":
        got = tk.tree_histogram_slices(codes, idx, stats, rel, active,
                                       n_nodes=8, n_bins=16)
        want = [tk.tree_histogram(codes[c], stats[g], rel[g], active[g],
                                  n_nodes=8, n_bins=16)
                for g, c in enumerate(idx)]
        plain = tk.tree_histogram_slices_ref(codes, idx, stats, rel, active,
                                             n_nodes=8, n_bins=16)
    elif kernel == "leaf":
        got = tk.tree_leaf_stats_slices(assign, stats, n_nodes=31)
        want = [tk.tree_leaf_stats(assign[g], stats[g], n_nodes=31)
                for g in range(G)]
        plain = tk.tree_leaf_stats_slices_ref(assign, stats, n_nodes=31)
    elif kernel == "route":
        args = (rel, active, assign, *level)
        got = tk.tree_route_level_slices(codes, idx, *args)
        want = [tk.tree_route_level(codes[c], *(a[g] for a in args))
                for g, c in enumerate(idx)]
        plain = tk.tree_route_level_slices_ref(codes, idx, *args)
    else:
        got = tk.tree_descend_slices(codes, idx, *tables, max_depth=4)
        want = [tk.tree_descend(codes[c], *(t[g] for t in tables),
                                max_depth=4) for g, c in enumerate(idx)]
        plain = tk.tree_descend_slices_ref(codes, idx, *tables, max_depth=4)
    assert got.shape[0] == G
    for g in range(G):
        assert torch.equal(got[g], want[g]), g
    assert torch.equal(got, plain)


def test_slice_index_refuses_bad_matrix_indices():
    with pytest.raises(ValueError, match="outside"):
        tk.slice_index([0, 2], 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="at least one"):
        tk.slice_index([], 2, torch.device("cpu"))
    t = tk.slice_index((1, 0, 1), 2, torch.device("cpu"))
    assert t.dtype == torch.int32 and t.tolist() == [1, 0, 1]


@pytest.mark.parametrize("G", [1, 24, 200])
def test_hist_plan_budgets_partials_across_slices(G):
    """The int64 partials of all slices stay within the budget unless the
    row cap forces more chunks, and the row cap always holds."""
    n, d, nb, S, NL = 11_000_000, 28, 32, 2, 16
    NG, CG, R, rows = tk.hist_plan(n, d, nb, S, NL, 132, G)
    assert rows <= tk.HIST_MAX_ROWS and R * rows >= n
    partial = R * G * NL * d * nb * S * 8
    assert (partial <= tk._PARTIAL_BYTES
            or R == -(-n // tk.HIST_MAX_ROWS))
    if G > 1:
        assert R <= tk.hist_plan(n, d, nb, S, NL, 132, 1)[2]


def test_build_trees_slices_are_single_builds():
    """G trees grown at once (different stats, matrices, feature masks,
    bin and level masks) are each the tree ``_build_trees`` grows for
    that slice alone."""
    rng = np.random.default_rng(3)
    P, n, d, G = 2, 500, 5, 4
    B = torch.from_numpy(rng.integers(0, 16, (P, n, d)).astype(np.uint8))
    idx = [0, 1, 1, 0]
    y = rng.integers(0, 3, n)
    onehot = torch.from_numpy(np.eye(3, dtype=np.float32)[y].T.copy())
    stats = torch.stack([onehot * torch.from_numpy(
        rng.poisson(1.0, n).astype(np.float32)) for _ in range(G)])
    fmask = torch.from_numpy(np.where(rng.random((G, d)) < 0.7, 0.0,
                                      trees.NEG).astype(np.float32))
    bmask = torch.zeros((G, 16))
    bmask[1, 7:] = trees.NEG
    lallow = torch.ones((G, 4), dtype=torch.bool)
    lallow[2, 2:] = False
    kw = dict(max_depth=4, n_bins=16, gain_fn=trees._gini_gain,
              weight_fn=lambda s: s.sum(-1), min_child_weight=1.0,
              min_gain=1e-9)
    together = trees._build_trees(B, idx, stats, fmask, bin_gain_mask=bmask,
                                  level_allow=lallow, **kw)
    for g in range(G):
        alone = trees._build_trees(
            B, [idx[g]], stats[g:g + 1], fmask[g:g + 1],
            bin_gain_mask=bmask[g:g + 1], level_allow=lallow[g:g + 1], **kw)
        for a, b in zip(together, alone):
            assert torch.equal(a[g], b[0])
    # The level mask stops slice 2 at depth 2: no node past level 1 splits.
    assert not together[2][2][3:].any()


def test_bin_features_pop_is_the_jax_binning():
    X, _ = _blobs(n=300, seed=1)
    d = X.shape[1]
    edges = []
    for nb_c in (8, 32):
        e = np.full((d, 31), np.inf, np.float32)
        e[:, :nb_c - 1] = trees.quantile_edges(X, nb_c)
        edges.append(e)
    X[0, 0] = np.inf                                   # x > inf is false
    X[1, 1] = np.nan
    got = trees._bin_features_pop(torch.from_numpy(X),
                                  [torch.from_numpy(e) for e in edges])
    want = np.asarray(jtrees._bin_features_pop(X, np.stack(edges)))
    np.testing.assert_array_equal(got.numpy(), want)
    # A padded stack bins as the shorter edge list does.
    short = trees.bin_features(torch.from_numpy(X),
                               torch.from_numpy(edges[0][:, :7].copy()))
    assert torch.equal(got[0], short)


# -- population-vs-serial parity ----------------------------------------------

PARITY_CASES = [
    ("dt", [{"max_depth": 2, "n_bins": 8}, {"max_depth": 4, "n_bins": 16},
            {"max_depth": 3, "n_bins": 32}]),
    ("rf", [{"n_trees": 8, "max_depth": 3, "n_bins": 16},
            {"n_trees": 8, "max_depth": 5, "n_bins": 8, "mtry": 4}]),
    ("lr", [{"solver": "adam", "iters": 30, "lr": 0.05},
            {"solver": "adam", "iters": 30, "lr": 0.1, "l2": 1e-3}]),
    ("lr", [{"solver": "newton", "iters": 8},
            {"solver": "newton", "iters": 12, "l2": 1e-2}]),
    ("mlp", [{"hidden": 32, "iters": 20, "lr": 0.01},
             {"hidden": 64, "iters": 24, "lr": 0.005}]),
]


@pytest.mark.parametrize(
    "family,configs", PARITY_CASES,
    ids=["dt", "rf", "lr-adam", "lr-newton", "mlp"])
def test_population_bit_identical_to_serial(trt, family, configs):
    """folds=1/rungs=1: each member's score equals its standalone fit's
    self-accuracy EXACTLY — one flipped prediction moves accuracy by 1/n,
    so score equality is prediction equality."""
    X, y = _blobs(seed=3, sep=0.8)
    board = tune.sweep(trt, X, y, 2, family, configs, cfg=Settings(),
                       folds=1, rungs=1)
    assert board["waves"] == 1 and not board["halving"]
    for c in configs:
        r = _by_config(board, c)
        assert r["fold_scores"] == [_serial_score(trt, family, c, X, y,
                                                  2)], c
        assert r["alive"] and r["mean_score"] == r["fold_scores"][0]


def test_population_parity_multiclass_dt(trt):
    X, y = _blobs(n=300, classes=3, seed=5, sep=1.5)
    configs = [{"max_depth": 3, "n_bins": 16}, {"max_depth": 5, "n_bins": 8}]
    board = tune.sweep(trt, X, y, 3, "dt", configs, cfg=Settings(),
                       folds=1, rungs=1)
    for c in configs:
        assert _by_config(board, c)["fold_scores"] == [
            _serial_score(trt, "dt", c, X, y, 3)], c


def test_population_parity_gb_accuracy(trt):
    X, y = _blobs(seed=7, sep=0.8)
    configs = [{"n_rounds": 6, "max_depth": 3},
               {"n_rounds": 8, "max_depth": 2, "step_size": 0.3}]
    board = tune.sweep(trt, X, y, 2, "gb", configs, cfg=Settings(),
                       folds=1, rungs=1)
    for c in configs:
        got = _by_config(board, c)["fold_scores"][0]
        want = _serial_score(trt, "gb", c, X, y, 2)
        assert abs(got - want) <= 0.02, (c, got, want)


def test_population_parity_across_budget_waves(trt):
    """A capped population spills into sequential waves — per-config
    results must not depend on which wave a config landed in."""
    X, y = _blobs(seed=11, sep=0.8)
    configs = [{"max_depth": k, "n_bins": 16} for k in (2, 3, 4, 5)]
    cfg = _mk_cfg(tune_max_population=2)  # waves of 2
    board = tune.sweep(trt, X, y, 2, "dt", configs, cfg=cfg,
                       folds=1, rungs=1)
    assert board["waves"] == 2
    assert {r["wave"] for r in board["results"]} == {0, 1}
    for c in configs:
        assert _by_config(board, c)["fold_scores"] == [
            _serial_score(trt, "dt", c, X, y, 2)], c


@pytest.mark.parametrize("family,configs,budget_mb,wave_sizes", [
    ("rf", [{"n_trees": 4, "max_depth": 3, "n_bins": 16},
            {"n_trees": 4, "max_depth": 4, "n_bins": 32}], 0, [2]),
    ("gb", [{"n_rounds": 3, "max_depth": 2},
            {"n_rounds": 4, "max_depth": 3, "step_size": 0.3}], 0, [2]),
    # 40 B a row an lr member (masks, its float32 design, its logits) at
    # d = 6: two configs of 3 folds at 4,000 rows fit 1 MiB, three do not.
    ("lr", [{"solver": "newton", "iters": 3},
            {"solver": "newton", "iters": 4, "l2": 1e-2},
            {"solver": "newton", "iters": 5, "l2": 1e-3}], 1, [2, 1]),
], ids=["rf", "gb", "lr-budget-waves"])
def test_sweep_tiles_the_fold_masks_to_each_wave(trt, monkeypatch, family,
                                                 configs, budget_mb,
                                                 wave_sizes):
    """Each wave's drivers get the (folds, rows) masks tiled config-major
    to its members on the device: bit for bit the host tiles."""
    n, folds = 4000, 3
    X, y = _blobs(n=n, seed=13, sep=0.8)
    seen = []
    make = tune._make_driver

    def spy(family, runtime, X, y, num_classes, configs, fold_ids,
            tr_masks, ev_masks, **kw):
        seen.append((len(configs), tr_masks, ev_masks))
        return make(family, runtime, X, y, num_classes, configs, fold_ids,
                    tr_masks, ev_masks, **kw)

    monkeypatch.setattr(tune, "_make_driver", spy)
    monkeypatch.setattr(tune.resources, "family_watermarks", dict)
    cfg = _mk_cfg(tune_hbm_budget_mb=budget_mb)
    board = tune.sweep(trt, X, y, 2, family, configs, cfg=cfg, folds=folds,
                       rungs=1)
    assert board["waves"] == len(wave_sizes)
    assert [nc for nc, _, _ in seen] == wave_sizes
    _, tr_all, ev_all = tune._fold_masks(n, n, folds)
    for nc, tr, ev in seen:
        for got, host in ((tr, tr_all), (ev, ev_all)):
            assert isinstance(got, torch.Tensor)
            assert got.device == trt.device
            want = np.tile(host, (nc, 1))
            assert got.shape == want.shape and got.dtype == torch.float32
            assert got.cpu().numpy().tobytes() == want.tobytes()


def test_sweep_input_validation(trt):
    X, y = _blobs(n=60)
    with pytest.raises(ValueError, match="folds"):
        tune.sweep(trt, X, y, 2, "dt", [{"max_depth": 2}],
                   cfg=Settings(), folds=0, rungs=1)
    with pytest.raises(ValueError, match="rungs"):
        tune.sweep(trt, X, y, 2, "dt", [{"max_depth": 2}],
                   cfg=Settings(), folds=1, rungs=0)


# -- the port's leaderboard against the JAX package's -------------------------

def _scores(board):
    return {json.dumps(r["config"], sort_keys=True): r["fold_scores"]
            for r in board["results"]}


def test_leaderboard_dt_equals_jax(trt, jrt):
    X, y = _blobs(n=300, seed=13, sep=0.8)
    configs = [{"max_depth": 2, "n_bins": 8}, {"max_depth": 4, "n_bins": 16},
               {"max_depth": 5, "n_bins": 32}]
    board = tune.sweep(trt, X, y, 2, "dt", configs, cfg=Settings(),
                       folds=3, rungs=2)
    jboard = jtune.sweep(jrt, X, y, 2, "dt", configs, cfg=JaxSettings(),
                         folds=3, rungs=2)
    assert _scores(board) == _scores(jboard)
    assert board["winner"]["config"] == jboard["winner"]["config"]


def test_leaderboard_rf_equals_jax_with_its_draws(trt, jrt):
    X, y = _blobs(n=300, seed=17, sep=0.8)
    n, d = X.shape
    configs = [{"n_trees": 4, "max_depth": 3, "n_bins": 16, "seed": 5},
               {"n_trees": 4, "max_depth": 4, "n_bins": 8, "seed": 6,
                "mtry": 3}]

    def draws(c):
        mtry = c.get("mtry") or max(1, int(np.sqrt(d)))
        return _jax_forest_draws(int(c.get("seed", 0)), n, d, 4, mtry,
                                 jrt.mesh.shape[DATA_AXIS])

    board = tune.sweep(trt, X, y, 2, "rf", configs, cfg=Settings(),
                       folds=2, rungs=1, draws=draws)
    jboard = jtune.sweep(jrt, X, y, 2, "rf", configs, cfg=JaxSettings(),
                         folds=2, rungs=1)
    assert _scores(board) == _scores(jboard)
    assert board["winner"]["config"] == jboard["winner"]["config"]


@pytest.mark.parametrize("family,configs,tol", [
    ("lr", [{"solver": "newton", "iters": 10},
            {"solver": "newton", "iters": 10, "l2": 0.5}], 0.01),
    ("lr", [{"solver": "adam", "iters": 40, "lr": 1e-4},
            {"solver": "adam", "iters": 40, "lr": 0.3}], 0.03),
    ("mlp", [{"hidden": 16, "iters": 40, "lr": 1e-5},
             {"hidden": 16, "iters": 40, "lr": 0.05}], 0.03),
], ids=["lr-newton", "lr-adam", "mlp"])
def test_leaderboard_lr_mlp_match_jax(trt, jrt, family, configs, tol):
    X, y = _blobs(n=300, seed=19, sep=0.7)
    board = tune.sweep(trt, X, y, 2, family, configs, cfg=Settings(),
                       folds=3, rungs=1)
    jboard = jtune.sweep(jrt, X, y, 2, family, configs, cfg=JaxSettings(),
                         folds=3, rungs=1)
    assert board["winner"]["config"] == jboard["winner"]["config"]
    w = json.dumps(board["winner"]["config"], sort_keys=True)
    assert abs(board["winner"]["mean_score"]
               - jboard["winner"]["mean_score"]) <= tol
    if family == "lr" and configs[0]["solver"] == "newton":
        # No random init: every config's folds track the JAX package's.
        for k, v in _scores(jboard).items():
            assert np.allclose(_scores(board)[k], v, atol=tol), k
    assert w in _scores(jboard)


# -- successive halving -------------------------------------------------------

def test_halving_drops_losers_and_keeps_winner(trt):
    before = tune.counters_snapshot()
    X, y = _blobs(n=300, seed=17, sep=0.8)
    configs = [{"solver": "adam", "iters": 48, "lr": r}
               for r in (0.001, 0.01, 0.05, 0.2)]
    board = tune.sweep(trt, X, y, 2, "lr", configs, cfg=Settings(),
                       folds=1, rungs=3)
    after = tune.counters_snapshot()
    assert board["halving"]
    alive = [r for r in board["results"] if r["alive"]]
    # 4 -> 2 -> 1 across the two interior rung boundaries.
    assert len(alive) == 1
    assert board["winner"] is alive[0]
    assert board["winner"]["rungs_survived"] == 3
    survived = sorted(r["rungs_survived"] for r in board["results"])
    assert survived == [1, 1, 2, 3]
    assert after["halving_drops"] - before["halving_drops"] == 3
    assert after["rungs_completed"] - before["rungs_completed"] == 3
    assert after["candidates_evaluated"] - before["candidates_evaluated"] == 4


@pytest.mark.parametrize("family,configs", [
    ("lr", [{"solver": "adam", "iters": 48, "lr": r}
            for r in (0.005, 0.02, 0.08, 0.3)]),
    ("gb", [{"n_rounds": 9, "max_depth": k} for k in (1, 2, 3)]),
    ("mlp", [{"hidden": 8, "iters": 12, "lr": r} for r in (1e-4, 0.05)]),
], ids=["lr", "gb", "mlp"])
def test_halving_winner_matches_serial_full_fit(trt, family, configs):
    """The survivor runs its whole unit budget in rung segments; the
    segmentation is invisible — its final score is its one-shot serial
    fit's (gb: within 0.02)."""
    X, y = _blobs(n=300, seed=19, sep=0.8)
    board = tune.sweep(trt, X, y, 2, family, configs, cfg=Settings(),
                       folds=1, rungs=3)
    w = board["winner"]
    want = _serial_score(trt, family, w["config"], X, y, 2)
    if family == "gb":
        assert abs(w["fold_scores"][0] - want) <= 0.02
    else:
        assert w["fold_scores"] == [want]


# -- crash-at-rung-boundary resume --------------------------------------------

def _strip_timing(board):
    doc = json.loads(json.dumps(board))  # deep copy, JSON-able by contract
    for r in doc["results"] + [doc["winner"]]:
        r.pop("fit_seconds")
    return doc


@pytest.mark.parametrize("family,configs", [
    ("lr", [{"solver": "adam", "iters": 48, "lr": r}
            for r in (0.003, 0.01, 0.06, 0.25)]),
    ("lr", [{"solver": "newton", "iters": 9, "l2": r}
            for r in (1e-4, 0.1, 1.0)]),
    ("rf", [{"n_trees": 15, "max_depth": k, "n_bins": 8} for k in (2, 4)]),
    ("gb", [{"n_rounds": 9, "max_depth": k} for k in (1, 3)]),
    ("mlp", [{"hidden": 8, "iters": 12, "lr": r} for r in (1e-3, 0.05)]),
], ids=["lr-adam", "lr-newton", "rf", "gb", "mlp"])
def test_interrupted_sweep_resumes_to_identical_board(trt, tmp_path, family,
                                                      configs):
    """Crash on the SECOND rung checkpoint commit (the first is durable),
    re-run the same sweep: it resumes from rung 1 — alive set, rung
    history, scores and the driver's device state restored — and finishes
    with a board identical to the uninterrupted one's, minus wall-clock."""
    X, y = _blobs(n=300, seed=23, sep=0.8)
    oracle = tune.sweep(trt, X, y, 2, family, configs, cfg=Settings(),
                        folds=2, rungs=3)
    cfg = _mk_cfg(tmp_path)
    mk_ctx = lambda: fitckpt.context(
        cfg, dataset="blobs", family=f"tune_{family}",
        config={"configs": configs, "folds": 2, "rungs": 3},
        snapshot="rows=300", every=1)
    failpoints.configure("fit.ckpt.pre_rename=raise:2")
    with pytest.raises(failpoints.FailpointError):
        tune.sweep(trt, X, y, 2, family, configs, cfg=cfg, folds=2, rungs=3,
                   ckpt=mk_ctx())
    failpoints.reset()

    before = tune.counters_snapshot()["sweeps_resumed"]
    fck_before = fitckpt.counters_snapshot()["resumes"]
    board = tune.sweep(trt, X, y, 2, family, configs, cfg=cfg, folds=2,
                       rungs=3, ckpt=mk_ctx())
    assert tune.counters_snapshot()["sweeps_resumed"] == before + 1
    assert fitckpt.counters_snapshot()["resumes"] == fck_before + 1
    assert _strip_timing(board) == _strip_timing(oracle)
    assert fitckpt.disk_snapshot(cfg)["files"] == 0


def test_stale_checkpoint_is_discarded_not_trusted(trt, tmp_path):
    """A checkpoint whose orchestration shape (folds) no longer matches is
    cleared and the sweep runs fresh."""
    X, y = _blobs(n=240, seed=29)
    configs = [{"solver": "adam", "iters": 30, "lr": r} for r in (0.01, 0.1)]
    cfg = _mk_cfg(tmp_path)
    ctx = fitckpt.context(cfg, dataset="b", family="tune_lr",
                          config={"v": 1}, snapshot="rows=240", every=1)
    failpoints.configure("fit.ckpt.pre_rename=raise:2")
    with pytest.raises(failpoints.FailpointError):
        tune.sweep(trt, X, y, 2, "lr", configs, cfg=cfg, folds=1, rungs=3,
                   ckpt=ctx)
    failpoints.reset()
    before = tune.counters_snapshot()["sweeps_resumed"]
    ctx2 = fitckpt.context(cfg, dataset="b", family="tune_lr",
                           config={"v": 1}, snapshot="rows=240", every=1)
    board = tune.sweep(trt, X, y, 2, "lr", configs, cfg=cfg, folds=2,
                       rungs=3, ckpt=ctx2)
    assert tune.counters_snapshot()["sweeps_resumed"] == before
    assert board["folds"] == 2


# -- REST surface -------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from learningorchestra_tpu_torch.client import Context, DatabaseApi
    from learningorchestra_tpu_torch.serving.app import App

    tmp = tmp_path_factory.mktemp("tune_serve")
    cfg = Settings()
    cfg.store_root = str(tmp / "store")
    cfg.image_root = str(tmp / "images")
    cfg.port = 0
    cfg.persist = True
    app = App(cfg, recover=False, device="cpu")
    server = app.serve(background=True)
    ctx = Context(f"http://127.0.0.1:{server.port}", poll_seconds=0.1,
                  timeout=120)
    csv = tmp / "t.csv"
    rows = ["Pclass,Sex,Age,Fare,Survived"]
    rng = np.random.default_rng(0)
    for _ in range(160):
        sex = rng.choice(["male", "female"])
        surv = int(rng.random() < (0.75 if sex == "female" else 0.2))
        rows.append(f"{rng.integers(1, 4)},{sex},{rng.integers(1, 70)},"
                    f"{round(float(rng.lognormal(2.5, 1.0)), 2)},{surv}")
    csv.write_text("\n".join(rows) + "\n")
    DatabaseApi(ctx).create_file("tune_train", csv.as_uri(), wait=True)
    yield ctx, server.port, app
    app.jobs.wait_all(timeout=120)
    server.stop()


def _post(port, path, body):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("family,configs", [
    ("dt", [{"max_depth": 2, "n_bins": 8}, {"max_depth": 4, "n_bins": 16}]),
    ("mlp", [{"hidden": 8, "iters": 20}, {"hidden": 16, "iters": 20}]),
])
def test_tune_route_sync_promotes_winner(served, family, configs):
    from learningorchestra_tpu_torch.client import DatabaseApi, Model

    ctx, port, app = served
    m = Model(ctx)
    name = f"tuned_{family}"
    out = m.tune("tune_train", name, family, configs, "Survived", folds=2,
                 rungs=2, promote=True)
    board = out["result"]
    assert board["family"] == family and len(board["results"]) == 2
    assert board["promoted"] == name, board.get("promote_error")
    meta = DatabaseApi(ctx).read_file(name, limit=1)[0]
    assert meta["finished"] is True
    assert meta["tune"]["winner"]["config"] == board["winner"]["config"]
    # The promoted winner serves online predictions and batch predicts.
    pred = m.predict_online(name, [[3, 1, 22, 7.25]])
    assert len(pred["predictions"]) == 1
    app.builder.predict(name, "tune_train", f"{name}_pred")
    assert app.store.get(f"{name}_pred").num_rows == 160


def test_tune_route_async(served):
    from learningorchestra_tpu_torch.client import DatabaseApi, Model

    ctx, port, app = served
    m = Model(ctx)
    m.tune("tune_train", "tuned_lr", "lr",
           [{"iters": 30, "lr": 0.05}, {"iters": 30, "lr": 0.2}],
           "Survived", folds=2, rungs=1, sync=False)
    meta = DatabaseApi(ctx).read_file("tuned_lr", limit=1)[0]
    assert meta["finished"] is True and meta["tune"]["family"] == "lr"
    assert meta["job"]["kind"] == "tune"
    assert callable(app._retry_runner(meta["job"], ["tuned_lr"]))


@pytest.mark.parametrize("configs,needle", [
    ([{"max_depth": 4, "bogus": 1}], "bogus"),       # unknown name
    ([{"n_bins": 500}], "n_bins"),                   # out of range
], ids=["unknown-key", "out-of-range"])
def test_tune_route_406_names_bad_hparam(served, configs, needle):
    _, port, _ = served
    code, body = _post(port, "/tune", {
        "training_filename": "tune_train", "tune_filename": "rejected",
        "classificator": "dt", "configs": configs, "label": "Survived"})
    assert code == 406 and needle in json.dumps(body), (code, body)


def test_tune_route_rejects_family_without_pop_path(served):
    _, port, _ = served
    code, body = _post(port, "/tune", {
        "training_filename": "tune_train", "tune_filename": "rejected2",
        "classificator": "nb", "configs": [{}], "label": "Survived"})
    assert code == 406 and "population" in json.dumps(body)


def test_tune_route_missing_dataset_404(served):
    _, port, _ = served
    code, _ = _post(port, "/tune", {
        "training_filename": "nope", "tune_filename": "rejected3",
        "classificator": "dt", "configs": [{"max_depth": 2}],
        "label": "Survived"})
    assert code == 404


def test_metrics_expose_tune_section(served):
    import urllib.request

    _, port, _ = served
    code, _ = _post(port, "/tune", {
        "training_filename": "tune_train", "tune_filename": "tuned_metrics",
        "classificator": "gb",
        "configs": [{"n_rounds": 3, "max_depth": 2},
                    {"n_rounds": 4, "max_depth": 3}],
        "label": "Survived", "folds": 1, "rungs": 1})
    assert code == 201
    doc = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics").read())
    assert set(doc["tune"]) == set(jtune.counters_snapshot())
    assert doc["tune"]["populations_fitted"] >= 1
    assert doc["tune"]["candidates_evaluated"] >= 2
    txt = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics?format=prometheus"
    ).read().decode()
    for series in ("lo_tune_populations_fitted",
                   "lo_tune_candidates_evaluated", "lo_tune_rungs_completed",
                   "lo_tune_halving_drops", "lo_tune_hbm_spill_waves",
                   "lo_tune_sweeps_resumed"):
        assert series in txt, series
