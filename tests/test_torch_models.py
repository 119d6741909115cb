"""The PyTorch package's trainers against the JAX package's, on the CPU.

Same numpy inputs (made from a seed) into both packages; the JAX side
runs on the 8-device CPU mesh of tests/conftest.py with its Pallas tree
kernels in interpret mode, the PyTorch side on ``device="cpu"`` with the
kernels' plain versions. Tolerances:

- dt, rf: ``(feat, thr, internal, leaf)`` bit-identical — the stats are
  small integers, whose f32 sums are exact in any order (rf is fed the
  JAX package's own bootstrap and feature draws);
- gb: predicted classes agree on ≥ 99% of rows and accuracy within one
  point (real-valued gradient sums in another order can flip split ties);
- nb: probabilities within rtol 1e-5;
- lr (Newton): probabilities within atol 2e-2 and accuracy within one
  point (bf16 products round differently in the two frameworks);
- a JAX-fitted model carried across with ``from_jax_params`` predicts the
  same: dt/rf leaf ids bit-identical, dt/rf/gb probabilities rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.models import logistic as jlogistic
from learningorchestra_tpu.models import naive_bayes as jnb
from learningorchestra_tpu.models import trees as jtrees
from learningorchestra_tpu.parallel.mesh import DATA_AXIS, MeshRuntime
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models import logistic, naive_bayes, trees
from learningorchestra_tpu_torch.models.convert import from_jax_params
from learningorchestra_tpu_torch.ops.tree_kernels import tree_descend
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime


@pytest.fixture(scope="module")
def jrt():
    return MeshRuntime(JaxSettings())


@pytest.fixture(scope="module")
def trt():
    return DeviceRuntime(Settings(), device="cpu")


def _blobs(n, d=6, classes=2, seed=0, sep=1.2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * sep
    y = rng.integers(0, classes, size=n)
    X = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return X, y.astype(np.int32)


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _assert_trees_equal(tm, jm, keys=("feat", "thr", "internal", "leaf")):
    jp = _np(jm.params)
    for k in keys:
        np.testing.assert_array_equal(tm.params[k].numpy(), jp[k], err_msg=k)


def _accuracy(probs, y):
    return float((np.argmax(probs, 1) == y).mean())


@pytest.mark.parametrize("n,classes,depth", [(1001, 2, 4), (1500, 3, 5)])
def test_dt_bit_identical(jrt, trt, n, classes, depth):
    X, y = _blobs(n, classes=classes)
    jm = jtrees.fit_dt(jrt, X, y, classes, max_depth=depth, n_bins=16)
    tm = trees.fit_dt(trt, X, y, classes, max_depth=depth, n_bins=16)
    _assert_trees_equal(tm, jm)


def _jax_forest_draws(seed, n, d, n_trees, mtry, n_shards):
    """The JAX package's rf draws (models/trees.py ``_one_tree_fn``):
    per tree, split the batch key; Poisson(1) weights per data shard from
    ``fold_in(kb, shard)``; the first ``mtry`` of a permutation of the
    features."""
    tb, nb = jtrees._forest_batch_shape(n_trees)
    keys = jax.random.split(jax.random.PRNGKey(seed), nb * tb)
    padded = n + (-n) % n_shards
    local = padded // n_shards
    weights, allowed = [], []
    for i in range(n_trees):
        kb, kf = jax.random.split(keys[i])
        w = np.concatenate([
            np.asarray(jax.random.poisson(jax.random.fold_in(kb, s), 1.0,
                                          (local,)), np.float32)
            for s in range(n_shards)])[:n]
        perm = np.asarray(jax.random.permutation(kf, d))
        a = np.zeros(d, bool)
        a[perm[:mtry]] = True
        weights.append(w)
        allowed.append(a)
    return np.stack(weights), np.stack(allowed)


def test_rf_bit_identical_with_reference_draws(jrt, trt):
    n, d, n_trees = 1203, 6, 4
    X, y = _blobs(n, d=d, classes=3, seed=1)
    jm = jtrees.fit_rf(jrt, X, y, 3, n_trees=n_trees, max_depth=4,
                       n_bins=16, seed=5)
    mtry = max(1, int(np.sqrt(d)))
    w, a = _jax_forest_draws(5, n, d, n_trees, mtry,
                             jrt.mesh.shape[DATA_AXIS])
    tm = trees.fit_rf(trt, X, y, 3, n_trees=n_trees, max_depth=4,
                      n_bins=16, weights=w, feature_allowed=a)
    _assert_trees_equal(tm, jm)


def test_rf_own_draws_fit(trt):
    X, y = _blobs(2000, seed=2)
    m = trees.fit_rf(trt, X, y, 2, n_trees=5, max_depth=4, seed=3)
    again = trees.fit_rf(trt, X, y, 2, n_trees=5, max_depth=4, seed=3)
    _assert_trees_equal(m, again)
    Xt, yt = _blobs(500, seed=2)
    assert _accuracy(m.predict_proba(trt, Xt), yt) > 0.7


@pytest.mark.parametrize("classes", [2, 3])
def test_gb_agrees(jrt, trt, classes):
    X, y = _blobs(2000, classes=classes, seed=4)
    Xt, yt = _blobs(800, classes=classes, seed=4)
    Xt = Xt + np.float32(0.01)
    jm = jtrees.fit_gb(jrt, X, y, classes, n_rounds=6, max_depth=4,
                       n_bins=16)
    tm = trees.fit_gb(trt, X, y, classes, n_rounds=6, max_depth=4,
                      n_bins=16)
    pj = jm.predict_proba(jrt, Xt)
    pt = tm.predict_proba(trt, Xt)
    assert pt.shape == pj.shape == (800, classes)
    agree = (np.argmax(pj, 1) == np.argmax(pt, 1)).mean()
    assert agree >= 0.99, agree
    assert abs(_accuracy(pj, yt) - _accuracy(pt, yt)) <= 0.01


@pytest.mark.parametrize("event_model", ["gaussian", "multinomial"])
def test_nb_probabilities(jrt, trt, event_model):
    X, y = _blobs(1500, classes=3, seed=5)
    if event_model == "multinomial":
        X = np.abs(X)
    jm = jnb.fit(jrt, X, y, 3, event_model=event_model)
    tm = naive_bayes.fit(trt, X, y, 3, event_model=event_model)
    np.testing.assert_allclose(tm.predict_proba(trt, X),
                               jm.predict_proba(jrt, X), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("classes", [2, 3])
def test_lr_newton(jrt, trt, classes):
    # Overlapping classes: a finite optimum both solvers converge to.
    X, y = _blobs(3000, classes=classes, seed=6, sep=0.4)
    X = X * np.float32(3.0) + np.float32(10.0)       # unstandardized input
    jm = jlogistic.fit(jrt, X, y, classes)
    tm = logistic.fit(trt, X, y, classes)
    assert jm.hparams["solver"] == tm.hparams["solver"] == "newton"
    pj = jm.predict_proba(jrt, X)
    pt = tm.predict_proba(trt, X)
    np.testing.assert_allclose(pt, pj, atol=2e-2)
    assert abs(_accuracy(pj, y) - _accuracy(pt, y)) <= 0.01


def test_lr_adam_from_given_init(jrt, trt):
    X, y = _blobs(1000, classes=2, seed=7, sep=0.4)
    jm = jlogistic.fit(jrt, X, y, 2, solver="adam", iters=60, seed=3)
    W0 = 0.01 * np.asarray(jax.random.normal(jax.random.PRNGKey(3), (6, 2),
                                             jnp.float32))
    tm = logistic.fit(trt, X, y, 2, solver="adam", iters=60, W0=W0)
    np.testing.assert_allclose(tm.predict_proba(trt, X),
                               jm.predict_proba(jrt, X), atol=2e-2)


def _jax_model(kind, jrt, X, y, classes):
    if kind == "lr":
        return jlogistic.fit(jrt, X, y, classes)
    if kind == "nb":
        return jnb.fit(jrt, X, y, classes)
    if kind == "dt":
        return jtrees.fit_dt(jrt, X, y, classes, max_depth=4, n_bins=16)
    if kind == "rf":
        return jtrees.fit_rf(jrt, X, y, classes, n_trees=3, max_depth=4,
                             n_bins=16)
    return jtrees.fit_gb(jrt, X, y, classes, n_rounds=4, max_depth=4,
                         n_bins=16)


@pytest.mark.parametrize("kind,classes", [
    ("lr", 2), ("nb", 3), ("dt", 3), ("rf", 2), ("gb", 2), ("gb", 3)])
def test_from_jax_params_predicts_the_same(jrt, trt, kind, classes):
    X, y = _blobs(1200, classes=classes, seed=8)
    jm = _jax_model(kind, jrt, X, y, classes)
    tm = from_jax_params(kind, _np(jm.params), jm.num_classes, jm.hparams)
    pj = jm.predict_proba(jrt, X)
    pt = tm.predict_proba(trt, X)
    if kind == "lr":
        np.testing.assert_allclose(pt, pj, atol=2e-2)
    elif kind == "nb":
        np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-7)
    if kind in ("dt", "rf"):
        jp = _np(jm.params)
        depth = jm.hparams["max_depth"]
        B = jtrees.bin_features(jnp.asarray(X), jnp.asarray(jp["edges"]))
        tB = trees.bin_features(torch.from_numpy(X),
                                torch.from_numpy(jp["edges"]))
        np.testing.assert_array_equal(tB.numpy(), np.asarray(B))
        leaf_ids = tree_descend(tB, tm.params["feat"], tm.params["thr"],
                                tm.params["internal"],
                                max_depth=depth).numpy()
        for t in range(jp["feat"].shape[0]):
            ref = np.asarray(jtrees._descend(
                B, jnp.asarray(jp["feat"][t]), jnp.asarray(jp["thr"][t]),
                jnp.asarray(jp["internal"][t]), depth))
            np.testing.assert_array_equal(leaf_ids[t], ref)


def test_from_jax_params_rejects_unknown_keys():
    with pytest.raises(ValueError):
        from_jax_params("lr", {"W": np.zeros((2, 2)), "zz": np.zeros(1)},
                        2, {})
