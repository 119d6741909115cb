"""The PyTorch package's online predict programs (``models/aot.py``)
against the JAX package's, on the CPU.

- ``predict_buckets`` / ``bucket_for``: equal to the JAX ones.
- ``design_from_rows``: on the same rows and the same fitted
  preprocessing state (the JAX package's ``design_matrix``), the same
  array bit for bit — dict rows through the vocab and fillna state, list
  rows, the columnar ndarray form — and the same ValueError (the 406 of
  the REST tier) for non-finite, ragged and non-numeric rows.
- ``AotModel``: weights of a JAX-fitted model carried across with
  ``models/convert.from_jax_params``; the port's ``AotModel(device="cpu")``
  and the JAX ``AotModel`` (CPU, its row-wise programs) give the same
  probabilities on the same 40 rows within the tolerances of
  tests/test_torch_models.py: lr atol 2e-2 (bf16 products), nb rtol 1e-5
  atol 1e-7, dt/rf/gb rtol 1e-6 atol 1e-7.
- Row invariance on the port: the same rows through buckets 1, 8 and 64,
  one row at a time through the batch path, and inside a 5,000-row batch
  predict are bit-identical, for every family.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's programs below)

from learningorchestra_tpu.catalog.store import DatasetStore as JaxStore
from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.models import aot as jaot
from learningorchestra_tpu.models import logistic as jlogistic
from learningorchestra_tpu.models import naive_bayes as jnb
from learningorchestra_tpu.models import trees as jtrees
from learningorchestra_tpu.ops import preprocess as jpreprocess
from learningorchestra_tpu.parallel.mesh import MeshRuntime
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models import aot
from learningorchestra_tpu_torch.models import (
    logistic, naive_bayes, trees)
from learningorchestra_tpu_torch.models.convert import from_jax_params
from learningorchestra_tpu_torch.models.persistence import ModelRegistry
from learningorchestra_tpu_torch.models.registry import ONLINE_KINDS
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

BUCKETS = (1, 8, 64)
D = 6
FIELDS = [f"x{i}" for i in range(D)]
PP = {"steps": [], "state": {}, "feature_fields": FIELDS, "label": "y"}
#: Tolerances of tests/test_torch_models.py per family.
TOL = {"lr": dict(rtol=0, atol=2e-2), "nb": dict(rtol=1e-5, atol=1e-7),
       "dt": dict(rtol=1e-6, atol=1e-7), "rf": dict(rtol=1e-6, atol=1e-7),
       "gb": dict(rtol=1e-6, atol=1e-7)}


def _blobs(n, classes=2, seed=0, sep=1.2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, D)) * sep
    y = rng.integers(0, classes, size=n)
    X = (centers[y] + rng.normal(size=(n, D))).astype(np.float32)
    return X, y.astype(np.int32)


def _manifest(kind):
    return {"kind": kind, "preprocess": PP}


# ---------------------------------------------------------------------------
# Buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_batch", [1, 2, 7, 8, 9, 64, 65, 256, 300])
def test_buckets_equal_the_jax_ones(max_batch):
    ladder = aot.predict_buckets(max_batch)
    assert ladder == jaot.predict_buckets(max_batch)
    for n in range(1, max_batch + 3):
        assert aot.bucket_for(n, ladder) == jaot.bucket_for(n, ladder)


# ---------------------------------------------------------------------------
# design_from_rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def titanic_pp(tmp_path_factory):
    """A Titanic-shaped dataset's fitted preprocessing state, from the
    JAX package's ``design_matrix`` (default steps: label encode + mean
    fill): Sex is a vocab field, Age has NaNs (a fitted mean), Pclass is
    an integer column (no fill statistic)."""
    cfg = JaxSettings()
    cfg.store_root = str(tmp_path_factory.mktemp("pp") / "store")
    rng = np.random.default_rng(0)
    n = 300
    age = rng.integers(1, 70, n).astype(np.float64)
    age[rng.random(n) < 0.1] = np.nan
    store = JaxStore(cfg)
    store.create("t", columns={
        "Sex": rng.choice(["male", "female"], n).astype(object),
        "Age": age, "Pclass": rng.integers(1, 4, n).astype(np.int64),
        "Fare": rng.lognormal(2.5, 1.0, n),
        "Survived": rng.integers(0, 2, n).astype(np.int64)}, finished=True)
    _, _, fields, state = jpreprocess.design_matrix(store.get("t"),
                                                    "Survived", [])
    return {"steps": [], "state": state, "feature_fields": fields,
            "label": "Survived"}


def _dict_rows(n, seed):
    rng = np.random.default_rng(seed)
    return [{"Sex": rng.choice(["male", "female", "other"]).item(),
             "Age": None if rng.random() < 0.2 else int(rng.integers(1, 70)),
             "Pclass": int(rng.integers(1, 4)),
             "Fare": round(float(rng.lognormal(2.5, 1.0)), 4),
             "Name": "extra payload field"} for _ in range(n)]


def _rows_case(case, pp):
    width = len(pp["feature_fields"])
    rng = np.random.default_rng(5)
    if case == "dict":
        return _dict_rows(37, 1)
    if case == "dict_one":
        return _dict_rows(1, 2)
    if case == "list":
        return rng.normal(size=(9, width)).round(3).tolist()
    if case == "ndarray":
        return rng.normal(size=(9, width)).astype(np.float32)
    if case == "ndarray_f64":
        return rng.normal(size=(3, width))
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["dict", "dict_one", "list", "ndarray",
                                  "ndarray_f64"])
def test_design_from_rows_equals_the_jax_one(titanic_pp, case):
    rows = _rows_case(case, titanic_pp)
    got = aot.design_from_rows(rows, titanic_pp)
    want = jaot.design_from_rows(rows, titanic_pp)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _bad_rows(case, pp):
    width = len(pp["feature_fields"])
    if case == "non_finite":     # Pclass had no missing value: no fill stat
        return [{"Sex": "male", "Age": 30, "Pclass": None, "Fare": 7.5}]
    if case == "non_finite_list":
        return [[float("nan")] * width]
    if case == "width":
        return [[1.0]]
    if case == "non_numeric":
        return [[1.0, {"a": 1}, 3.0, 4.0]]
    if case == "mixed":
        return [[1.0] * width, {"Sex": "male"}]
    if case == "empty":
        return []
    if case == "string_feature":
        return [{"Sex": "male", "Age": 30, "Pclass": "first", "Fare": 7.5}]
    if case == "missing_field":
        return [{"NotAField": 1}]
    if case == "ndarray_1d":
        return np.zeros(width, np.float32)
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "non_finite", "non_finite_list", "width", "non_numeric", "mixed",
    "empty", "string_feature", "missing_field", "ndarray_1d"])
def test_design_from_rows_rejects_like_the_jax_one(titanic_pp, case):
    rows = _bad_rows(case, titanic_pp)
    with pytest.raises(ValueError) as got:
        aot.design_from_rows(rows, titanic_pp)
    with pytest.raises(ValueError) as want:
        jaot.design_from_rows(rows, titanic_pp)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# AotModel against the JAX AotModel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jrt():
    return MeshRuntime(JaxSettings())


def _jax_fit(kind, jrt, X, y, classes):
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
def test_aot_model_matches_the_jax_one(jrt, kind, classes):
    X, y = _blobs(600, classes=classes, seed=8)
    jm = _jax_fit(kind, jrt, X, y, classes)
    tm = from_jax_params(kind, {k: np.asarray(v) for k, v in
                                jm.params.items()},
                         jm.num_classes, jm.hparams)
    Xq, _ = _blobs(40, classes=classes, seed=9)
    want = jaot.AotModel("m", (0, 0), _manifest(kind), jm,
                         BUCKETS).predict(Xq)
    got = aot.AotModel("m", (0, 0), _manifest(kind), tm, BUCKETS,
                       device="cpu").predict(Xq)
    assert got.shape == want.shape == (40, classes)
    np.testing.assert_allclose(got, want, **TOL[kind])


# ---------------------------------------------------------------------------
# Row invariance on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trt():
    return DeviceRuntime(Settings(), device="cpu")


def _port_fit(kind, trt, X, y, classes):
    if kind == "lr":
        return logistic.fit(trt, X, y, classes)
    if kind == "nb":
        return naive_bayes.fit(trt, X, y, classes)
    if kind == "dt":
        return trees.fit_dt(trt, X, y, classes, max_depth=5)
    if kind == "rf":
        return trees.fit_rf(trt, X, y, classes, n_trees=7, max_depth=5)
    return trees.fit_gb(trt, X, y, classes, n_rounds=9, max_depth=4)


@pytest.mark.parametrize("kind,classes", [
    ("lr", 2), ("lr", 3), ("nb", 2), ("dt", 2), ("rf", 3), ("gb", 2),
    ("gb", 3)])
def test_rows_bit_identical_across_buckets_and_batch_path(trt, kind,
                                                          classes):
    X, y = _blobs(2000, classes=classes, seed=10, sep=0.5)
    model = _port_fit(kind, trt, X, y, classes)
    m = aot.AotModel("m", (0, 0), _manifest(kind), model, BUCKETS,
                     device="cpu")
    Xq = X[:40]
    one_bucket = np.concatenate([m.predict_padded(Xq[i:i + 1])
                                 for i in range(40)])
    eight = np.concatenate([m.predict_padded(Xq[i:i + 8])
                            for i in range(0, 40, 8)])
    # 3-row requests pad into bucket 8: rows sit at odd offsets.
    threes = np.concatenate([m.predict_padded(Xq[i:i + 3])
                             for i in range(0, 40, 3)])
    sixty_four = m.predict_padded(Xq)
    batch_one_row = np.concatenate([model.predict_proba(trt, Xq[i:i + 1])
                                    for i in range(40)])
    big_batch = model.predict_proba(trt, np.concatenate(
        [X, X, X[:1000]]))[:40]
    for other in (eight, threes, sixty_four, batch_one_row, big_batch):
        assert other.dtype == np.float32
        np.testing.assert_array_equal(one_bucket, other)
    assert np.isfinite(one_bucket).all()
    np.testing.assert_allclose(one_bucket.sum(1), 1.0, atol=1e-5)


def test_online_kinds_are_the_ported_families():
    assert set(ONLINE_KINDS) == {"lr", "nb", "dt", "rf", "gb", "mlp"}
    with pytest.raises(ValueError, match="not servable online"):
        aot.AotModel("m", (0, 0), {"kind": "tx", "preprocess": PP}, None,
                     BUCKETS, device="cpu")


def test_cache_versions_swaps_and_deletes(tmp_path, trt):
    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    cfg.serve_max_batch = 8
    reg = ModelRegistry(cfg)
    X, y = _blobs(300)
    model = naive_bayes.fit(trt, X, y, 2)
    reg.save("m", model, preprocess=PP)
    cache = aot.AotCache(reg, cfg, device="cpu")
    assert cache.buckets == (1, 8) and cache.replicas == 1
    e1 = cache.entry("m")
    assert cache.entry("m") is e1 and e1.swap_epoch == 1
    assert e1.compile_wall_s >= 0
    reg.save("m", model, preprocess=PP)
    e2 = cache.entry("m")
    assert e2 is not e1 and e2.swap_epoch == 2
    np.testing.assert_array_equal(e1.predict(X[:5]), e2.predict(X[:5]))
    snap = cache.snapshot()
    assert snap["swaps"] == 1 and snap["evictions"] == 1
    assert snap["programs_compiled"] == 4 and snap["hits"] == 1
    reg.delete("m")
    with pytest.raises(KeyError):
        cache.entry("m")


def test_cache_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    with pytest.raises(RuntimeError, match="CUDA"):
        aot.AotCache(ModelRegistry(cfg), cfg)
    assert aot.resolve_replicas(cfg.replace(serve_replicas=0),
                                torch.device("cpu")) == 1
