"""The five-classifier sweep end to end in both packages, on the CPU.

The Titanic workload (tests/titanic_data.py) goes into each package's
catalog; ``ModelBuilder.build`` fits lr/dt/rf/gb/nb in both and writes a
prediction dataset per family. dt metrics are equal (its trees are
bit-identical); rf is within 3 points (the two draw different bootstraps),
the others within the tolerances of tests/test_torch_models.py.
"""

import numpy as np
import pytest
import torch

from learningorchestra_tpu.catalog.store import DatasetStore as JaxStore
from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.models.aot import AotModel as JaxAotModel
from learningorchestra_tpu.models.builder import ModelBuilder as JaxBuilder
from learningorchestra_tpu.parallel.mesh import MeshRuntime
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models.aot import AotModel
from learningorchestra_tpu_torch.models.builder import ModelBuilder
from learningorchestra_tpu_torch.models.persistence import ModelRegistry
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from tests.titanic_data import titanic_rows

FAMILIES = ["lr", "dt", "rf", "gb", "nb"]
STEPS = [{"op": "drop", "fields": ["PassengerId", "Name", "Ticket"]},
         {"op": "fillna", "strategy": "mean"},
         {"op": "label_encode", "fields": ["Sex", "Embarked"]}]
TOLERANCE = {"dt": 0.0, "rf": 0.03, "gb": 0.01, "lr": 0.01, "nb": 1e-6}


def _columns(rows):
    cols = {}
    for f in rows[0]:
        vals = [r[f] for r in rows]
        if f == "Age":
            cols[f] = np.array([float(v) if v != "" else np.nan
                                for v in vals])
        elif isinstance(vals[0], str):
            cols[f] = np.array(vals, dtype=object)
        else:
            cols[f] = np.array(vals)
    return cols


def _settings(cls, root):
    cfg = cls()
    cfg.store_root = str(root / "store")
    if hasattr(cfg, "image_root"):
        cfg.image_root = str(root / "images")
    return cfg


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    train = _columns(titanic_rows(scale=1.0, seed=7))
    test = _columns(titanic_rows(scale=418.0 / 891.0, seed=99))
    out = {}
    for pkg, (S, Store, Builder, runtime) in {
            "jax": (JaxSettings, JaxStore, JaxBuilder,
                    lambda cfg: MeshRuntime(cfg)),
            "torch": (Settings, DatasetStore, ModelBuilder,
                      lambda cfg: DeviceRuntime(cfg, device="cpu")),
    }.items():
        cfg = _settings(S, tmp_path_factory.mktemp(pkg))
        store = Store(cfg)
        store.create("train", columns=dict(train), finished=True)
        store.create("test", columns=dict(test), finished=True)
        mb = Builder(store, runtime(cfg), cfg)
        reports = mb.build("train", "test", "pred", FAMILIES, "Survived",
                           steps=STEPS)
        out[pkg] = (cfg, store, mb, {r.kind: r for r in reports})
    return out


def test_every_family_writes_its_dataset(sweeps):
    _, store, _, reports = sweeps["torch"]
    n_test = store.get("test").num_rows
    for c in FAMILIES:
        assert "error" not in reports[c].metrics, reports[c].metrics
        doc = store.get(f"pred_{c}").metadata.to_doc()
        assert doc["finished"] is True and not doc.get("error")
        for key in ("f1", "accuracy", "fit_time", "device_s"):
            assert key in doc, (c, key)
        ds = store.get(f"pred_{c}")
        assert ds.num_rows == n_test
        probs = np.array(list(ds.columns["probability"]))
        assert probs.shape == (n_test, 2)
        np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_metrics_match_the_jax_package(sweeps, family):
    jm = sweeps["jax"][3][family].metrics
    tm = sweeps["torch"][3][family].metrics
    tol = TOLERANCE[family]
    if tol == 0.0:
        assert tm["accuracy"] == pytest.approx(jm["accuracy"], abs=1e-12)
        assert tm["f1"] == pytest.approx(jm["f1"], abs=1e-12)
    else:
        assert abs(tm["accuracy"] - jm["accuracy"]) <= tol, (tm, jm)
        assert abs(tm["f1"] - jm["f1"]) <= tol + 0.01, (tm, jm)
    assert tm["accuracy"] > 0.7


def test_predict_with_a_saved_model(sweeps):
    _, store, mb, _ = sweeps["torch"]
    mb.predict("pred_gb", "test", "again")
    ds = store.get("again")
    assert ds.metadata.finished
    assert ds.num_rows == store.get("test").num_rows
    first = store.get("pred_gb").columns["prediction"]
    np.testing.assert_array_equal(ds.columns["prediction"], first)


def test_persistence_round_trip(sweeps):
    cfg, _, mb, _ = sweeps["torch"]
    reg = ModelRegistry(cfg)
    for c in FAMILIES:
        man, model = reg.load(f"pred_{c}")
        assert man["kind"] == c
        reg.save("copy", model, metrics={"x": 1.0},
                 preprocess=man["preprocess"])
        v1 = reg.version("copy")
        _, again = reg.load("copy")
        assert set(again.params) == set(model.params)
        for k, v in model.params.items():
            assert again.params[k].dtype == v.dtype
            assert torch.equal(again.params[k], v), (c, k)
        reg.save("copy", again)
        assert reg.version("copy")[0] > v1[0]


def test_unported_paths_raise(sweeps):
    cfg, store, mb, _ = sweeps["torch"]
    jmb = sweeps["jax"][2]
    # tx is ported: a build asking for it validates, as in the JAX package.
    jmb.validate("train", "test", ["tx"], "p2")
    mb.validate("train", "test", ["tx"], "p2")
    # Exec preprocessing is ported behind the JAX package's gate (off).
    assert not cfg.allow_exec_preprocessing
    with pytest.raises(PermissionError, match="disabled"):
        mb.build("train", "test", "p3", ["lr"], "Survived",
                 preprocessor_code="pass")
    # Tune is ported; what the JAX package refuses, this one refuses too:
    # a family with no population path, and a streamed design.
    with pytest.raises(ValueError, match="population"):
        mb.validate_tune("train", "t", "nb", [{}])
    # Neither package tunes tx or serves it online (token sequences are
    # not feature rows).
    for builder in (jmb, mb):
        with pytest.raises(ValueError, match="population"):
            builder.validate_tune("train", "t", "tx", [{}])
    with pytest.raises(ValueError, match="not servable online"):
        JaxAotModel("m", (0, 0), {"kind": "tx"}, None, (1,))
    with pytest.raises(ValueError, match="not servable online"):
        AotModel("m", (0, 0), {"kind": "tx"}, None, (1,), device="cpu")
    streamed = ModelBuilder(store, mb.runtime,
                            cfg.replace(stream_design=True))
    with pytest.raises(ValueError, match="resident design"):
        streamed.tune("train", "t", "gb", [{}], "Survived")
    assert not store.exists("t")


@pytest.mark.parametrize("knob", ["stream_design", "fit_ckpt_rounds"])
def test_streamed_and_checkpointed_builds_are_ported(sweeps, knob):
    """The knobs the builder once refused now build, with the resident
    sweep's predictions (nb and dt fit the same on either path)."""
    cfg, store, _, _ = sweeps["torch"]
    cfg2 = cfg.replace(**{knob: True if knob == "stream_design" else 1})
    mb = ModelBuilder(store, DeviceRuntime(cfg2, device="cpu"), cfg2)
    reports = mb.build("train", "test", f"k_{knob}", ["nb", "dt"],
                       "Survived", steps=STEPS)
    for r in reports:
        assert "error" not in r.metrics, r.metrics
        got = store.get(f"k_{knob}_{r.kind}").columns["prediction"]
        want = store.get(f"pred_{r.kind}").columns["prediction"]
        np.testing.assert_array_equal(got, want)


def test_cuda_runtime_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceRuntime(Settings())
