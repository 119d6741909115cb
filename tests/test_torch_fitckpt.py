"""Fit checkpoints (utils/fitckpt.py) in the PyTorch package, on the CPU.

1. Store semantics against the JAX package's module on the same files:
   either package reads what the other wrote, and both discard the same
   stale, mismatched, corrupt, future-epoch and half-committed
   checkpoints.
2. Resume: rf and gb fits crashed by the ``fit.ckpt.pre_rename``
   failpoint and resumed are bit-identical to the port's own
   uninterrupted fit (rf carries its generator state, gb replays its
   margin through ``tree_descend``); the streamed design state resumes
   at a pass boundary; a builder build with ``fit_ckpt_rounds=1`` gives
   exactly the disabled build's metrics and params, and a retried build
   resumes and records where from.
"""

import json
import os

import numpy as np
import pytest
import torch

from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.utils import failpoints as jfailpoints
from learningorchestra_tpu.utils import fitckpt as jfitckpt
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.jobs import JobManager
from learningorchestra_tpu_torch.models import trees
from learningorchestra_tpu_torch.models.builder import ModelBuilder
from learningorchestra_tpu_torch.ops import preprocess
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.serving.app import App
from learningorchestra_tpu_torch.utils import failpoints, fitckpt

MODULES = {"jax": (jfitckpt, JaxSettings), "torch": (fitckpt, Settings)}
PAIRS = [("torch", "torch"), ("torch", "jax"), ("jax", "torch")]


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    jfailpoints.reset()
    yield
    failpoints.reset()
    jfailpoints.reset()


def _cfg(tmp_path, pkg="torch", every=0):
    cfg = MODULES[pkg][1]()
    cfg.store_root = str(tmp_path / "store")
    cfg.persist = True
    cfg.fit_ckpt_rounds = every
    return cfg


def _ctx(tmp_path, pkg="torch", **kw):
    kw.setdefault("dataset", "d")
    kw.setdefault("family", "gb")
    kw.setdefault("config", {"v": 1})
    kw.setdefault("snapshot", "rows=10")
    kw.setdefault("every", 1)
    return MODULES[pkg][0].context(_cfg(tmp_path, pkg), **kw)


# -- 1. store semantics against the JAX module ------------------------------

@pytest.mark.parametrize("writer,reader", PAIRS)
def test_round_trip_and_prune(tmp_path, writer, reader):
    w = _ctx(tmp_path, writer)
    assert w.load() is None
    w.save(2, {"a": np.arange(4), "flag": np.array([True, False])},
           meta={"note": "x"})
    w.save(5, {"a": np.arange(10), "g": np.arange(16, dtype=np.uint8)})
    progress, arrays, meta = _ctx(tmp_path, reader).load()
    assert progress == 5 and meta["mesh_epoch"] == 0
    np.testing.assert_array_equal(arrays["a"], np.arange(10))
    assert arrays["g"].dtype == np.uint8
    # The JAX module's payload names and key hash are the port's.
    d = os.path.join(fitckpt.root_dir(_cfg(tmp_path)), "d__gb")
    assert sorted(os.listdir(d)) == ["ckpt-00000005.json",
                                     "ckpt-00000005.npz"]
    assert fitckpt.config_hash({"v": 1}) == jfitckpt.config_hash({"v": 1})
    _ctx(tmp_path, reader).clear()
    assert w.load() is None and not os.path.isdir(d)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_key_mismatch_discarded(tmp_path, writer, reader):
    _ctx(tmp_path, writer).save(3, {"a": np.arange(3)})
    before = MODULES[reader][0].counters_snapshot()["discarded"]
    assert _ctx(tmp_path, reader, config={"v": 2}).load() is None
    # The discard unlinks: even the original key finds nothing stale.
    assert _ctx(tmp_path, writer).load() is None
    assert MODULES[reader][0].counters_snapshot()["discarded"] == before + 1


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_corrupt_payload_discarded(tmp_path, writer, reader):
    _ctx(tmp_path, writer).save(1, {"a": np.arange(6)})
    payload = os.path.join(fitckpt.root_dir(_cfg(tmp_path)), "d__gb",
                           "ckpt-00000001.npz")
    with open(payload, "r+b") as f:           # flip one byte mid-file
        f.seek(os.path.getsize(payload) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    assert _ctx(tmp_path, reader).load() is None
    assert not os.path.exists(payload)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_epochs(tmp_path, monkeypatch, writer, reader):
    monkeypatch.setenv("LO_TPU_MESH_EPOCH", "3")
    _ctx(tmp_path, writer).save(2, {"a": np.arange(2)})
    # A later incarnation resumes what an earlier one wrote ...
    monkeypatch.setenv("LO_TPU_MESH_EPOCH", "4")
    got = _ctx(tmp_path, reader).load()
    assert got is not None and got[0] == 2 and got[2]["mesh_epoch"] == 3
    # ... an earlier one never resumes a newer incarnation's progress.
    monkeypatch.setenv("LO_TPU_MESH_EPOCH", "1")
    assert _ctx(tmp_path, reader).load() is None


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_interrupted_commit_keeps_the_previous_checkpoint(tmp_path, pkg):
    ctx = _ctx(tmp_path, pkg)
    fp = failpoints if pkg == "torch" else jfailpoints
    ctx.save(1, {"a": np.arange(4)})
    fp.configure("fit.ckpt.pre_rename=raise")
    with pytest.raises(fp.FailpointError):
        ctx.save(2, {"a": np.arange(8)})
    fp.reset()
    for reader in ("torch", "jax"):
        progress, arrays, _ = _ctx(tmp_path, reader).load()
        assert progress == 1
        np.testing.assert_array_equal(arrays["a"], np.arange(4))


def test_disabled_context_never_touches_disk(tmp_path):
    ctx = _ctx(tmp_path, every=0)
    ctx.save(1, {"a": np.arange(3)})
    assert ctx.load() is None
    assert fitckpt.disk_snapshot(_cfg(tmp_path)) == dict(
        {"files": 0, "bytes": 0}, **fitckpt.counters_snapshot())


def test_metrics_section(tmp_path):
    cfg = _cfg(tmp_path)
    cfg.image_root = str(tmp_path / "images")
    cfg.port = 0
    _ctx(tmp_path).save(1, {"a": np.arange(64)})
    app = App(cfg, recover=False, device="cpu")
    doc = app._metrics_doc()["fit_checkpoints"]
    assert doc["files"] == 2 and doc["bytes"] > 0
    assert set(doc) == set(jfitckpt.disk_snapshot(cfg))


# -- 2. resume parity ---------------------------------------------------------

def _split(seed, n, d=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.int32)
    return X, y


def _assert_params_equal(a, b, family):
    assert set(a) == set(b), family
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), \
            f"{family} param {k} diverged"


@pytest.mark.parametrize("family,hp,every,nth,resumed_at", [
    # 12 trees: two batches of 6, whose one boundary is the crash — the
    # rerun starts fresh.
    ("rf", {"n_trees": 12}, 1, 1, None),
    # 20 trees: batches of 5; the second boundary crashes, the resume
    # restores the generator after 5 trees.
    ("rf", {"n_trees": 20}, 1, 2, 5),
    # 7 rounds every 2: the second save crashes, the resume replays 2.
    ("gb", {"n_rounds": 7}, 2, 2, 2),
], ids=["rf12", "rf20", "gb7"])
def test_interrupted_fit_resumes_bit_identical(tmp_path, family, hp, every,
                                               nth, resumed_at):
    rt = DeviceRuntime(_cfg(tmp_path), device="cpu")
    fit = {"rf": trees.fit_rf, "gb": trees.fit_gb}[family]
    X, y = _split(0, 304)
    oracle = fit(rt, X, y, 2, max_depth=3, **hp)
    ctx = _ctx(tmp_path, family=family, every=every)
    failpoints.configure(f"fit.ckpt.pre_rename=raise:{nth}")
    with pytest.raises(failpoints.FailpointError):
        fit(rt, X, y, 2, max_depth=3, ckpt=ctx, **hp)
    failpoints.reset()
    got = ctx.load()
    assert (got and got[0]) == resumed_at
    resumes = fitckpt.counters_snapshot()["resumes"]
    resumed = fit(rt, X, y, 2, max_depth=3, ckpt=ctx, **hp)
    assert fitckpt.counters_snapshot()["resumes"] == resumes + (
        resumed_at is not None)
    _assert_params_equal(oracle.params, resumed.params, family)
    np.testing.assert_array_equal(oracle.predict_proba(rt, X),
                                  resumed.predict_proba(rt, X))


def test_gb_replay_is_the_fit_carry(tmp_path):
    rt = DeviceRuntime(_cfg(tmp_path), device="cpu")
    X, y = _split(1, 500)
    edges = trees._edge_prep(X, 32)["edges"]
    B = trees.bin_features(torch.from_numpy(X), torch.from_numpy(edges))
    yf = torch.from_numpy(y).float()
    (feat, thr, internal, leaf_val), margin = trees._fit_gbt(
        B, yf, max_depth=4, n_bins=32, n_rounds=5)
    replay = trees._gbt_replay_margin(B, feat, thr, internal, leaf_val,
                                      max_depth=4, step_size=0.1)
    assert torch.equal(replay, margin)


def test_a_checkpoint_of_another_shape_is_cleared(tmp_path):
    rt = DeviceRuntime(_cfg(tmp_path), device="cpu")
    X, y = _split(2, 200)
    ctx = _ctx(tmp_path, family="rf", every=1)
    ctx.save(3, {"feat": np.zeros((3, 15), np.int32)})   # not a boundary
    oracle = trees.fit_rf(rt, X, y, 2, n_trees=20, max_depth=3)
    got = trees.fit_rf(rt, X, y, 2, n_trees=20, max_depth=3, ckpt=ctx)
    _assert_params_equal(oracle.params, got.params, "rf")


def test_design_state_resumes_at_a_pass_boundary(tmp_path):
    cfg = _cfg(tmp_path, every=1)
    store = DatasetStore(cfg)
    rng = np.random.default_rng(0)
    n = 500
    store.create("d", columns={
        "a": np.where(rng.random(n) < 0.1, np.nan, rng.normal(size=n)),
        "b": np.array([f"s{i % 3}" for i in range(n)], dtype=object),
        "label": (rng.normal(size=n) > 0).astype(np.int64)})
    ds = store.get("d")
    # Three fusion groups → two checkpointed pass boundaries.
    steps = [{"op": "fillna", "strategy": "mean"}, {"op": "standardize"},
             {"op": "standardize"}]
    Xo, yo, ffo, so = preprocess.design_matrix_streamed(ds, "label", steps)
    ctx = _ctx(tmp_path, family="design", config={"steps": steps})
    failpoints.configure("fit.ckpt.pre_rename=raise:2")
    with pytest.raises(failpoints.FailpointError):
        preprocess.design_matrix_streamed(ds, "label", steps, ckpt=ctx)
    failpoints.reset()
    resumes = fitckpt.counters_snapshot()["resumes"]
    prof = {}
    Xr, yr, ffr, sr = preprocess.design_matrix_streamed(
        ds, "label", steps, ckpt=ctx, profile=prof)
    assert prof["fit_passes"] == 2         # pass 1 was not run again
    assert fitckpt.counters_snapshot()["resumes"] == resumes + 1
    assert ffo == ffr
    np.testing.assert_array_equal(yo, yr)
    np.testing.assert_array_equal(Xo.rows(0, n), Xr.rows(0, n))
    assert json.dumps(so, sort_keys=True) == json.dumps(sr, sort_keys=True)


# -- 3. through the builder ---------------------------------------------------

FAMILIES = ["lr", "nb", "dt", "rf", "gb"]
HPARAMS = {"gb": {"n_rounds": 4, "max_depth": 3},
           "rf": {"n_trees": 12, "max_depth": 3},
           "lr": {"iters": 5}}


def _builder(root, every, stream=False, seeds=(0, 1)):
    cfg = _cfg(root, every=every)
    cfg.stream_design = stream
    store = DatasetStore(cfg)
    for name, seed, n in (("train", seeds[0], 400), ("test", seeds[1], 200)):
        X, y = _split(seed, n)
        store.create(name, columns={
            **{f"f{i}": X[:, i] for i in range(X.shape[1])},
            "label": y.astype(np.int64)}, finished=True)
    return cfg, store, ModelBuilder(store, DeviceRuntime(cfg, device="cpu"),
                                    cfg)


@pytest.mark.parametrize("stream", [False, True], ids=["resident",
                                                       "streamed"])
def test_checkpointed_build_matches_the_disabled_build(tmp_path, stream):
    out = {}
    for tag, every in (("o", 0), ("c", 1)):
        cfg, _, mb = _builder(tmp_path / tag, every, stream)
        reports = mb.build("train", "test", "pred", FAMILIES, "label",
                           hparams=HPARAMS)
        out[tag] = (cfg, mb, {r.kind: r.metrics for r in reports})
    _, mb_o, met_o = out["o"]
    cfg_c, mb_c, met_c = out["c"]
    for fam in FAMILIES:
        assert "error" not in met_o[fam], met_o[fam]
        mo = {k: v for k, v in met_o[fam].items() if k != "device_s"}
        mc = {k: v for k, v in met_c[fam].items() if k != "device_s"}
        assert mo == mc, f"{fam}: metrics diverged\n{mo}\n{mc}"
        _, model_o = mb_o.registry.load(f"pred_{fam}")
        _, model_c = mb_c.registry.load(f"pred_{fam}")
        _assert_params_equal(model_o.params, model_c.params, fam)
    # Completed families reclaimed their checkpoint streams.
    assert fitckpt.disk_snapshot(cfg_c)["files"] == 0


def test_retried_build_resumes_and_records_provenance(tmp_path):
    cfg, store, mb = _builder(tmp_path / "c", 1, seeds=(3, 4))
    hp = {"gb": {"n_rounds": 6, "max_depth": 3}}
    failpoints.configure("fit.ckpt.pre_rename=raise:3")
    mb.build("train", "test", "pred", ["gb"], "label", hparams=hp)
    failpoints.reset()
    doc = store.get("pred_gb").metadata
    assert doc.finished and doc.error       # the family failed mid-fit
    # Retry as serving/app.py does: reopen, then run again as a job.
    store.reopen("pred_gb")
    jm = JobManager(store, cfg=cfg)
    rec = jm.submit("retry_model_builder", ["pred_gb"],
                    lambda: mb.build("train", "test", "pred", ["gb"],
                                     "label", hparams=hp, existing=True))
    jm.wait_all(timeout=120)
    assert rec.status == "done", rec.error
    resumed = rec.profile.get("resumed_from", {}).get("gb")
    assert resumed and resumed["rounds"] == 2 and resumed["of"] == 6, \
        rec.profile
    _, _, mb_o = _builder(tmp_path / "o", 0, seeds=(3, 4))
    mb_o.build("train", "test", "pred", ["gb"], "label", hparams=hp)
    _, model_o = mb_o.registry.load("pred_gb")
    _, model_c = mb.registry.load("pred_gb")
    _assert_params_equal(model_o.params, model_c.params, "gb")
