"""The streamed (out-of-core) build and exec preprocessing, in both
packages on the CPU.

The same seeded columns go into each package's catalog. The JAX side
runs on the 8-device CPU mesh of tests/conftest.py with its Pallas tree
kernels in interpret mode, the PyTorch side on ``device="cpu"``.
Tolerances:

- streamed state and matrix: rtol 1e-6, atol 1e-9 (label vocabularies
  and encoded labels exact), as tests/test_streamed_design.py holds the
  JAX package's streamed path to its resident one;
- the runtime's block feed: ``torch.equal`` to the resident matrix's
  device copy, serial and prefetched, and equal to the JAX package's
  ``shard_chunked`` array;
- an over-budget build: lr and nb probabilities rtol 1e-4, atol 1e-5;
- a streamed dt with the JAX package's edges: bit-identical trees;
- exec preprocessing: the same 403 and ``PermissionError`` with the gate
  off; with it on, the same X/y (exact) and nb probabilities (rtol 1e-5,
  atol 1e-7, as tests/test_torch_models.py holds nb).
"""

import gc
import threading

import numpy as np
import pytest
import torch

from learningorchestra_tpu.catalog.store import DatasetStore as JaxStore
from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.models import trees as jtrees
from learningorchestra_tpu.models.builder import ModelBuilder as JaxBuilder
from learningorchestra_tpu.ops import preprocess as jpreprocess
from learningorchestra_tpu.parallel.mesh import MeshRuntime
from learningorchestra_tpu.serving.app import App as JaxApp
from learningorchestra_tpu_torch.catalog import readpipe
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models import trees
from learningorchestra_tpu_torch.models.builder import ModelBuilder
from learningorchestra_tpu_torch.ops import preprocess
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.serving.app import App
from tests.test_torch_builder import _columns
from tests.titanic_data import titanic_rows

STEPS3 = [{"op": "label_encode"},
          {"op": "fillna", "strategy": "mean"},
          {"op": "standardize"}]


def _chunks(n, chunk, seed):
    """Multi-chunk mixed columns: floats with NaNs, strings with Nones,
    ints, and a binary label (tests/test_streamed_design.py's data)."""
    rng = np.random.default_rng(seed)
    cats = np.array(["a", "b", "c", None], dtype=object)
    out = []
    for off in range(0, n, chunk):
        k = min(chunk, n - off)
        num = rng.normal(size=k)
        num[rng.random(k) < 0.1] = np.nan
        out.append({
            "num": num,
            "cat": cats[rng.integers(0, 4, size=k)],
            "intc": rng.integers(0, 9, size=k),
            "y": (rng.random(k) < 0.5).astype(np.int64),
        })
    return out


def _fill(store, name, n, chunk, seed):
    ds = store.create(name)
    for cols in _chunks(n, chunk, seed):
        ds.append_columns(cols)
    store.finish(name)
    return store.get(name)


def _cfg(cls, root, **kw):
    cfg = cls()
    cfg.store_root = str(root / "store")
    cfg.image_root = str(root / "images")
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One catalog per package (RAM only), filled by ``_fill`` on demand."""
    return {"jax": JaxStore(_cfg(JaxSettings, tmp_path_factory.mktemp("j"),
                                 persist=False)),
            "torch": DatasetStore(_cfg(Settings, tmp_path_factory.mktemp("t"),
                                       persist=False))}


@pytest.fixture(scope="module")
def trt():
    return DeviceRuntime(Settings(), device="cpu")


@pytest.fixture(scope="module")
def jrt():
    return MeshRuntime(JaxSettings())


def _both(stores, name, n, chunk, seed):
    return (_fill(stores["jax"], name, n, chunk, seed),
            _fill(stores["torch"], name, n, chunk, seed))


# -- the streamed design state and matrix -------------------------------------

def _assert_state_close(got, want):
    assert set(got) == set(want)
    for key, v in want.items():
        if key == "__label_vocab__" or key.endswith("label_encode"):
            assert got[key] == v, key
            continue
        assert set(got[key]) == set(v), key
        for f, x in v.items():
            np.testing.assert_allclose(np.asarray(got[key][f], np.float64),
                                       np.asarray(x, np.float64),
                                       rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("steps", [STEPS3, ()], ids=["3step", "default"])
def test_streamed_state_and_matrix_match_jax(stores, steps):
    name = f"eq{len(steps)}"
    jds, tds = _both(stores, name, 3000, 256, 0)
    Xj, yj, ffj, sj = jpreprocess.design_matrix_streamed(jds, "y", steps)
    prof = {}
    Xt, yt, fft, st = preprocess.design_matrix_streamed(tds, "y", steps,
                                                        profile=prof)
    assert fft == ffj
    np.testing.assert_array_equal(yt, yj)
    _assert_state_close(st, sj)
    assert Xt.shape == Xj.shape
    np.testing.assert_allclose(Xt.rows(0, len(Xt)), Xj.rows(0, len(Xj)),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(Xt.rows(700, 1900), Xj.rows(700, 1900),
                               rtol=1e-6, atol=1e-9)
    assert prof["fit_passes"] == (2 if steps else 1)


def test_streamed_test_split_applies_the_train_state(stores):
    jtr, ttr = _both(stores, "tr", 2000, 256, 1)
    jte, tte = _both(stores, "te", 700, 256, 2)
    _, _, ff, state = preprocess.design_matrix(ttr, "y")
    _, _, jff, jstate = jpreprocess.design_matrix(jtr, "y")
    assert ff == jff
    Xr, _, _, _ = preprocess.design_matrix(tte, "y", state=state,
                                           feature_fields=ff)
    Xs, ys, _, _ = preprocess.design_matrix_streamed(
        tte, "y", state=state, feature_fields=ff)
    Xj, yj, _, _ = jpreprocess.design_matrix_streamed(
        jte, "y", state=jstate, feature_fields=jff)
    np.testing.assert_allclose(Xs.rows(0, len(Xs)), Xr, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(Xs.rows(0, len(Xs)), Xj.rows(0, len(Xj)),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(ys, yj)


# -- the runtime's block feed -------------------------------------------------

def _spy_rows(X):
    calls = []
    real = X.rows

    def spy(start, stop):
        calls.append((start, stop))
        return real(start, stop)

    X.rows = spy
    return calls


@pytest.mark.parametrize("prefetch", [0, 2], ids=["serial", "prefetched"])
def test_feed_reads_blocks_and_equals_the_resident_copy(stores, jrt,
                                                        prefetch):
    jds, tds = _both(stores, f"sh{prefetch}", 1037, 200, 3)
    Xr, _, _, _ = preprocess.design_matrix(tds, "y")
    Xs, _, _, _ = preprocess.design_matrix_streamed(tds, "y")
    rt = DeviceRuntime(Settings(), device="cpu")
    rt.cfg.prefetch_chunks = prefetch
    rt.FEED_BLOCK_ROWS = 100
    calls = _spy_rows(Xs)
    rp0 = readpipe.snapshot()
    dev_s, n_s = rt.shard_rows(Xs)
    rp1 = readpipe.snapshot()
    dev_r, n_r = rt.shard_rows(np.array(Xr, np.float32))
    assert n_s == n_r == 1037
    assert dev_s.dtype == torch.float32
    assert torch.equal(dev_s, dev_r)
    assert max(b - a for a, b in calls) <= 100
    assert sorted(calls) == [(a, min(a + 100, 1037))
                             for a in range(0, 1037, 100)]
    ahead = rp1["prefetched_chunks"] - rp0["prefetched_chunks"]
    assert ahead == (0 if prefetch == 0 else 10)
    # The JAX package's shard_chunked fills its mesh from the same rows.
    Xj, _, _, _ = jpreprocess.design_matrix_streamed(jds, "y")
    dev_j, n_j = jrt.shard_rows(Xj)
    np.testing.assert_array_equal(dev_s.numpy(), np.asarray(dev_j)[:n_j])


def test_feed_is_one_copy_for_every_family_thread(stores):
    _, tds = _both(stores, "th", 900, 200, 4)
    Xs, _, _, _ = preprocess.design_matrix_streamed(tds, "y")
    rt = DeviceRuntime(Settings(), device="cpu")
    rt.FEED_BLOCK_ROWS = 128
    calls = _spy_rows(Xs)
    got = [None] * 5
    barrier = threading.Barrier(5)

    def family(i):
        barrier.wait(timeout=30)
        got[i] = rt.shard_rows(Xs)[0]

    threads = [threading.Thread(target=family, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert all(g is got[0] for g in got)
    assert len(calls) == 8                       # one feed, 8 blocks
    key = ("design", id(Xs))
    assert key in rt._transfer_cache
    del Xs, calls
    gc.collect()
    assert key not in rt._transfer_cache         # evicted with the design


def test_feed_surfaces_a_failed_read(stores):
    _, tds = _both(stores, "bad", 500, 100, 5)
    Xs, _, _, _ = preprocess.design_matrix_streamed(tds, "y")
    rt = DeviceRuntime(Settings(), device="cpu")
    rt.cfg.prefetch_chunks = 2
    rt.FEED_BLOCK_ROWS = 100
    real = Xs.rows

    def rows(start, stop):
        if start == 300:
            raise OSError("chunk unreadable")
        return real(start, stop)

    Xs.rows = rows
    errors = readpipe.snapshot()["worker_errors"]
    with pytest.raises(OSError, match="unreadable"):
        rt.shard_rows(Xs)
    assert readpipe.snapshot()["worker_errors"] == errors + 1
    assert not rt._transfer_cache


# -- the over-budget build ----------------------------------------------------

@pytest.fixture(scope="module")
def over_budget(tmp_path_factory):
    """lr, nb and gb built in both packages on train/test sets over their
    1 MiB RAM budget, with consolidation of either forbidden."""
    out = {}
    for pkg, (S, Store, Builder, runtime) in {
            "jax": (JaxSettings, JaxStore, JaxBuilder, MeshRuntime),
            "torch": (Settings, DatasetStore, ModelBuilder,
                      lambda cfg: DeviceRuntime(cfg, device="cpu")),
    }.items():
        cfg = _cfg(S, tmp_path_factory.mktemp(pkg), persist=True,
                   ram_budget_mb=1)
        store = Store(cfg)
        tr = _fill(store, "btr", 40_000, 4000, 3)
        te = _fill(store, "bte", 12_000, 4000, 4)
        assert tr.over_budget and te.over_budget
        guarded = {"btr", "bte"}
        cls = type(tr)
        orig = cls._consolidate_locked

        def no_consolidate(self, orig=orig):
            assert self.metadata.name not in guarded, (
                f"{self.metadata.name} consolidated on the streamed path")
            return orig(self)

        mp = pytest.MonkeyPatch()
        mp.setattr(cls, "_consolidate_locked", no_consolidate)
        try:
            builder = Builder(store, runtime(cfg), cfg)
            reports = builder.build(
                "btr", "bte", "pred", ["lr", "nb", "gb"], "y",
                hparams={"lr": {"iters": 30},
                         "gb": {"n_rounds": 4, "max_depth": 3}})
            probs = {c: np.stack(store.get(f"pred_{c}").read_rows(
                ["probability"], 0, 12_000)["probability"]).astype(np.float64)
                for c in ("lr", "nb", "gb")}
        finally:
            mp.undo()
        out[pkg] = (store, {r.kind: r for r in reports}, probs)
    return out


def test_over_budget_build_never_consolidates(over_budget):
    store, reports, probs = over_budget["torch"]
    for kind in ("lr", "nb", "gb"):
        assert "error" not in reports[kind].metrics, reports[kind].metrics
        out = store.get(f"pred_{kind}")
        assert out.metadata.finished is True
        assert out.num_rows == 12_000
        preds = out.read_rows(["prediction"], 0, 12_000)["prediction"]
        np.testing.assert_array_equal(preds, np.argmax(probs[kind], 1))
        assert probs[kind].shape == (12_000, 2)


@pytest.mark.parametrize("kind", ["lr", "nb"])
def test_over_budget_probabilities_match_jax(over_budget, kind):
    got = over_budget["torch"][2][kind]
    want = over_budget["jax"][2][kind]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_streamed_dt_with_jax_edges_is_the_jax_tree(stores, jrt, trt):
    jds, tds = _both(stores, "dt", 2500, 300, 6)
    Xj, yj, _, _ = jpreprocess.design_matrix_streamed(jds, "y", STEPS3)
    Xt, yt, _, _ = preprocess.design_matrix_streamed(tds, "y", STEPS3)
    edges = jtrees._edge_prep(Xj, n_bins=16)["edges"]
    np.testing.assert_allclose(trees._edge_prep(Xt, n_bins=16)["edges"],
                               edges, rtol=1e-6, atol=1e-9)
    jm = jtrees.fit_dt(jrt, Xj, yj, 2, max_depth=4, n_bins=16, edges=edges)
    tm = trees.fit_dt(trt, Xt, yt, 2, max_depth=4, n_bins=16, edges=edges)
    for k in ("feat", "thr", "internal", "leaf"):
        np.testing.assert_array_equal(tm.params[k].numpy(),
                                      np.asarray(jm.params[k]), err_msg=k)
    # Its predict reads the lazy design through the same feed.
    np.testing.assert_allclose(tm.predict_proba(trt, Xt),
                               jm.predict_proba(jrt, Xj), rtol=1e-6,
                               atol=1e-7)


# -- exec preprocessing -------------------------------------------------------

#: The Titanic exec code of tests/test_builder.py.
EXEC_CODE = """
import numpy as np
def prep(df):
    X = df[["Pclass", "Fare"]].to_numpy(dtype="float32")
    X = np.nan_to_num(X)
    return X
features_training = prep(training_df)
labels_training = training_df["Survived"].to_numpy()
features_testing = prep(testing_df)
labels_testing = testing_df["Survived"].to_numpy()
"""


@pytest.fixture(scope="module")
def titanic(tmp_path_factory):
    """Titanic train/test sets in both packages' catalogs, each with a
    builder whose exec gate is ON; returns {pkg: (cfg, store, builder)}."""
    train = _columns(titanic_rows(scale=1.0, seed=7))
    test = _columns(titanic_rows(scale=418.0 / 891.0, seed=99))
    out = {}
    for pkg, (S, Store, Builder, runtime) in {
            "jax": (JaxSettings, JaxStore, JaxBuilder, MeshRuntime),
            "torch": (Settings, DatasetStore, ModelBuilder,
                      lambda cfg: DeviceRuntime(cfg, device="cpu")),
    }.items():
        cfg = _cfg(S, tmp_path_factory.mktemp(pkg),
                   allow_exec_preprocessing=True)
        store = Store(cfg)
        store.create("train", columns=dict(train), finished=True)
        store.create("test", columns=dict(test), finished=True)
        out[pkg] = (cfg, store, Builder(store, runtime(cfg), cfg))
    return out


def test_exec_gate_off_raises_in_both_builders(titanic):
    for pkg, (cfg, store, mb) in titanic.items():
        cfg.allow_exec_preprocessing = False
        try:
            with pytest.raises(PermissionError, match="disabled"):
                mb.build("train", "test", f"gate_{pkg}", ["nb"], "Survived",
                         preprocessor_code=EXEC_CODE)
        finally:
            cfg.allow_exec_preprocessing = True
        assert not store.exists(f"gate_{pkg}_nb")


def test_exec_gives_the_same_design(titanic):
    got = {}
    for pkg, mod in (("jax", jpreprocess), ("torch", preprocess)):
        cfg, store, _ = titanic[pkg]
        got[pkg] = mod.exec_preprocess(EXEC_CODE, store.get("train"),
                                       store.get("test"), "Survived",
                                       cfg=cfg)
    for a, b in zip(got["torch"], got["jax"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got["torch"][0].shape == (891, 2)


def test_exec_build_gives_the_same_nb_probabilities(titanic):
    probs = {}
    for pkg, (cfg, store, mb) in titanic.items():
        reports = mb.build("train", "test", "ex", ["nb"], "Survived",
                           preprocessor_code=EXEC_CODE)
        assert "error" not in reports[0].metrics, reports[0].metrics
        assert reports[0].metrics["accuracy"] > 0.4
        ds = store.get("ex_nb")
        assert ds.metadata.finished and not ds.metadata.error
        probs[pkg] = np.array(list(ds.columns["probability"]), np.float64)
    # nb's tolerance of tests/test_torch_models.py (probabilities of
    # 1e-15 differ by 1e-20 there).
    np.testing.assert_allclose(probs["torch"], probs["jax"], rtol=1e-5,
                               atol=1e-7)


def test_exec_child_never_loads_jax_or_torch(titanic):
    cfg, store, _ = titanic["torch"]
    code = """
import sys
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "learningorchestra_tpu", "torch")]
features_training = np.full((len(training_df), 1), float(len(bad)))
labels_training = training_df["Survived"].to_numpy()
features_testing = np.zeros((len(testing_df), 1))
"""
    X, y, _, _ = preprocess.exec_preprocess(code, store.get("train"),
                                            store.get("test"), "Survived",
                                            cfg=cfg)
    assert X.shape == (891, 1) and float(X.max()) == 0.0


def test_exec_errors_fail_cleanly(titanic):
    cfg, store, _ = titanic["torch"]
    args = (store.get("train"), store.get("test"), "Survived")
    with pytest.raises(preprocess.PreprocessError, match="must define"):
        preprocess.exec_preprocess("x = 1", *args, cfg=cfg)
    with pytest.raises(preprocess.PreprocessError, match="ZeroDivision"):
        preprocess.exec_preprocess("1 / 0", *args, cfg=cfg)


def test_exec_gate_off_is_a_403_from_both_apps(tmp_path):
    body = {"training_filename": "t", "test_filename": "t",
            "prediction_filename": "p", "classificators_list": ["nb"],
            "label": "Survived", "preprocessor_code": "x = 1"}
    cols = _columns(titanic_rows(scale=0.1, seed=3))
    for pkg, make in (("jax", lambda cfg: JaxApp(cfg, recover=False)),
                      ("torch", lambda cfg: App(cfg, recover=False,
                                                device="cpu"))):
        cls = JaxSettings if pkg == "jax" else Settings
        app = make(_cfg(cls, tmp_path / pkg, port=0, persist=False))
        app.store.create("t", columns=dict(cols), finished=True)
        server = app.serve(background=True)
        try:
            import requests

            r = requests.post(f"http://127.0.0.1:{server.port}/models",
                              json=body, timeout=60)
            assert r.status_code == 403, (pkg, r.text)
            assert "disabled" in r.json()["result"]
        finally:
            app.jobs.wait_all(timeout=60)
            server.stop()
        assert not app.store.exists("p_nb")
