"""The PyTorch package's device accounting and observability planes
against the JAX package's, on the CPU.

- flops: every family's FLOP and byte models equal the JAX package's
  kernel-path formulas (``tree_kernel=True``) over a grid of shapes and
  hyperparameters, and mfu / bw_util agree given the same peaks;
- alerts and telemetry history: one sequence of metrics documents under
  an injected clock gives the same transitions, snapshots and queries in
  both packages, and a history segment written by either package is
  read back by the other;
- Prometheus exposition and the status page: ``render`` of one document
  is byte-identical in both packages;
- flight recorder: the same bundle files and manifest keys; the port's
  manifest names torch, its CUDA version and the device; the batcher's
  quarantine and the job watchdog each dump a bundle;
- resources: ``process_snapshot`` has the JAX key set, a served lr/nb
  sweep's job profile has ``peak_hbm_bytes > 0`` (``live_buffers`` on
  the CPU), compile accounting counts the bucket warm-ups and a kernel
  library found built, and
  ``POST /debug/profile`` is gated, validated, captures a trace and
  refuses a second capture while one runs.
"""

import itertools
import json
import os
import threading
import time

import numpy as np
import pytest
import requests

from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.models import flops as jflops
from learningorchestra_tpu.serving import status_page as jstatus
from learningorchestra_tpu.utils import alerts as jalerts
from learningorchestra_tpu.utils import flightrec as jflightrec
from learningorchestra_tpu.utils import prometheus as jprom
from learningorchestra_tpu.utils import resources as jresources
from learningorchestra_tpu.utils import timeseries as jtimeseries
from learningorchestra_tpu_torch import config
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.jobs import JobManager
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.models import flops
from learningorchestra_tpu_torch.parallel import spmd
from learningorchestra_tpu_torch.serving import status_page
from learningorchestra_tpu_torch.serving.app import App
from learningorchestra_tpu_torch.utils import (
    alerts, failpoints, flightrec, prometheus, resources, timeseries)

FAMILIES = ("lr", "nb", "dt", "rf", "gb")

#: (n, d, classes) × hparams grid the FLOP models are compared over.
SHAPES = [(1000, 4, 2), (11_000_000, 28, 2), (60_000, 784, 10),
          (257, 3, 3)]
HPARAMS = {
    "lr": [{}, {"solver": "newton", "iters": 7}, {"solver": "adam",
                                                  "iters": 50}],
    "nb": [{}],
    "dt": [{}, {"max_depth": 8, "n_bins": 64}],
    "rf": [{}, {"n_trees": 3, "max_depth": 4, "n_bins": 16}],
    "gb": [{}, {"n_rounds": 7, "max_depth": 3, "n_bins": 128}],
    "mlp": [{}, {"hidden": 32, "iters": 40}],
}


@pytest.mark.parametrize("kind", FAMILIES + ("mlp",))
def test_flops_equal_the_jax_kernel_path(kind):
    for (n, d, c), hp in itertools.product(SHAPES, HPARAMS[kind]):
        case = (kind, n, d, c, hp)
        assert flops.fit_flops(kind, n, d, c, hp) == jflops.fit_flops(
            kind, n, d, c, hp, tree_kernel=True), case
        assert flops.predict_flops(kind, n, d, c, hp) == \
            jflops.predict_flops(kind, n, d, c, hp), case
        assert flops.build_flops(kind, n, n // 10, d, c, hp) == \
            jflops.build_flops(kind, n, n // 10, d, c, hp,
                               tree_kernel=True), case
        fb = flops.fit_bytes(kind, n, d, c, hp)
        assert fb == jflops.fit_bytes(kind, n, d, c, hp,
                                      tree_kernel=True), case
        f = flops.fit_flops(kind, n, d, c, hp)
        for device_s in (0.0, 0.25, 3.0):
            assert flops.mfu(f, device_s, peak_flops=67e12) == \
                jflops.mfu(f, device_s, peak_flops=67e12), case
            assert flops.bw_util(fb, device_s, peak_bw=3.35e12) == \
                jflops.bw_util(fb, device_s, peak_bw=3.35e12), case


def test_peaks_are_the_h100_figures(monkeypatch):
    monkeypatch.delenv("LO_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("LO_TPU_PEAK_BW", raising=False)
    assert config.peak_flops() == 0.0 and config.peak_bw() == 0.0
    assert flops.H100_PEAK_FP32 == 67e12 and flops.H100_HBM_BW == 3.35e12
    assert flops.mfu(67e12, 1.0) == pytest.approx(
        67e12 / (flops.PEAK_FLOPS or 1.0))
    monkeypatch.setenv("LO_TPU_PEAK_FLOPS", "1e15")
    monkeypatch.setenv("LO_TPU_PEAK_BW", "2e12")
    assert config.peak_flops() == 1e15 and config.peak_bw() == 2e12
    monkeypatch.setenv("LO_TPU_PEAK_BW", "fast")
    assert config.peak_bw() == 0.0


# -- alerts and telemetry history ---------------------------------------------

def _obs_cfg(cls, root, **kw):
    cfg = cls()
    cfg.store_root = str(root)
    cfg.telemetry_sample_s = 0.0           # a sample per observe()
    cfg.telemetry_ring_samples = 16
    cfg.telemetry_segment_samples = 5
    cfg.telemetry_retention_segments = 3
    cfg.alert_window_s = 10.0
    cfg.slo_burn_fast_s = 60.0
    cfg.slo_burn_slow_s = 300.0
    cfg.slo_p99_ms = 100.0
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _docs(n, seed=0):
    """A seeded run of metrics documents: a p99 spike, rejections, a
    quarantine, a corruption increment and low disk, then recovery."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bad = 8 <= i < 20
        p99 = float(rng.uniform(300, 600) if bad else rng.uniform(5, 50))
        out.append({
            "serving": {
                "requests": 10 * i, "rejected": 3 * i if bad else 0,
                "deadline_exceeded": i if 12 <= i < 18 else 0,
                "models": {"m": {"p99_ms": round(p99, 3), "qps": 2.5,
                                 "quarantined": int(14 <= i < 22)}}},
            "integrity": {"chunks_corrupt": 1 if i >= 16 else 0},
            "resources": {"host": {"rss_bytes": 1000 + i},
                          "disk": {"free_bytes": (1 << 20) if bad
                                   else (1 << 40)}},
            "alerts": {"ignored": True},
        })
    return out


def _without_since(snap):
    """An engine snapshot without the rules' ``since``: the wall time at
    which each evaluation ran, not a function of the injected clock."""
    return {**snap, "rules": {name: {k: v for k, v in rule.items()
                                     if k != "since"}
                              for name, rule in snap["rules"].items()}}


def test_alerts_and_history_match_the_jax_package(tmp_path):
    eng = {}
    for pkg, cls, ts, al in (("jax", JaxSettings, jtimeseries, jalerts),
                             ("torch", Settings, timeseries, alerts)):
        cfg = _obs_cfg(cls, tmp_path / pkg, alert_for_windows=2,
                       alert_clear_windows=2)
        hist = ts.TelemetryHistory(cfg)
        eng[pkg] = (hist, al.default_engine(cfg, history=hist))
    t0 = 1_700_000_000.0
    for i, doc in enumerate(_docs(30)):
        now = t0 + 6.0 * i
        got = {}
        for pkg, (hist, engine) in eng.items():
            hist.observe(doc, now=now)
            got[pkg] = (engine.observe(doc, now=now),
                        _without_since(engine.snapshot()), engine.firing())
        assert got["jax"] == got["torch"], i
    (jh, je), (th, te) = eng["jax"], eng["torch"]
    assert je.snapshot()["firing"] == te.snapshot()["firing"]
    for series, window in ((None, None), (["serving.requests"], 60.0),
                           (["resources.host.rss_bytes",
                             "serving.models.m.p99_ms"], 1e6)):
        now = t0 + 6.0 * 30
        assert th.query(series=series, window_s=window, now=now) == \
            jh.query(series=series, window_s=window, now=now)
    ts_snap, js_snap = th.snapshot(), jh.snapshot()
    assert {k: v for k, v in ts_snap.items() if k != "root"} == \
        {k: v for k, v in js_snap.items() if k != "root"}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_history_segments_read_back_by_the_other_package(tmp_path, writer):
    mods = {"jax": (JaxSettings, jtimeseries),
            "torch": (Settings, timeseries)}
    reader = "torch" if writer == "jax" else "jax"
    t0 = time.time() - 3600
    wcls, wts = mods[writer]
    # Retention keeps every segment, so the reader's disk holds what the
    # writer's ring and disk hold.
    w = wts.TelemetryHistory(_obs_cfg(wcls, tmp_path,
                                      telemetry_retention_segments=10))
    for i, doc in enumerate(_docs(23)):
        assert w.observe(doc, now=t0 + 10.0 * i)
    w.flush()
    want = w.query(window_s=7200)
    rcls, rts = mods[reader]
    r = rts.TelemetryHistory(_obs_cfg(rcls, tmp_path,
                                      telemetry_retention_segments=10))
    got = r.query(window_s=7200)
    assert got["series"] and got["series"] == want["series"]
    assert got["samples"] == want["samples"] == 23


# -- one document, rendered by both packages ----------------------------------

ROW = {"x0": 0.5, "x1": -0.2, "x2": 1.1, "x3": 0.3}


def _cfg(root, **kw):
    cfg = Settings()
    cfg.store_root = str(root / "store")
    cfg.image_root = str(root / "images")
    cfg.port = 0
    cfg.persist = True
    cfg.serve_max_batch = 64
    cfg.alert_window_s = 0.0
    cfg.alert_for_windows = 1
    cfg.alert_clear_windows = 1
    cfg.telemetry_sample_s = 0.0
    cfg.flightrec_min_interval_s = 0.0
    cfg.serve_restart_backoff_s = 0.01
    cfg.serve_quarantine_crashes = 2
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data(app, names=("res_train", "res_test")):
    rng = np.random.default_rng(0)
    n = 400
    y = rng.integers(0, 2, n)
    X = rng.normal(size=(n, 4)) + y[:, None]
    cols = {f"x{j}": X[:, j] for j in range(4)}
    cols["label"] = y.astype(np.int64)
    for name in names:
        app.store.create(name, columns={k: v.copy() for k, v in cols.items()})
        app.store.finish(name)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's server (CPU) with two datasets and an lr model."""
    tmp = tmp_path_factory.mktemp("obs")
    app = App(_cfg(tmp), recover=False, device="cpu")
    _data(app)
    app.builder.build("res_train", "res_test", "om", ["lr"], "label")
    server = app.serve(background=True)
    base = f"http://127.0.0.1:{server.port}"
    assert requests.post(f"{base}/trained-models/om_lr/predict",
                         json={"rows": [ROW]}, timeout=30).status_code == 200
    yield base, app
    app.jobs.wait_all(timeout=120)
    server.stop()


def test_prometheus_and_status_page_render_byte_identical(served):
    base, app = served
    for _ in range(3):
        requests.get(f"{base}/metrics", timeout=30)
    doc = requests.get(f"{base}/metrics", timeout=30).json()
    assert prometheus.render(doc) == jprom.render(doc)
    text = requests.get(f"{base}/metrics", params={"format": "prometheus"},
                        timeout=30).text
    samples = [ln for ln in text.splitlines() if ln and ln[0] != "#"]
    assert any(ln.startswith("lo_serving_") for ln in samples)
    for ln in samples:
        float(ln.rsplit(" ", 1)[1])
    info = {"process_index": 0, "process_count": 1, "device": "cpu",
            "mesh": {"data": 1}}
    hist = app.history.query(series=["serving.qps", "serving.requests",
                                     "resources.host.rss_bytes"])
    args = (info, app.jobs.records(), app.store.metadata_docs())
    kw = dict(serving=doc.get("serving"), alerts=doc.get("alerts"),
              resources=doc.get("resources"),
              attribution=doc.get("latency_attribution"), history=hist)
    assert status_page.render_status(*args, **kw) == \
        jstatus.render_status(*args, **kw)
    page = requests.get(f"{base}/status", timeout=30)
    assert page.status_code == 200
    assert "text/html" in page.headers["Content-Type"]


def test_flightrec_bundle_matches_the_jax_layout(tmp_path):
    got = {}
    for pkg, cls, fr in (("jax", JaxSettings, jflightrec),
                         ("torch", Settings, flightrec)):
        cfg = cls()
        cfg.store_root = str(tmp_path / pkg)
        cfg.flightrec_keep = 2
        rec = fr.FlightRecorder(cfg, gather={
            "spans": lambda: [{"name": "s"}],
            "history": lambda: {"samples": 0},
            "resources": lambda: {"host": {}},
            "alerts": lambda: {"firing": []}})
        ids = [rec.dump(f"manual:r{i}", detail={"i": i}, doc={"a": 1},
                        force=True) for i in range(3)]
        assert all(ids)
        bundles = rec.list()
        assert [b["reason"] for b in bundles] == ["manual:r2", "manual:r1"]
        with open(os.path.join(bundles[0]["path"], "manifest.json")) as f:
            man = json.load(f)
        got[pkg] = (bundles[0]["files"], sorted(man),
                    sorted(bundles[0]), rec.snapshot(), man)
    jf, jkeys, jsum, jsnap, _ = got["jax"]
    tf, tkeys, tsum, tsnap, man = got["torch"]
    assert tf == jf and tkeys == jkeys and tsum == jsum
    assert set(tsnap) == set(jsnap)
    assert tsnap["bundles"] == jsnap["bundles"] == 2
    versions = man["versions"]
    assert {"torch", "cuda", "device", "numpy", "python"} <= set(versions)
    assert "jax" not in versions
    assert versions["device"] == "cpu"


def test_quarantine_dumps_a_bundle(tmp_path):
    """The batcher's quarantine dumps a ``serving.quarantine`` bundle.
    The dump runs after the waiters are failed, so the test waits for
    the bundle instead of expecting it when the 503 returns."""
    app = App(_cfg(tmp_path), recover=False, device="cpu")
    _data(app, ("q_train",))
    app.builder.build("q_train", "q_train", "qm", ["nb"], "label")
    server = app.serve(background=True)
    base = f"http://127.0.0.1:{server.port}"
    url = f"{base}/trained-models/qm_nb/predict"
    try:
        assert requests.post(url, json={"rows": [ROW]},
                             timeout=30).status_code == 200
        failpoints.configure("serving.batcher.pre_dispatch=raise:0")
        r = requests.post(url, json={"rows": [ROW]}, timeout=30)
        failpoints.reset()
        assert r.status_code == 503 and "quarantined" in r.json()["result"]
        deadline = time.monotonic() + 15
        while not any(b["reason"] == "serving.quarantine"
                      for b in app.flightrec.list()):
            assert time.monotonic() < deadline, "no quarantine bundle"
            time.sleep(0.05)
        (bundle,) = [b for b in app.flightrec.list()
                     if b["reason"] == "serving.quarantine"]
        assert bundle["detail"]["model"] == "qm_nb"
        assert {"manifest.json", "spans.json", "history.json",
                "resources.json", "alerts.json"} <= set(bundle["files"])
        alerts_doc = requests.get(f"{base}/alerts", timeout=30).json()
        assert "serving_quarantined" in alerts_doc["firing"]
        assert alerts_doc["flightrec_latest"]
    finally:
        failpoints.reset()
        server.stop()


def test_watchdog_expiry_dumps_an_incident(tmp_path):
    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    cfg.job_deadline_s = 0.3
    store = DatasetStore(cfg)
    store.create("wd")
    rec_dir = flightrec.FlightRecorder(cfg)
    flightrec.set_recorder(rec_dir)
    release = threading.Event()
    try:
        rec = JobManager(store, cfg=cfg).submit(
            "projection", "wd", lambda: release.wait(5.0))
        deadline = time.monotonic() + 10
        while not (rec.status == "failed" and rec_dir.list()):
            assert time.monotonic() < deadline, "watchdog never dumped"
            time.sleep(0.05)
        (bundle,) = rec_dir.list()
        assert bundle["reason"] == "job:watchdog"
        assert bundle["detail"]["job_id"] == rec.job_id
        # The expiry also poisons the pod, as the JAX package's watchdog
        # does (the supervisor restarts it under the next mesh epoch).
        assert "watchdog" in (spmd.pod_error() or "")
    finally:
        release.set()
        flightrec.set_recorder(None)
        spmd._pod_error = None


# -- resources ----------------------------------------------------------------

def _keys2(doc):
    return {k: (sorted(v) if isinstance(v, dict) else None)
            for k, v in doc.items()}


def test_process_snapshot_has_the_jax_keys(tmp_path):
    cfg, jcfg = Settings(), JaxSettings()
    cfg.store_root = jcfg.store_root = str(tmp_path)
    got = resources.process_snapshot(cfg)
    want = jresources.process_snapshot(jcfg)
    assert _keys2(got) == _keys2(want)
    assert got["devices"]["source"] == want["devices"]["source"] \
        == "live_buffers"
    assert set(resources.compile_snapshot()) == \
        set(jresources.compile_snapshot())


def test_sweep_job_profile_carries_watermarks(served):
    base, app = served
    resp = requests.post(f"{base}/models", json={
        "training_filename": "res_train", "test_filename": "res_test",
        "prediction_filename": "res_pred",
        "classificators_list": ["lr", "nb"], "label": "label",
        "sync": False}, timeout=30)
    assert resp.status_code == 201, resp.text
    app.jobs.wait_all(timeout=120)
    (job,) = [j for j in requests.get(f"{base}/jobs", timeout=30).json()
              if j["kind"] == "model_builder"]
    assert job["status"] == "done"
    prof = job["profile"]
    assert prof["peak_hbm_bytes"] > 0
    assert prof["compile_s"] >= 0.0 and "host_rss_delta" in prof
    marks = resources.family_watermarks()
    for fam in ("lr", "nb"):
        assert prof["fit_resources"][fam]["peak_hbm_bytes"] > 0
        assert marks[fam]["peak_hbm_bytes"] > 0 and marks[fam]["phases"]
    snap = requests.get(f"{base}/resources", timeout=30).json()
    assert snap["devices"]["source"] == "live_buffers"
    assert snap["devices"]["total_bytes_in_use"] > 0


def test_compile_accounting_counts_bucket_warmups(served):
    base, app = served
    before = resources.compile_snapshot()
    r = requests.post(f"{base}/trained-models/res_pred_lr/predict",
                      json={"rows": [ROW]}, timeout=30)
    assert r.status_code == 200, r.text
    after = resources.compile_snapshot()
    n = len(app.predictor.aot.buckets)
    assert after["compiles"] - before["compiles"] >= n
    assert after["compile_s"] >= before["compile_s"]
    requests.post(f"{base}/trained-models/res_pred_lr/predict",
                  json={"rows": [ROW]}, timeout=30)
    assert resources.compile_snapshot()["cache_hits"] > after["cache_hits"]
    doc = requests.get(f"{base}/metrics", timeout=30).json()
    assert doc["compile"]["cache_misses"] == doc["compile"]["compiles"]


def test_debug_profile_gated_and_captures(served):
    base, app = served
    url = f"{base}/debug/profile"
    assert requests.post(url, json={"seconds": 0.1},
                         timeout=30).status_code == 403
    app.cfg.debug_profile = True
    try:
        assert requests.post(url, json={"seconds": 10_000},
                             timeout=30).status_code == 406
        resp = requests.post(url, json={"seconds": 1.0}, timeout=30)
        assert resp.status_code == 201, resp.text
        out = resp.json()
        assert out["dir"].startswith(app.cfg.store_root)
        deadline = time.monotonic() + 10
        while not resources.profiler_busy():
            assert time.monotonic() < deadline, "capture never started"
            time.sleep(0.01)
        busy = requests.post(url, json={"seconds": 0.1}, timeout=30)
        assert busy.status_code == 409, busy.text
        app.jobs.wait_all(timeout=60)
        with open(os.path.join(out["dir"], "trace.json")) as f:
            assert "traceEvents" in json.load(f)
        jobs = [j for j in requests.get(f"{base}/jobs", timeout=30).json()
                if j["kind"] == "debug_profile"]
        assert [j["status"] for j in jobs] == ["done"]
    finally:
        app.cfg.debug_profile = False


def test_a_kernel_library_found_built_counts_one_persistent_hit(tmp_path):
    """A library an earlier process built counts once as a persistent
    cache hit (no nvcc run, no compile), however often it is asked for."""
    from learningorchestra_tpu_torch.ops._cuda_build import CudaLibrary

    lib = CudaLibrary("probe", {})
    lib.source = tmp_path / "probe.cu"
    lib.source.write_text("// probe\n")
    lib.build_dir = tmp_path / "build"
    lib.build_dir.mkdir()
    lib.path().write_bytes(b"")
    before = resources.compile_snapshot()
    assert lib.build() == lib.path() and lib.build() == lib.path()
    after = resources.compile_snapshot()
    assert after["persistent_cache_hits"] == \
        before["persistent_cache_hits"] + 1
    assert after["compiles"] == before["compiles"]
