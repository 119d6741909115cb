"""The PyTorch package's REST server and online predict tier, on the CPU.

An in-process ``App(cfg, device="cpu")`` driven by the port's client SDK,
mirroring tests/test_serving.py and tests/test_serving_online.py: the
Titanic pipeline (files from a ``file://`` CSV, projection, histogram,
field types, sync and async models, predictions, the PCA image), the
error codes, backpressure, deadlines, idempotency, hot swap and delete.
Beside it the JAX package's ``App`` takes the same requests, and each
answer's status code and JSON keys must match.
"""

import threading
import uuid

import numpy as np
import pytest
import requests
import torch

from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.serving.app import App as JaxApp
from learningorchestra_tpu_torch.client import (
    Context, DatabaseApi, DataTypeHandler, Histogram, JobFailed, Model, Pca,
    Projection, micro_batches)
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models.aot import design_from_rows
from learningorchestra_tpu_torch.models.registry import ONLINE_KINDS
from learningorchestra_tpu_torch.serving.app import App

FAMILIES = list(ONLINE_KINDS)
HEADER = "Pclass,Sex,Age,Fare,Survived"


def _csv(path, n=200, seed=0):
    rng = np.random.default_rng(seed)
    lines = [HEADER]
    for _ in range(n):
        sex = rng.choice(["male", "female"])
        age = "" if rng.random() < 0.1 else str(rng.integers(1, 70))
        fare = round(float(rng.lognormal(2.5, 1.0)), 2)
        surv = int(rng.random() < (0.7 if sex == "female" else 0.2))
        lines.append(f"{rng.integers(1, 4)},{sex},{age},{fare},{surv}")
    path.write_text("\n".join(lines) + "\n")
    return f"file://{path}"


def _settings(cls, root, **kw):
    cfg = cls()
    cfg.store_root = str(root / "store")
    cfg.image_root = str(root / "images")
    cfg.port = 0
    cfg.persist = True
    cfg.serve_max_batch = 64             # bucket ladder 1/8/64
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's server with the Titanic CSV ingested and all five
    families fitted (sync ``POST /models``) as ``om_<family>``."""
    tmp = tmp_path_factory.mktemp("port")
    app = App(_settings(Settings, tmp), recover=False, device="cpu")
    server = app.serve(background=True)
    ctx = Context(f"http://127.0.0.1:{server.port}", poll_seconds=0.05,
                  timeout=120)
    url = _csv(tmp / "titanic.csv")
    DatabaseApi(ctx).create_file("otrain", url, wait=True)
    Model(ctx).create_model("otrain", "otrain", "om", FAMILIES, "Survived")
    yield ctx, app, url
    app.jobs.wait_all(timeout=120)
    server.stop()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both packages' servers, each with the same CSV ingested and an lr
    model fitted under the same names, for side-by-side requests."""
    out = {}
    for pkg, make in (("jax", lambda cfg: JaxApp(cfg, recover=False)),
                      ("torch", lambda cfg: App(cfg, recover=False,
                                                device="cpu"))):
        tmp = tmp_path_factory.mktemp(pkg)
        cls = JaxSettings if pkg == "jax" else Settings
        app = make(_settings(cls, tmp))
        server = app.serve(background=True)
        ctx = Context(f"http://127.0.0.1:{server.port}", poll_seconds=0.05,
                      timeout=120)
        url = _csv(tmp / "titanic.csv")
        DatabaseApi(ctx).create_file("ptrain", url, wait=True)
        r = requests.post(ctx.url("/models"), json={
            "training_filename": "ptrain", "test_filename": "ptrain",
            "prediction_filename": "pp", "classificators_list": ["lr"],
            "label": "Survived"})
        assert r.status_code == 201, r.text
        out[pkg] = (ctx, app, server, url)
    yield out
    for ctx, app, server, _ in out.values():
        app.jobs.wait_all(timeout=120)
        server.stop()


ROW = {"Sex": "male", "Age": 30, "Pclass": 2, "Fare": 7.5}

#: (method, path, json body, headers) sent to both servers in order.
REQUESTS = [
    ("GET", "/files", None, None),
    ("GET", "/files/ptrain?limit=3", None, None),
    ("GET", "/files/missing_ds", None, None),
    ("POST", "/files", {"filename": "ptrain", "url": "file:///x.csv"}, None),
    ("POST", "/files", {"filename": "only_name"}, None),
    ("POST", "/projections/ptrain",
     {"projection_filename": "pj", "fields": ["Sex", "Survived"]}, None),
    ("POST", "/projections/ptrain",
     {"projection_filename": "pj2", "fields": ["NotAField"]}, None),
    ("POST", "/projections/missing_ds",
     {"projection_filename": "pj3", "fields": ["Sex"]}, None),
    ("POST", "/histograms/ptrain",
     {"histogram_filename": "hg", "fields": ["Survived"]}, None),
    ("POST", "/histograms/ptrain",
     {"histogram_filename": "hg2", "fields": ["Nope"]}, None),
    ("PATCH", "/fieldtypes/missing_ds", {"Survived": "string"}, None),
    ("POST", "/models", {
        "training_filename": "ptrain", "test_filename": "ptrain",
        "prediction_filename": "px", "classificators_list": ["svm"],
        "label": "Survived"}, None),
    ("POST", "/models", {
        "training_filename": "ptrain", "test_filename": "ptrain",
        "prediction_filename": "pp", "classificators_list": ["lr"],
        "label": "Survived"}, None),
    ("POST", "/models", {"training_filename": "ptrain"}, None),
    ("POST", "/models", {
        "training_filename": "ptrain", "test_filename": "ptrain",
        "prediction_filename": "pexec", "classificators_list": ["nb"],
        "label": "Survived", "preprocessor_code": "x = 1"}, None),
    ("POST", "/models", {
        "training_filename": "ptrain", "test_filename": "ptrain",
        "prediction_filename": "php", "classificators_list": ["lr"],
        "label": "Survived", "hparams": {"lr": {"bogus": 1}}}, None),
    ("POST", "/models", {
        "training_filename": "ptrain", "test_filename": "ptrain",
        "prediction_filename": "pa", "classificators_list": ["nb"],
        "label": "Survived", "sync": False}, None),
    ("GET", "/trained-models", None, None),
    ("POST", "/trained-models/pp_lr/predict", {"rows": [ROW]}, None),
    ("POST", "/trained-models/pp_lr/predict", {"rows": [[1.0, 2.0, 3.0,
                                                         4.0]]}, None),
    ("POST", "/trained-models/nope/predict", {"rows": [ROW]}, None),
    ("POST", "/trained-models/pp_lr/predict", {"rows": []}, None),
    ("POST", "/trained-models/pp_lr/predict", {"rows": [[1.0]]}, None),
    ("POST", "/trained-models/pp_lr/predict", {"rows": None}, None),
    ("POST", "/trained-models/pp_lr/predict", {}, None),
    ("POST", "/trained-models/pp_lr/predict",
     {"rows": [dict(ROW, Pclass=None)]}, None),
    ("POST", "/trained-models/pp_lr/predict", {"rows": [ROW] * 65}, None),
    ("POST", "/trained-models/pp_lr/predict", {"rows": [ROW]},
     {"X-Deadline-Ms": "0"}),
    ("POST", "/trained-models/pp_lr/predict", {"rows": [ROW]},
     {"X-Deadline-Ms": "soon"}),
    ("POST", "/trained-models/pp_lr/predict", {"rows": [ROW]},
     {"X-Deadline-Ms": "60000"}),
    ("POST", "/trained-models/pp_lr/predictions",
     {"dataset_name": "ptrain", "prediction_filename": "served"}, None),
    ("POST", "/trained-models/pp_lr/predictions",
     {"dataset_name": "ptrain", "prediction_filename": "served"}, None),
    ("POST", "/trained-models/nope/predictions",
     {"dataset_name": "ptrain", "prediction_filename": "served2"}, None),
    ("POST", "/trained-models/pp_lr/predictions",
     {"dataset_name": "missing_ds", "prediction_filename": "served3"},
     None),
    ("POST", "/catalog/scrub", {}, None),
    ("POST", "/catalog/scrub", {"dataset": "nope"}, None),
    ("GET", "/jobs", None, None),
    ("GET", "/traces?limit=3", None, None),
    ("GET", "/trace/no-such-trace", None, None),
    ("GET", "/pca/images", None, None),
    ("GET", "/pca/images/none", None, None),
    ("POST", "/pca/images/missing_ds", {"image_name": "i1"}, None),
    ("POST", "/pca/images/ptrain", {}, None),
    ("DELETE", "/trained-models/nope", None, None),
    ("DELETE", "/files/missing_ds", None, None),
    ("GET", "/no/such/route", None, None),
]


def _keys(body):
    """The JSON shape compared across packages: a dict's keys, a list's
    first element's keys (a job's ``profile`` included: both packages
    record its device watermarks)."""
    if isinstance(body, dict):
        return sorted(body)
    if isinstance(body, list) and body and isinstance(body[0], dict):
        return ["[]"] + sorted(body[0])
    return type(body).__name__


def _send(ctx, method, path, body, headers):
    return requests.request(method, ctx.url(path), json=body,
                            headers=headers, timeout=60)


def test_same_status_codes_and_keys_as_the_jax_server(pair):
    """Every kept route answers the JAX server's status code and JSON keys
    on the same request sequence."""
    mismatches = []
    for method, path, body, headers in REQUESTS:
        got = {pkg: _send(pair[pkg][0], method, path, body, headers)
               for pkg in ("jax", "torch")}
        j, t = got["jax"], got["torch"]
        shape = (_keys(j.json()), _keys(t.json()))
        if j.status_code != t.status_code or shape[0] != shape[1]:
            mismatches.append((method, path, j.status_code, t.status_code,
                               shape))
        if j.status_code == 503:
            assert "Retry-After" in j.headers and "Retry-After" in t.headers
    assert mismatches == []


def test_metrics_and_health_are_the_jax_sections(pair):
    (jctx, *_), (tctx, *_) = pair["jax"], pair["torch"]
    jm = requests.get(jctx.url("/metrics")).json()
    tm = requests.get(tctx.url("/metrics")).json()
    assert set(tm) <= set(jm)
    for section in ("serving", "jobs", "integrity", "read_pipeline",
                    "ingest", "ops", "tracing", "resources", "compile",
                    "telemetry", "alerts", "flightrec"):
        assert section in tm, section
    assert set(tm["serving"]) == set(jm["serving"])
    assert (set(tm["serving"]["models"]["pp_lr"])
            == set(jm["serving"]["models"]["pp_lr"]))
    jh = requests.get(jctx.url("/healthz"))
    th = requests.get(tctx.url("/healthz"))
    assert th.status_code == jh.status_code == 200
    assert set(th.json()) <= set(jh.json())
    assert (set(th.json()["checks"]["dispatchers"])
            == set(jh.json()["checks"]["dispatchers"]))


def test_full_pipeline(served, tmp_path):
    ctx, app, url = served
    db = DatabaseApi(ctx)
    db.create_file("titanic_test", url, wait=True)
    docs = db.read_file("otrain", limit=3)
    assert docs[0]["_id"] == 0 and docs[0]["finished"] is True
    assert docs[1]["Sex"] in ("male", "female")

    Projection(ctx).create_projection("otrain", "proj", ["Sex", "Survived"])
    meta = db.read_file("proj", limit=1)[0]
    assert meta["fields"] == ["Sex", "Survived"]
    assert meta["parent_filename"] == "otrain"

    Histogram(ctx).create_histogram("otrain", "hist", ["Survived"])
    counts = db.read_file("hist", limit=5)[1]["counts"]
    assert set(counts) == {"0", "1"} or set(counts) == {0, 1}

    DataTypeHandler(ctx).change_file_type("proj", {"Survived": "string"})
    assert isinstance(db.read_file("proj", skip=1, limit=1)[0]["Survived"],
                      str)

    m = Model(ctx)
    out = m.create_model("otrain", "titanic_test", "sync", ["nb", "dt"],
                         "Survived")
    assert {r["classifier"] for r in out["result"]} == {"nb", "dt"}
    for r in out["result"]:
        assert r["fit_time"] > 0 and r["accuracy"] > 0.5
    out = m.create_model("otrain", "titanic_test", "async", ["gb"],
                         "Survived", sync=False)
    assert out["prediction_datasets"] == ["async_gb"]
    meta = db.waiter.wait("async_gb")
    assert meta["accuracy"] > 0.5
    row = db.read_file("async_gb", skip=1, limit=1)[0]
    assert row["prediction"] in (0, 1) and len(row["probability"]) == 2

    assert "async_gb" in [x["name"] for x in m.list_trained_models()]
    out = m.predict("async_gb", "titanic_test", "again")
    assert out["prediction_filename"] == "again"
    assert db.read_file("again", limit=1)[0]["finished"] is True
    first = db.read_file("async_gb", skip=1, limit=5)
    again = db.read_file("again", skip=1, limit=5)
    assert [r["probability"] for r in first] == [r["probability"]
                                                 for r in again]

    pca = Pca(ctx)
    pca.create_image_plot("p1", "otrain", label_name="Survived")
    assert "p1" in pca.read_image_plots()
    assert pca.read_image_plot("p1")[:8] == b"\x89PNG\r\n\x1a\n"
    pca.delete_image_plot("p1")
    assert "p1" not in pca.read_image_plots()

    metrics = requests.get(ctx.url("/metrics")).json()
    assert metrics["ops"]["fit.gb"]["count"] >= 1
    assert metrics["jobs"].get("done", 0) >= 1


def test_error_paths(served):
    ctx, app, url = served
    db = DatabaseApi(ctx)
    db.create_file("dup1", url, wait=True)
    with pytest.raises(RuntimeError, match="409"):
        db.create_file("dup1", url)
    with pytest.raises(RuntimeError, match="404"):
        db.read_file("missing_ds")
    with pytest.raises(RuntimeError, match="406"):
        Projection(ctx).create_projection("dup1", "dup1p", ["NotAField"])
    with pytest.raises(RuntimeError, match="406"):
        Model(ctx).create_model("dup1", "dup1", "px", ["svm"], "Survived")
    db.create_file("badfile", "file:///does/not/exist.csv")
    with pytest.raises(JobFailed):
        db.waiter.wait("badfile")
    # Not ported routes are absent, not stubbed; /tune is routed (a
    # family without a population path is refused as in the JAX
    # package); the observability planes answer.
    for path in ("/cluster", "/replication"):
        assert requests.get(ctx.url(path)).status_code == 404
    r = requests.post(ctx.url("/tune"), json={
        "training_filename": "dup1", "tune_filename": "dup1t",
        "classificator": "nb", "configs": [{}], "label": "Survived"})
    assert r.status_code == 406 and "population" in r.text
    for path in ("/status", "/alerts", "/resources", "/metrics/history",
                 "/debug/flightrec"):
        assert requests.get(ctx.url(path)).status_code == 200, path


def _oracle(app, name, rows):
    """One row at a time through the batch predict path (registry.load +
    TrainedModel.predict_proba)."""
    man, model = app.builder.registry.load(name)
    X = design_from_rows(rows, man["preprocess"])
    return np.concatenate([model.predict_proba(app.runtime, X[i:i + 1])
                           for i in range(len(X))], axis=0)


def _sample_rows(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{"Sex": rng.choice(["male", "female", "other"]).item(),
             "Age": None if rng.random() < 0.15 else int(rng.integers(1, 70)),
             "Pclass": int(rng.integers(1, 4)),
             "Fare": round(float(rng.lognormal(2.5, 1.0)), 4)}
            for _ in range(n)]


@pytest.mark.parametrize("kind", FAMILIES)
def test_batched_vs_serial_parity(served, kind):
    """Micro-batched probabilities — any coalescing, any padding bucket —
    are bit-identical to the one-row batch-path oracle."""
    ctx, app, _ = served
    name = f"om_{kind}"
    rows = _sample_rows(40)
    oracle = _oracle(app, name, rows)
    out = Model(ctx).predict_online(name, rows, max_batch=64)
    np.testing.assert_array_equal(
        np.asarray(out["probabilities"], np.float32), oracle)
    assert out["predictions"] == np.argmax(oracle, axis=1).tolist()
    sizes = [1, 3, 7, 12, 17]
    offsets = np.cumsum([0] + sizes)
    results = [None] * len(sizes)

    def submit(j):
        results[j] = app.predictor.predict(
            name, rows[offsets[j]:offsets[j + 1]])

    threads = [threading.Thread(target=submit, args=(j,))
               for j in range(len(sizes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for j in range(len(sizes)):
        np.testing.assert_array_equal(
            np.asarray(results[j]["probabilities"], np.float32),
            oracle[offsets[j]:offsets[j + 1]])


def test_client_splits_to_the_server_cap(served):
    ctx, app, _ = served
    assert [len(c) for c in micro_batches(list(range(10)), 4)] == [4, 4, 2]
    rows = _sample_rows(150, seed=3)
    m = Model(ctx)
    out = m.predict_online("om_lr", rows)
    assert len(out["predictions"]) == 150 and m._server_max_batch == 64
    np.testing.assert_array_equal(
        np.asarray(out["probabilities"], np.float32),
        _oracle(app, "om_lr", rows))


def test_predict_exempt_from_idempotency(served):
    ctx, app, _ = served
    before = app.predictor.snapshot()["models"].get(
        "om_nb", {}).get("requests", 0)
    key = "same-key-on-purpose"
    rs = [requests.post(ctx.url("/trained-models/om_nb/predict"),
                        json={"rows": [ROW]},
                        headers={"Idempotency-Key": key})
          for _ in range(2)]
    assert [r.status_code for r in rs] == [200, 200]
    assert rs[0].json()["probabilities"] == rs[1].json()["probabilities"]
    after = app.predictor.snapshot()["models"]["om_nb"]["requests"]
    assert after - before == 2


def test_idempotent_duplicate_create(served):
    ctx, app, url = served
    key = uuid.uuid4().hex
    body = {"filename": "idem1", "url": url}
    r1 = requests.post(ctx.url("/files"), json=body,
                       headers={"Idempotency-Key": key})
    r2 = requests.post(ctx.url("/files"), json=body,
                       headers={"Idempotency-Key": key})
    assert r1.status_code == 201 and r1.json() == r2.json()
    r3 = requests.post(ctx.url("/files"), json=body,
                       headers={"Idempotency-Key": uuid.uuid4().hex})
    assert r3.status_code == 409


def test_queue_full_503_and_stock_client_retries(served):
    """With the dispatcher wedged and the queue at capacity, a request
    gets 503 + Retry-After; the stock client retries to completion once
    the queue drains."""
    ctx, app, _ = served
    entry = app.predictor.aot.entry("om_lr")
    orig_predict = entry.predict
    started, gate = threading.Event(), threading.Event()

    def wedged(X):
        started.set()
        assert gate.wait(20), "test gate never released"
        return orig_predict(X)

    entry.predict = wedged
    old_depth = app.cfg.serve_queue_depth
    app.cfg.serve_queue_depth = 2
    url = ctx.url("/trained-models/om_lr/predict")
    first, second = {}, {}
    t_first = threading.Thread(target=lambda: first.update(
        r=requests.post(url, json={"rows": [ROW]}, timeout=30)))
    t_second = threading.Thread(target=lambda: second.update(
        r=requests.post(url, json={"rows": [ROW, ROW]}, timeout=30)))
    try:
        t_first.start()
        assert started.wait(10), "dispatcher never picked up r1"
        t_second.start()
        for _ in range(100):
            if app.predictor._batcher("om_lr").queue_rows() >= 2:
                break
            threading.Event().wait(0.05)
        r3 = requests.post(url, json={"rows": [ROW]}, timeout=30)
        assert r3.status_code == 503
        assert float(r3.headers["Retry-After"]) >= 1
        fast = Context(ctx.base_url, retries=8, backoff_seconds=0.05,
                       retry_after_cap=0.3)
        out = {}
        t_client = threading.Thread(target=lambda: out.update(
            Model(fast).predict_online("om_lr", [ROW])))
        t_client.start()
        threading.Event().wait(0.3)
        gate.set()
        t_client.join(timeout=30)
        assert not t_client.is_alive()
        assert len(out["predictions"]) == 1
        t_first.join(timeout=30)
        t_second.join(timeout=30)
        assert first["r"].status_code == 200
        assert second["r"].status_code == 200
        assert app.predictor.snapshot()["models"]["om_lr"]["rejected"] >= 1
    finally:
        gate.set()
        entry.predict = orig_predict
        app.cfg.serve_queue_depth = old_depth


def test_deadline_504_and_cap_406(served):
    ctx, app, _ = served
    url = ctx.url("/trained-models/om_dt/predict")
    before = app.predictor.snapshot()["models"].get(
        "om_dt", {}).get("deadline_exceeded", 0)
    entry = app.predictor.aot.entry("om_dt")
    orig_predict = entry.predict
    started, gate = threading.Event(), threading.Event()

    def wedged(X):
        started.set()
        gate.wait(20)
        return orig_predict(X)

    entry.predict = wedged
    blocker = threading.Thread(target=lambda: requests.post(
        url, json={"rows": [ROW]}, timeout=30))
    try:
        blocker.start()
        assert started.wait(10)
        # Queued behind the wedged batch, its 150 ms budget expires.
        r = requests.post(url, json={"rows": [ROW]},
                          headers={"X-Deadline-Ms": "150"}, timeout=30)
        assert r.status_code == 504
        assert "Retry-After" not in r.headers
    finally:
        gate.set()
        blocker.join(timeout=30)
        entry.predict = orig_predict
    r = requests.post(url, json={"rows": [ROW]},
                      headers={"X-Deadline-Ms": "-5"})
    assert r.status_code == 504
    after = app.predictor.snapshot()["models"]["om_dt"]["deadline_exceeded"]
    assert after - before == 2
    r = requests.post(url, json={"rows": [ROW] * 65})
    assert r.status_code == 406 and "serve_max_batch=64" in r.json()["result"]


def test_hot_swap_raises_the_epoch_and_delete_404s(served):
    ctx, app, _ = served
    reg = app.builder.registry
    rows = [{"Sex": "female", "Age": 20, "Pclass": 1, "Fare": 30.0}]
    man, model = reg.load("om_rf")
    reg.save("om_swap", model, metrics=man.get("metrics"),
             preprocess=man.get("preprocess"))
    _, p1, epoch1 = app.predictor.predict_with_epoch("om_swap", rows)
    ev0 = app.predictor.snapshot()["aot"]["evictions"]
    reg.save("om_swap", model, metrics=man.get("metrics"),
             preprocess=man.get("preprocess"))
    _, p2, epoch2 = app.predictor.predict_with_epoch("om_swap", rows)
    assert epoch2 == epoch1 + 1
    np.testing.assert_array_equal(p1, p2)
    assert app.predictor.snapshot()["aot"]["evictions"] == ev0 + 1
    r = requests.delete(ctx.url("/trained-models/om_swap"))
    assert r.status_code == 200
    r = requests.post(ctx.url("/trained-models/om_swap/predict"),
                      json={"rows": rows})
    assert r.status_code == 404


def test_keep_alive_responses_do_not_wait_for_a_delayed_ack():
    """Sequential requests on one keep-alive connection answer in about a
    millisecond: with Nagle's algorithm on, each response's body waited
    for the client's delayed ACK of its headers (about 40 ms)."""
    import http.client
    import json
    import time

    from learningorchestra_tpu_torch.serving.http import Router, Server

    router = Router()
    router.route("POST", "/echo")(lambda req: (200, {"x": req.body}))
    server = Server(router, "127.0.0.1", 0).start_background()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    try:
        lat = []
        for i in range(21):
            t = time.perf_counter()
            conn.request("POST", "/echo", body=json.dumps({"i": i}).encode(),
                         headers={"Content-Type": "application/json"})
            assert json.loads(conn.getresponse().read()) == {"x": {"i": i}}
            lat.append(time.perf_counter() - t)
        assert sorted(lat)[10] < 0.02, sorted(lat)
    finally:
        conn.close()
        server.stop()


def test_drain_gates_new_work(tmp_path):
    app = App(_settings(Settings, tmp_path), recover=False, device="cpu")
    server = app.serve(background=True)
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert app.drain(timeout_s=5.0) is True
        r = requests.post(base + "/files", json={"filename": "x",
                                                 "url": "file:///x"})
        assert r.status_code == 503 and r.headers["Retry-After"]
        assert requests.get(base + "/files").status_code == 200
        h = requests.get(base + "/healthz")
        assert h.status_code == 503 and h.json()["state"] == "draining"
    finally:
        server.stop()


def test_serve_refuses_the_unported_front_end(tmp_path):
    """``http_workers > 1`` was refused before the front end was ported;
    now ``serve`` runs the port's ``FrontendServer``, whose workers
    answer on the one port."""
    from learningorchestra_tpu_torch.serving.frontend import FrontendServer

    app = App(_settings(Settings, tmp_path, http_workers=2), recover=False,
              device="cpu")
    server = app.serve(background=True)
    try:
        assert isinstance(server, FrontendServer)
        base = f"http://127.0.0.1:{server.port}"
        assert requests.get(base + "/files", timeout=30).status_code == 200
        assert server.snapshot()["workers_alive"] == 2
    finally:
        server.stop()


def test_app_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        App(_settings(Settings, tmp_path), recover=False)


def test_dispatcher_survives_timeout_withdrawal():
    """A timeout withdrawal that empties the queue during the linger wait
    does not kill the dispatcher thread."""
    import time

    from learningorchestra_tpu_torch.serving.batcher import (
        ModelBatcher, PredictTimeout, _Stats)

    class _StubEntry:
        def predict(self, X):
            return np.tile(np.array([[0.3, 0.7]]), (len(X), 1))

    cfg = Settings()
    cfg.serve_max_wait_ms = 150
    cfg.serve_timeout_s = 0.05
    b = ModelBatcher("m", cfg, _Stats())
    try:
        with pytest.raises(PredictTimeout):
            b.submit(np.zeros((1, 2)), _StubEntry())
        time.sleep(0.4)
        assert b._thread.is_alive()
        cfg.serve_timeout_s = 10.0
        assert b.submit(np.zeros((2, 2)), _StubEntry()).shape == (2, 2)
    finally:
        b.stop()


def test_mixed_entry_batch_groups_by_entry():
    """Requests straddling a hot swap dispatch through the entry their
    design was built against."""
    from learningorchestra_tpu_torch.serving.batcher import (
        ModelBatcher, _Stats)

    class _Entry:
        def __init__(self, v):
            self.v = v

        def predict(self, X):
            return np.full((len(X), 2), self.v)

    cfg = Settings()
    cfg.serve_max_wait_ms = 50
    cfg.serve_timeout_s = 10.0
    b = ModelBatcher("m", cfg, _Stats())
    res = {}
    try:
        ts = [threading.Thread(target=lambda e=e, k=k: res.__setitem__(
            k, b.submit(np.zeros((2, 2)), e)))
            for k, e in (("a", _Entry(1.0)), ("b", _Entry(2.0)))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert np.all(res["a"] == 1.0) and np.all(res["b"] == 2.0)
    finally:
        b.stop()


def test_async_build_failure_is_pollable(served):
    """A build that dies before fitting (bad label) flips every promised
    prediction dataset to finished + error."""
    ctx, app, url = served
    db = DatabaseApi(ctx)
    r = requests.post(ctx.url("/models"), json={
        "training_filename": "otrain", "test_filename": "otrain",
        "prediction_filename": "abf", "classificators_list": ["nb", "lr"],
        "label": "NoSuchColumn", "sync": False})
    assert r.status_code == 201
    for name in ("abf_nb", "abf_lr"):
        with pytest.raises(JobFailed):
            db.waiter.wait(name, tolerate_missing=True)
        meta = db.read_file(name, limit=1)[0]
        assert meta["finished"] is True and meta["error"]


def test_persistence_recovery_and_retry_specs(served):
    """A restarted server recovers the catalog from disk, and the async
    build's datasets carry the job spec a retry re-runs from."""
    ctx, app, _ = served
    from learningorchestra_tpu_torch.catalog.store import DatasetStore

    store2 = DatasetStore(app.cfg)
    assert "otrain" in store2.load_all()
    assert store2.get("otrain").metadata.finished is True
    runner = app._retry_runner(
        {"kind": "model_predict", "model": "om_lr", "dataset": "otrain",
         "out": "x"}, ["x"])
    assert callable(runner)
    assert callable(app._retry_runner(
        {"kind": "tune", "train": "otrain", "out": "y",
         "classifier": "dt", "configs": [{}], "label": "Survived"}, ["y"]))
    assert app._retry_runner({"kind": "cluster"}, ["y"]) is None


def test_server_times_out_half_sent_request(tmp_path):
    """A client that promises a body it never sends cannot pin a handler
    thread: the per-connection timeout closes it, and the server keeps
    answering."""
    import socket
    import time

    app = App(_settings(Settings, tmp_path, http_timeout_s=0.5,
                        persist=False), recover=False, device="cpu")
    server = app.serve(background=True)
    try:
        s = socket.create_connection(("127.0.0.1", server.port), timeout=10)
        s.sendall(b"POST /files HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Length: 100\r\n\r\n{\"par")
        t0 = time.time()
        assert s.recv(4096) == b""
        assert time.time() - t0 < 8.0
        s.close()
        r = requests.get(f"http://127.0.0.1:{server.port}/files", timeout=10)
        assert r.status_code == 200
    finally:
        server.stop()


def test_client_retries_and_times_out():
    """The port's client retries connection errors with one stable
    Idempotency-Key, and a hung server raises its timeout."""
    import socket

    dead = Context("http://127.0.0.1:1", retries=2, backoff_seconds=0.01)
    calls = []
    orig = requests.Session.request

    def counting(self, method, url, **kw):
        calls.append((kw.get("headers") or {}).get("Idempotency-Key"))
        return orig(self, method, url, **kw)

    requests.Session.request = counting
    try:
        with pytest.raises(requests.ConnectionError):
            dead.post("/files", json={})
    finally:
        requests.Session.request = orig
    assert len(calls) == 3 and len(set(calls)) == 1 and None not in calls

    hung = socket.socket()
    hung.bind(("127.0.0.1", 0))
    hung.listen(1)
    conns = []
    t = threading.Thread(target=lambda: conns.append(hung.accept()),
                         daemon=True)
    t.start()
    try:
        ctx = Context(f"http://127.0.0.1:{hung.getsockname()[1]}",
                      request_timeout=0.3, retries=0)
        with pytest.raises(requests.Timeout):
            DatabaseApi(ctx).read_files_descriptor()
    finally:
        for conn, _ in conns:
            conn.close()
        hung.close()
