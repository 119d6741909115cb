"""The PyTorch package's multi-process front end (serving/frontend.py)
against the JAX package's, on the CPU.

A 2-worker port ``App`` and a 2-worker JAX ``App``, each over the same
seeded numpy data with all five families fitted, take the same requests
and answer the same status codes: list, dict and columnar rows, a
malformed columnar body (406), an unknown model (404), a malformed
deadline (406), deadline expiry in queue (504), a full queue (503 with
Retry-After), a drain under load with no accepted request lost, and
proxied non-predict routes (the observability planes among them).

Probabilities: the port serves the JAX package's fitted models too
(carried across with ``models/convert.from_jax_params``), and agrees
with the JAX front end within the online tier's tolerances
(tests/test_torch_aot.py ``TOL``). Within the port, every body through
the workers is byte-identical to a one-process ``Server`` over the same
router, for all three body kinds. Also pinned: a request's trace spans
both processes, a crashed worker is respawned and the client completes,
and keep-alive answers through a worker do not wait for a delayed ACK.
(tests/test_torch_import.py checks that a worker loads neither torch
nor jax.)
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import requests

from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.serving.app import App as JaxApp
from learningorchestra_tpu_torch.client import Context, Model
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models.convert import from_jax_params
from learningorchestra_tpu_torch.models.registry import ONLINE_KINDS
from learningorchestra_tpu_torch.serving import rowchannel
from learningorchestra_tpu_torch.serving.app import App
from learningorchestra_tpu_torch.serving.frontend import (
    FrontendServer, WORKER_PROCESS_BASE)
from learningorchestra_tpu_torch.serving.http import Server

FAMILIES = list(ONLINE_KINDS)
ROW = [0.5, -0.2, 1.1, 0.3]
#: The online tier's tolerances against the JAX package
#: (tests/test_torch_aot.py: lr's Newton fit rounds bf16 products).
TOL = {"lr": dict(rtol=0, atol=2e-2), "nb": dict(rtol=1e-5, atol=1e-7),
       "dt": dict(rtol=1e-6, atol=1e-7), "rf": dict(rtol=1e-6, atol=1e-7),
       "gb": dict(rtol=1e-6, atol=1e-7),
       # bf16 products summed in another order (as lr's).
       "mlp": dict(rtol=0, atol=2e-2)}


def _cfg(cls, tmp, workers=2, **kw):
    cfg = cls()
    cfg.store_root = str(tmp / "store")
    cfg.image_root = str(tmp / "images")
    cfg.port = 0
    cfg.persist = False
    cfg.serve_max_batch = 64
    cfg.http_workers = workers
    cfg.restart_backoff_s = 0.05
    cfg.restart_backoff_max_s = 0.5
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _build(app, families):
    rng = np.random.default_rng(0)
    n = 260
    y = rng.integers(0, 2, n)
    centers = rng.normal(size=(2, 4)) * 2.0
    X = (centers[y] + rng.normal(size=(n, 4))).astype(np.float64)
    ds = app.store.create("fe_train")
    cols = {f"x{j}": X[:, j] for j in range(4)}
    cols["y"] = y.astype(np.int64)
    ds.append_columns(cols)
    app.store.finish("fe_train")
    app.builder.build("fe_train", "fe_train", "fe", families, "y")


@pytest.fixture(scope="module")
def fronts(tmp_path_factory):
    """Both packages' 2-worker front ends, plus a one-process oracle
    ``Server`` over the port app's router. The port also serves the JAX
    package's models as ``jx_<family>``."""
    out = {}
    for pkg in ("jax", "torch"):
        tmp = tmp_path_factory.mktemp(f"front_{pkg}")
        if pkg == "jax":
            app = JaxApp(_cfg(JaxSettings, tmp), recover=False)
        else:
            app = App(_cfg(Settings, tmp), recover=False, device="cpu")
        _build(app, FAMILIES)
        server = app.serve(background=True)
        out[pkg] = {"app": app, "server": server,
                    "base": f"http://127.0.0.1:{server.port}"}
    japp, tapp = out["jax"]["app"], out["torch"]["app"]
    for kind in FAMILIES:
        man, jm = japp.builder.registry.load(f"fe_{kind}")
        tm = from_jax_params(kind, {k: np.asarray(v)
                                    for k, v in jm.params.items()},
                             jm.num_classes, jm.hparams)
        tapp.builder.registry.save(f"jx_{kind}", tm,
                                   preprocess=man["preprocess"])
    oracle = Server(tapp.router, "127.0.0.1", 0,
                    request_timeout_s=tapp.cfg.http_timeout_s)
    oracle.start_background()
    out["oracle"] = f"http://127.0.0.1:{oracle.port}"
    for kind in FAMILIES:               # warm every ladder
        japp.predictor.predict(f"fe_{kind}", [ROW])
        tapp.predictor.predict(f"fe_{kind}", [ROW])
        tapp.predictor.predict(f"jx_{kind}", [ROW])
    yield out
    oracle.stop()
    for pkg in ("jax", "torch"):
        out[pkg]["server"].stop()


def _post(base, name, body=None, data=None, headers=None):
    return requests.post(f"{base}/trained-models/{name}/predict",
                         json=body, data=data, headers=headers, timeout=30)


def _columnar(rows):
    return dict(data=rowchannel.encode_columnar(np.asarray(rows, np.float32)),
                headers={"Content-Type": rowchannel.COLUMNAR_CONTENT_TYPE})


@pytest.mark.parametrize("kind", FAMILIES)
def test_predict_parity_across_packages_and_topologies(fronts, kind):
    rows = [[0.1 * i, -0.2, 1.0 + 0.05 * i, 0.3] for i in range(9)]
    drows = [{f"x{j}": v for j, v in enumerate(r)} for r in rows]
    front, oracle = fronts["torch"]["base"], fronts["oracle"]
    name = f"fe_{kind}"
    bodies = {}
    for where, base in (("workers", front), ("oracle", oracle)):
        for bkind, kw in (("list", dict(body={"rows": rows})),
                          ("dict", dict(body={"rows": drows})),
                          ("columnar", _columnar(rows))):
            r = _post(base, name, **kw)
            assert r.status_code == 200, (where, bkind, r.text)
            bodies[where, bkind] = r.content
    for bkind in ("list", "dict", "columnar"):
        assert bodies["workers", bkind] == bodies["oracle", bkind], bkind
    assert bodies["workers", "list"] == bodies["workers", "columnar"]
    probs = {k: np.asarray(json.loads(v)["probabilities"], np.float32)
             for k, v in bodies.items()}
    np.testing.assert_array_equal(probs["workers", "dict"],
                                  probs["workers", "list"])
    # The JAX front end's answer for its model, against the port's
    # answer for the same parameters.
    rj = _post(fronts["jax"]["base"], name, body={"rows": rows})
    rt = _post(front, f"jx_{kind}", **_columnar(rows))
    assert rj.status_code == rt.status_code == 200
    jd, td = rj.json(), rt.json()
    assert set(jd) == set(td) and jd["kind"] == td["kind"] == kind
    np.testing.assert_allclose(np.asarray(td["probabilities"]),
                               np.asarray(jd["probabilities"]), **TOL[kind])
    if kind not in ("lr", "mlp"):
        assert td["predictions"] == jd["predictions"]


#: (method, path, json body, raw body + headers) sent to both front ends.
REQUESTS = [
    ("POST", "/trained-models/fe_lr/predict", None,
     (b"garbage", {"Content-Type": rowchannel.COLUMNAR_CONTENT_TYPE})),
    ("POST", "/trained-models/fe_lr/predict", None,
     (rowchannel.encode_columnar(np.zeros((1, 2), np.float32)),
      {"Content-Type": rowchannel.COLUMNAR_CONTENT_TYPE})),
    ("POST", "/trained-models/fe_nope/predict", {"rows": [ROW]}, None),
    ("POST", "/trained-models/fe_lr/predict", {"rows": [ROW]},
     (None, {"X-Deadline-Ms": "soon"})),
    ("POST", "/trained-models/fe_lr/predict", {"no_rows": 1}, None),
    ("POST", "/trained-models/fe_lr/predict", None,
     (b"{not json", {"Content-Type": "application/json"})),
    # /tune is proxied like any other control route: a sweep, a family
    # without a population path (406) and a missing dataset (404).
    ("POST", "/tune", {"training_filename": "fe_train",
                       "tune_filename": "fe_tuned", "classificator": "dt",
                       "configs": [{"max_depth": 2}, {"max_depth": 3}],
                       "label": "y", "folds": 2, "rungs": 1}, None),
    ("POST", "/tune", {"training_filename": "fe_train",
                       "tune_filename": "fe_tuned_nb", "classificator": "nb",
                       "configs": [{}], "label": "y"}, None),
    ("POST", "/tune", {"training_filename": "fe_nope",
                       "tune_filename": "fe_tuned_x", "classificator": "dt",
                       "configs": [{}], "label": "y"}, None),
    ("GET", "/files", None, None),
    ("GET", "/files/fe_train?limit=2", None, None),
    ("GET", "/no/such/route", None, None),
    ("GET", "/jobs", None, None),
    ("GET", "/resources", None, None),
    ("GET", "/alerts", None, None),
    ("GET", "/metrics/history?series=serving.requests", None, None),
    ("GET", "/debug/flightrec", None, None),
    ("POST", "/debug/profile", {"seconds": 1}, None),
    ("GET", "/status", None, None),
    ("GET", "/metrics?format=prometheus", None, None),
    ("GET", "/healthz", None, None),
]


def _send(base, method, path, body, raw):
    data, headers = (raw if raw is not None else (None, None))
    if data is not None:
        return requests.request(method, base + path, data=data,
                                headers=headers, timeout=30)
    return requests.request(method, base + path, json=body,
                            headers=headers, timeout=30)


def _shape(r):
    ct = r.headers.get("Content-Type", "")
    if "json" not in ct:
        return ct.split(";")[0]
    body = r.json()
    if isinstance(body, dict):
        return sorted(body)
    if isinstance(body, list) and body and isinstance(body[0], dict):
        return ["[]"] + sorted(body[0])
    return type(body).__name__


def test_same_status_codes_as_the_jax_front_end(fronts):
    mismatches = []
    for method, path, body, raw in REQUESTS:
        j = _send(fronts["jax"]["base"], method, path, body, raw)
        t = _send(fronts["torch"]["base"], method, path, body, raw)
        if j.status_code != t.status_code:
            mismatches.append((method, path, j.status_code, t.status_code))
        elif _shape(j) != _shape(t):
            mismatches.append((method, path, _shape(j), _shape(t)))
    assert not mismatches, mismatches
    prom = _send(fronts["torch"]["base"], "GET",
                 "/metrics?format=prometheus", None, None)
    assert "text/plain" in prom.headers["Content-Type"]
    samples = [ln for ln in prom.text.splitlines()
               if ln and not ln.startswith("#")]
    for ln in samples:
        name_labels, value = ln.rsplit(" ", 1)
        float(value)
        assert name_labels.split("{", 1)[0].replace("_", "").isalnum(), ln
    assert any(ln.startswith("lo_frontend_workers_alive") for ln in samples)


class _Gate:
    """Wedge one model's device entry: the dispatcher blocks inside
    ``entry.predict`` until released."""

    def __init__(self, app, name):
        self.entry = app.predictor.aot.entry(name)
        self.orig = self.entry.predict
        self.started = threading.Event()
        self.release = threading.Event()

    def __enter__(self):
        def wedged(X, *a, _orig=self.orig):
            self.started.set()
            assert self.release.wait(30), "gate never released"
            return _orig(X, *a)

        self.entry.predict = wedged
        return self

    def __exit__(self, *exc):
        self.release.set()
        self.entry.predict = self.orig


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_full_queue_and_deadline_across_the_hop(fronts, pkg):
    app, base = fronts[pkg]["app"], fronts[pkg]["base"]
    url = f"{base}/trained-models/fe_gb/predict"
    old_depth = app.cfg.serve_queue_depth
    app.cfg.serve_queue_depth = 2
    holder = {}
    try:
        with _Gate(app, "fe_gb") as g:
            t1 = threading.Thread(target=lambda: holder.update(
                r1=requests.post(url, json={"rows": [ROW]}, timeout=30)))
            t1.start()
            assert g.started.wait(10), "dispatcher never took r1"
            t2 = threading.Thread(target=lambda: holder.update(
                r2=requests.post(url, json={"rows": [ROW]}, timeout=30)))
            t2.start()
            deadline = time.monotonic() + 10
            while app.predictor._batcher("fe_gb").queue_rows() < 1:
                assert time.monotonic() < deadline, "r2 never queued"
                time.sleep(0.02)
            r3 = requests.post(url, json={"rows": [ROW, ROW]}, timeout=30)
            assert r3.status_code == 503, r3.text
            assert float(r3.headers["Retry-After"]) >= 1
            r4 = requests.post(url, json={"rows": [ROW]},
                               headers={"X-Deadline-Ms": "300"},
                               timeout=30)
            assert r4.status_code == 504, r4.text
        t1.join(30)
        t2.join(30)
        assert holder["r1"].status_code == holder["r2"].status_code == 200
    finally:
        app.cfg.serve_queue_depth = old_depth


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_drain_under_load_loses_nothing(fronts, pkg):
    """Accepted requests in flight when the drain begins complete; new
    work answers 503 + Retry-After + Connection: close from a worker."""
    app, base = fronts[pkg]["app"], fronts[pkg]["base"]
    url = f"{base}/trained-models/fe_lr/predict"
    results = []

    def client():
        results.append(requests.post(url, json={"rows": [ROW]},
                                     timeout=30).status_code)

    try:
        with _Gate(app, "fe_lr") as g:
            threads = [threading.Thread(target=client) for _ in range(4)]
            threads[0].start()
            assert g.started.wait(10)
            for t in threads[1:]:
                t.start()
            deadline = time.monotonic() + 10
            while app.predictor._batcher("fe_lr").queue_rows() < 3:
                assert time.monotonic() < deadline, "requests never queued"
                time.sleep(0.02)
            app.begin_drain()
            try:
                r = requests.post(url, json={"rows": [ROW]}, timeout=10)
                assert r.status_code == 503
                assert r.headers.get("Retry-After")
                assert r.headers.get("Connection", "").lower() == "close"
                h = requests.get(f"{base}/healthz", timeout=10)
                assert h.status_code == 503
                assert h.json()["state"] == "draining"
            finally:
                g.release.set()
            for t in threads:
                t.join(30)
                assert not t.is_alive()
        assert results == [200] * 4
    finally:
        app._draining.clear()
    assert requests.post(url, json={"rows": [ROW]},
                         timeout=30).status_code == 200


def test_trace_spans_both_processes(fronts):
    base = fronts["torch"]["base"]
    rid = "port-frontend-trace-1"
    r = requests.post(f"{base}/trained-models/fe_nb/predict",
                      json={"rows": [ROW]}, headers={"X-Request-Id": rid},
                      timeout=30)
    assert r.status_code == 200 and r.headers["X-Request-Id"] == rid
    deadline = time.monotonic() + 10
    while True:
        resp = requests.get(f"{base}/trace/{rid}", timeout=30)
        names = ({s["name"] for s in resp.json()["spans"]}
                 if resp.status_code == 200 else set())
        if {"http.handle", "queue.wait", "dispatch.device"} <= names:
            break
        assert time.monotonic() < deadline, names
        time.sleep(0.05)
    tree = resp.json()
    spans = {s["span_id"]: s for s in tree["spans"]}
    roots = [s for s in spans.values() if not s.get("parent_id")]
    assert [s["name"] for s in roots] == ["http.handle"]
    root = roots[0]
    assert root["process"] in (WORKER_PROCESS_BASE, WORKER_PROCESS_BASE + 1)
    assert root["attrs"]["route"] == "/trained-models/{name}/predict"

    def climbs(s, hops=0):
        if s["span_id"] == root["span_id"]:
            return True
        p = s.get("parent_id")
        return hops < 10 and p in spans and climbs(spans[p], hops + 1)

    primary = [s for s in spans.values()
               if s["process"] < WORKER_PROCESS_BASE]
    assert primary and all(climbs(s) for s in primary)
    assert set(tree["processes"]) >= {0, root["process"]}


def test_metrics_and_health_carry_the_frontend(fronts):
    base = fronts["torch"]["base"]
    # A list-row request: the worker packs it into a columnar frame.
    assert _post(base, "fe_nb", body={"rows": [ROW]}).status_code == 200
    doc = requests.get(f"{base}/metrics", timeout=30).json()
    jdoc = requests.get(f"{fronts['jax']['base']}/metrics",
                        timeout=30).json()
    fr = doc["frontend"]
    assert set(fr) == set(jdoc["frontend"])
    assert fr["workers"] == fr["workers_alive"] == 2
    assert fr["predict_frames_total"] >= 1
    assert fr["predict_binary_total"] >= 1
    h = requests.get(f"{base}/healthz", timeout=30).json()
    assert h["checks"]["frontend"]["ok"]
    # The JAX rollup's ``pod`` check belongs to the pod planes, which
    # the port does not have.
    assert set(h["checks"]) == set(requests.get(
        f"{fronts['jax']['base']}/healthz",
        timeout=30).json()["checks"]) - {"pod"}


def test_client_sends_columnar_for_numeric_rows(fronts):
    base = fronts["torch"]["base"]
    server = fronts["torch"]["server"]
    before = server.backend.snapshot()["predict_binary_total"]
    rows = [[0.01 * i, -0.2, 1.0, 0.3] for i in range(150)]
    out = Model(Context(base)).predict_online("fe_lr", rows, max_batch=64)
    assert len(out["predictions"]) == 150
    assert server.backend.snapshot()["predict_binary_total"] - before >= 3


def test_keep_alive_through_a_worker_does_not_wait_for_a_delayed_ack(
        fronts):
    """Sequential requests on one keep-alive connection through a worker
    answer in milliseconds: the client socket and the row channel both
    set TCP_NODELAY, else each response would wait for a delayed ACK."""
    port = fronts["torch"]["server"].port
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        lat = []
        for i in range(21):
            t = time.perf_counter()
            conn.request("POST", "/trained-models/fe_nb/predict",
                         body=json.dumps({"rows": [ROW]}).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200 and resp.read()
            lat.append(time.perf_counter() - t)
        assert sorted(lat)[10] < 0.03, sorted(lat)
    finally:
        conn.close()


def test_worker_crash_heals_through_respawn(tmp_path, monkeypatch):
    """A worker process dies mid-request (crash failpoint): the client's
    retry lands on a live or respawned worker, and the supervisor brings
    the slot back with the failpoint disarmed."""
    monkeypatch.setenv("LO_TPU_FAILPOINTS", "serving.front.pre_forward=crash")
    app = App(_cfg(Settings, tmp_path), recover=False, device="cpu")
    _build(app, ["nb"])
    server = app.serve(background=True)
    try:
        base = f"http://127.0.0.1:{server.port}"
        ctx = Context(base, retries=8, backoff_seconds=0.05,
                      retry_after_cap=0.2)
        out = Model(ctx).predict_online("fe_nb", [ROW])
        assert len(out["predictions"]) == 1
        deadline = time.monotonic() + 15
        while server.supervisor.alive() < 2 or \
                server.snapshot()["respawns_total"] < 1:
            assert time.monotonic() < deadline, server.snapshot()
            time.sleep(0.05)
        assert server.snapshot()["workers_alive"] == 2
        r = requests.post(f"{base}/trained-models/fe_nb/predict",
                          json={"rows": [ROW]}, timeout=30)
        assert r.status_code == 200
    finally:
        server.stop()


def test_default_topology_is_single_process(tmp_path):
    assert Settings().http_workers == 1
    app = App(_cfg(Settings, tmp_path, workers=1), recover=False,
              device="cpu")
    server = app.serve(background=True)
    try:
        assert isinstance(server, Server)
        assert not isinstance(server, FrontendServer)
    finally:
        server.stop()

