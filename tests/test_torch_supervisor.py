"""The PyTorch package's pod supervision: ``parallel/spmd.py``'s job
channel and pod poison, ``supervisor.py``, the job retry rescan, and two
gloo ranks that lose a worker mid-job — the cases of
tests/test_supervisor.py and the quick ones of tests/test_multiprocess.py
held against the port.

The two-rank cases start this file as a script, one process a rank
(``python tests/test_torch_supervisor.py <mode> <rank> <ranks>
<coordinator port> <job port> <http port> <shared root>``), joined over
gloo on the CPU at ``tcp://127.0.0.1:<coordinator port>``. Run so, the
file imports neither jax nor the JAX package.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from learningorchestra_tpu_torch.config import Settings  # noqa: E402
from learningorchestra_tpu_torch.jobs import select_retry_groups  # noqa: E402
from learningorchestra_tpu_torch.parallel import spmd  # noqa: E402
from learningorchestra_tpu_torch.supervisor import Supervisor  # noqa: E402

HERE = os.path.abspath(__file__)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True)
def _clean_pod_state(monkeypatch):
    """Every test starts at epoch 0 with an unpoisoned pod."""
    monkeypatch.setattr(spmd, "_pod_error", None)
    monkeypatch.delenv("LO_TPU_MESH_EPOCH", raising=False)
    yield


# -- mesh-epoch handshake -----------------------------------------------------

def _hello(port: int, line: bytes) -> dict:
    """Connect to the job channel, send one line, return the reply doc
    (``{"op": "eof"}`` when the channel just closes)."""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as sock:
        sock.sendall(line)
        sock.settimeout(5)
        buf = b""
        while b"\n" not in buf:
            data = sock.recv(4096)
            if not data:
                return {"op": "eof"}
            buf += data
        return json.loads(buf.split(b"\n", 1)[0])


@pytest.mark.parametrize("line", [
    json.dumps({"op": "hello", "epoch": 1}).encode() + b"\n",
    b"not json at all\n"], ids=["stale_epoch", "garbage"])
def test_job_channel_rejects_a_stale_or_garbage_handshake(monkeypatch,
                                                          line):
    port = _free_port()
    monkeypatch.setenv("LO_TPU_JOB_PORT", str(port))
    monkeypatch.setenv("LO_TPU_MESH_EPOCH", "2")
    chan = spmd._JobChannel(n_workers=1)
    try:
        # A worker from a previous incarnation (or a stranger) is turned
        # away — with a reasoned reject, or a plain close — and never
        # occupies a worker slot.
        reply = _hello(port, line)
        assert reply["op"] in ("reject", "eof")
        if reply["op"] == "reject":
            assert "epoch" in reply["reason"]
        time.sleep(0.1)
        assert len(chan._live()) == 0
        # The current incarnation's worker is welcomed and counted.
        reply = _hello(port, json.dumps({"op": "hello", "epoch": 2})
                       .encode() + b"\n")
        assert reply["op"] == "welcome" and reply["epoch"] == 2
        deadline = time.time() + 5
        while len(chan._live()) < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert len(chan._live()) == 1
    finally:
        chan.close()


# -- epoch-scoped pod poison --------------------------------------------------

def test_pod_poison_clears_on_epoch_bump(monkeypatch):
    monkeypatch.setenv("LO_TPU_MESH_EPOCH", "0")
    spmd._set_pod_error("worker died mid-job")
    assert spmd.pod_error() == "worker died mid-job"
    with pytest.raises(spmd.PodDegraded):
        spmd.require_pod_health()
    # The supervisor restarts the pod under the next epoch: poison from
    # the previous incarnation no longer degrades it.
    monkeypatch.setenv("LO_TPU_MESH_EPOCH", "1")
    assert spmd.pod_error() is None
    spmd.require_pod_health()  # no raise


def test_single_process_entry_points_are_no_ops():
    """Without a process group nothing dispatches or refuses."""
    assert not spmd.is_multiprocess()
    spmd.check_mesh_entry("shard_rows")
    spmd.dispatch({"op": "build"})
    spmd.ensure_channel()
    spmd.shutdown_workers()
    with spmd.dispatch_guard():
        assert not spmd.in_mesh_scope()


# -- supervisor restart/backoff/budget ---------------------------------------

def _fast(sup: Supervisor) -> Supervisor:
    sup.SETTLE_S = 0.05
    sup.TERM_GRACE_S = 1.0
    return sup


def test_supervisor_clean_exit_no_restart():
    cfg = Settings()
    cfg.restart_budget = 3
    cfg.restart_backoff_s = 0.05
    sup = _fast(Supervisor([[sys.executable, "-c", "pass"]], cfg=cfg))
    assert sup.run() == 0
    assert sup.restarts == 0
    assert sup.epoch == 0


@pytest.mark.parametrize("healthy_s", [300.0, 0.4],
                         ids=["no_decay", "decay_irrelevant"])
def test_failing_pod_exhausts_budget_and_serves_reason(healthy_s):
    """A pod failing faster than the healthy window never accrues the
    uptime decay needs: the budget exhausts as without decay, and the
    failed pod stays observable on the fallback ``/cluster``."""
    import requests

    cfg = Settings()
    cfg.restart_budget = 2
    cfg.restart_backoff_s = 0.05
    cfg.restart_backoff_max_s = 0.2
    cfg.restart_healthy_s = healthy_s
    port = _free_port()
    sup = _fast(Supervisor(
        [[sys.executable, "-c", "import sys; sys.exit(7)"]],
        cfg=cfg, fallback_port=port))
    try:
        assert sup.run() == 1
        # Budget of 2 restarts was spent, then the third incident gave up;
        # each restart advanced the mesh epoch.
        assert sup.restarts == 3
        assert sup.epoch == 2
        assert "restart budget exhausted" in sup.failure
        assert "exited with code 7" in sup.failure
        info = requests.get(f"http://127.0.0.1:{port}/cluster",
                            timeout=5).json()
        assert info["healthy"] is False
        assert "restart budget exhausted" in info["pod_error"]
        assert info["restarts"] == 3
        assert requests.get(f"http://127.0.0.1:{port}/status",
                            timeout=5).status_code == 503
    finally:
        sup.close()


def test_supervisor_planned_restart_no_budget_new_epoch():
    """A planned rolling restart (SIGHUP → request_planned_restart):
    children are terminated with the drain grace, respawned under the
    NEXT mesh epoch, and no restart budget is consumed."""
    cfg = Settings()
    cfg.restart_budget = 3
    cfg.restart_backoff_s = 0.05
    cfg.drain_timeout_s = 1.0           # keep the TERM grace short
    sup = _fast(Supervisor(
        [[sys.executable, "-c", "import time; time.sleep(60)"]], cfg=cfg))
    t = threading.Thread(target=sup.run, name="sup-run", daemon=True)
    t.start()
    try:
        deadline = time.time() + 10
        while not sup._procs and time.time() < deadline:
            time.sleep(0.02)
        pid0 = sup._procs[0].pid
        sup.request_planned_restart()
        deadline = time.time() + 15
        while time.time() < deadline:
            if sup.epoch == 1 and sup._procs and \
                    sup._procs[0].pid != pid0 and \
                    sup._procs[0].poll() is None:
                break
            time.sleep(0.05)
        assert sup.epoch == 1, "planned restart never advanced the epoch"
        assert sup._procs[0].pid != pid0
        assert sup.restarts == 0        # no budget consumed
        assert sup.failure is None
    finally:
        sup.close()
        t.join(timeout=15)
        assert not t.is_alive()


def test_supervisor_health_poll_triggers_restart():
    from learningorchestra_tpu_torch.serving.http import Router, Server

    # A fake process-0 /cluster reporting a degraded pod: the supervisor
    # must restart the (still-running) child from the health signal alone.
    router = Router()

    @router.route("GET", "/cluster")
    def cluster(_req):
        return 200, {"pod_error": "worker connection lost mid-job",
                     "healthy": False}

    srv = Server(router, "127.0.0.1", 0).start_background()
    cfg = Settings()
    cfg.restart_budget = 0          # first incident exhausts immediately
    cfg.restart_backoff_s = 0.05
    cfg.health_interval_s = 0.1
    sup = _fast(Supervisor(
        [[sys.executable, "-c", "import time; time.sleep(60)"]],
        cfg=cfg, health_url=f"http://127.0.0.1:{srv.port}/cluster"))
    try:
        assert sup.run() == 1
        assert "pod degraded: worker connection lost mid-job" in sup.failure
    finally:
        sup.close()
        srv.stop()


def test_epoch_file_owner_publishes_and_follower_follows(tmp_path):
    root = str(tmp_path / "store")
    epoch_file = tmp_path / "store" / ".mesh_epoch"
    # Host 0's supervisor OWNS the shared epoch: each restart increments
    # and publishes it.
    cfg = Settings()
    cfg.restart_budget = 1
    cfg.restart_backoff_s = 0.05
    owner_env = {**os.environ, "LO_TPU_STORE_ROOT": root}
    owner_env.pop("LO_TPU_PROCESS_ID", None)
    owner = _fast(Supervisor(
        [[sys.executable, "-c", "import sys; sys.exit(9)"]],
        cfg=cfg, env=owner_env))
    assert owner.epoch_owner
    assert owner.run() == 1          # one restart spent, then exhausted
    assert epoch_file.read_text() == "1"
    # A worker host's supervisor FOLLOWS: it adopts the published epoch
    # at spawn, and a file change restarts its children at the new epoch
    # WITHOUT consuming its restart budget.
    fcfg = Settings()
    fcfg.restart_budget = 3
    fcfg.restart_backoff_s = 0.05
    fcfg.health_interval_s = 0.1
    follower = _fast(Supervisor(
        [[sys.executable, "-c", "import time; time.sleep(60)"]],
        cfg=fcfg, env={**os.environ, "LO_TPU_STORE_ROOT": root,
                       "LO_TPU_PROCESS_ID": "1"}))
    assert not follower.epoch_owner
    assert follower.epoch == 1
    t = threading.Thread(target=follower.run, daemon=True)
    t.start()
    try:
        time.sleep(0.5)
        epoch_file.write_text("5")   # the pod restarted under host 0
        deadline = time.time() + 10
        while follower.epoch != 5 and time.time() < deadline:
            time.sleep(0.05)
        assert follower.epoch == 5
        assert follower.restarts == 0   # coordinated follow-up, not budget
    finally:
        follower.request_stop()
        t.join(timeout=10)


def test_restart_budget_decays_after_healthy_window(tmp_path):
    """One blip consumes budget; after a continuous healthy window the
    consumed count resets to zero."""
    flag = str(tmp_path / "blipped")
    code = ("import os,sys,time; p=%r; "
            "(open(p,'w').close(), sys.exit(7)) "
            "if not os.path.exists(p) else time.sleep(60)") % flag
    cfg = Settings()
    cfg.restart_budget = 1
    cfg.restart_backoff_s = 0.05
    cfg.restart_healthy_s = 0.4
    sup = _fast(Supervisor([[sys.executable, "-c", code]], cfg=cfg))
    t = threading.Thread(target=sup.run, name="sup-decay", daemon=True)
    t.start()
    try:
        deadline = time.time() + 15
        while sup.restarts != 1 and time.time() < deadline:
            time.sleep(0.05)
        assert sup.restarts == 1        # the blip spent the whole budget
        deadline = time.time() + 15
        while sup.restarts != 0 and time.time() < deadline:
            time.sleep(0.05)
        assert sup.restarts == 0, "healthy uptime never restored budget"
        assert sup.failure is None
    finally:
        sup.close()
        t.join(timeout=10)
        assert not t.is_alive()


def test_incident_leaves_a_minimal_flight_record(tmp_path):
    """The supervisor is the only witness to a child's exit code: each
    incident drops a manifest-only bundle under the store root."""
    cfg = Settings()
    cfg.restart_budget = 0
    cfg.restart_backoff_s = 0.05
    root = str(tmp_path / "store")
    sup = _fast(Supervisor(
        [[sys.executable, "-c", "import sys; sys.exit(5)"]], cfg=cfg,
        env={**os.environ, "LO_TPU_STORE_ROOT": root}))
    assert sup.run() == 1
    bundles = os.listdir(os.path.join(root, "_flightrec"))
    assert any("supervisor" in b for b in bundles), bundles


# -- failed-job rescan/retry selection ---------------------------------------

def _doc(name, error=None, finished=True, job=None, retries=0):
    doc = {"_id": 0, "filename": name, "finished": finished,
           "fields": [], "retries": retries}
    if error:
        doc["error"] = error
    if job:
        doc["job"] = job
    return doc


def test_select_retry_groups_selection_rules():
    build_job = {"kind": "model_builder", "train": "t", "test": "s",
                 "pred_name": "p", "classifiers": ["lr", "nb"],
                 "label": "y", "steps": [], "hparams": {}}
    hist_job = {"kind": "histogram", "parent": "d", "name": "h",
                "fields": ["v"]}
    docs = [
        _doc("p_lr", error="pod failure: worker died", job=build_job),
        _doc("p_nb", error="interrupted: server restarted mid-job",
             job=build_job),
        _doc("h", error="pod failure: worker died", job=hist_job,
             retries=1),
        _doc("bad", error="ValueError: label field 'y' not in 'train'",
             job=hist_job),
        _doc("orphan", error="pod failure: worker died"),
        _doc("ok"),
        _doc("running", finished=False),
    ]
    groups = select_retry_groups(docs, max_retries=1)
    assert len(groups) == 1
    assert groups[0]["spec"] == build_job
    assert sorted(groups[0]["datasets"]) == ["p_lr", "p_nb"]
    groups = select_retry_groups(docs, max_retries=2)
    assert {g["spec"]["kind"] for g in groups} == {"model_builder",
                                                  "histogram"}


def test_pod_degraded_job_failure_is_retryable(tmp_path):
    """A job REFUSED because the pod is degraded failed from
    infrastructure: it records the retryable ``pod failure:`` prefix."""
    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.jobs import JobManager

    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    cfg.persist = False
    store = DatasetStore(cfg)
    store.create("q_out")
    jm = JobManager(store)

    def refused():
        raise spmd.PodDegraded("pod is degraded (worker died mid-job)")

    jm.submit("model_builder", "q_out", refused)
    jm.wait_all(timeout=10)
    meta = store.get("q_out").metadata
    assert meta.finished
    assert meta.error.startswith("pod failure:")
    groups = select_retry_groups(
        [dict(meta.to_doc(), job={"kind": "model_builder", "train": "t",
                                  "test": "s", "pred_name": "q",
                                  "classifiers": ["lr"], "label": "y"})], 1)
    assert len(groups) == 1


def test_store_reopen_resets_failed_dataset(tmp_path):
    from learningorchestra_tpu_torch.catalog.store import DatasetStore

    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    cfg.persist = True
    store = DatasetStore(cfg)
    store.create("out", columns={"v": np.arange(5)})
    store.fail("out", "pod failure: worker died mid-job")
    ds = store.reopen("out")
    assert ds.metadata.finished is False
    assert ds.metadata.error is None
    assert ds.metadata.extra["retries"] == 1
    assert ds.num_rows == 0
    doc = json.loads(
        (tmp_path / "store" / "out" / "metadata.json").read_text())
    assert doc["finished"] is False and "error" not in doc


def _hist_store(tmp_path, retries):
    from learningorchestra_tpu_torch.catalog.store import DatasetStore

    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    cfg.image_root = str(tmp_path / "images")
    cfg.persist = True
    cfg.job_retries = 1
    store = DatasetStore(cfg)
    store.create("h_src", columns={"v": (np.arange(100) % 3)},
                 finished=True)
    extra = {"job": {"kind": "histogram", "parent": "h_src",
                     "name": "h_out", "fields": ["v"]}}
    if retries:
        extra["retries"] = retries
    store.create("h_out", parent="h_src", extra=extra)
    store.fail("h_out", "pod failure: worker died mid-job")
    return cfg


@pytest.mark.parametrize("retries", [0, 1], ids=["retried", "exhausted"])
def test_app_rescan_retries_a_failed_job_once(tmp_path, retries):
    """A fresh App re-runs a pod-failed histogram job from its recorded
    spec, once: the re-run reaches a clean terminal state; a job whose
    retry budget is spent stays failed."""
    from learningorchestra_tpu_torch.serving.app import App

    cfg = _hist_store(tmp_path, retries)
    app = App(cfg, device="cpu")
    app.jobs.wait_all(timeout=60)
    meta = app.store.get("h_out").metadata
    assert meta.extra["retries"] == 1
    if retries:
        assert meta.error and meta.error.startswith("pod failure:")
        return
    assert meta.finished and meta.error is None
    counts = app.store.get("h_out").columns["counts"][0]
    assert counts == {0: 34, 1: 33, 2: 33}
    app2 = App(cfg, device="cpu")
    app2.jobs.wait_all(timeout=60)
    assert app2.store.get("h_out").metadata.extra["retries"] == 1


def test_app_pod_routes_on_one_process(tmp_path):
    """/cluster, /replication and the PodDegraded 503 on a one-process
    App: the JAX package's keys, and a poisoned pod's gated routes
    answer 503 with the computed Retry-After."""
    from learningorchestra_tpu_torch.serving.app import App
    from learningorchestra_tpu_torch.serving.http import HttpError

    cfg = _hist_store(tmp_path, 1)
    cfg.health_interval_s, cfg.restart_backoff_s = 2.0, 1.0
    app = App(cfg, device="cpu")
    app.jobs.wait_all(timeout=60)
    status, info = app.router.dispatch("GET", "/cluster", None)
    assert status == 200
    for k in ("mesh", "mesh_epoch", "pod_error", "healthy", "restarts",
              "resources", "process_index", "process_count", "backend"):
        assert k in info, k
    assert info["healthy"] and info["pod_error"] is None
    assert "launches" in info["resources"]["0"]
    status, rep = app.router.dispatch("GET", "/replication", None)
    assert status == 200 and isinstance(rep, dict)
    spmd._set_pod_error("worker died mid-job")
    with pytest.raises(HttpError) as err:
        app.router.dispatch("POST", "/histograms/h_src",
                            {"histogram_filename": "h2", "fields": ["v"]})
    assert err.value.status == 503
    assert err.value.headers["Retry-After"] == "3"
    health = app._health_doc()
    assert health["checks"]["pod"] == {"ok": False,
                                       "error": "worker died mid-job"}
    assert app._metrics_doc()["pod"]["degraded"] is True


# -- two gloo ranks that lose a worker (tests/test_multiprocess.py) -----------

def _split(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    return {"a": a, "label": (a > 0).astype(np.int64)}


def _rank_main(mode, pid, nprocs, coord, job_port, http_port, root):
    """One rank of a two-rank CPU pod (run as a script)."""
    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.parallel import distributed
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

    os.environ["LO_TPU_JOB_PORT"] = str(job_port)
    distributed.initialize(f"127.0.0.1:{coord}", nprocs, pid,
                           device="cpu", timeout_s=30.0)
    cfg = Settings()
    cfg.store_root = os.path.join(root, "store")
    cfg.persist = True
    cfg.host, cfg.port = "127.0.0.1", http_port
    epoch = spmd.mesh_epoch()
    if pid != 0:
        store = DatasetStore(cfg)
        runtime = DeviceRuntime(cfg, device="cpu")
        runtime.mesh
        if mode == "chaos" or epoch < 1:
            # Prep normally (a realistic 'ready' ack), then die at the
            # first device op after 'go' — the mid-collective window.
            real = spmd._PREPPERS["build"]

            def dying(store_, runtime_, spec):
                real(store_, runtime_, spec)
                if mode == "chaos":
                    return lambda: os._exit(42)
                return lambda: os.kill(os.getpid(), signal.SIGKILL)

            spmd._PREPPERS["build"] = dying
        reason = spmd.worker_loop(store, runtime)
        sys.exit(0 if reason == "shutdown" else 3)
    spmd.ensure_channel()
    if mode == "chaos":
        _chaos_controller(cfg, root)
        return
    from learningorchestra_tpu_torch.serving.app import App

    app = App(cfg, device="cpu")   # epoch >= 1: the rescan resubmits here
    app.runtime.mesh
    if epoch == 0:
        app.store.create("e_train", columns=_split(0, 2000), finished=True)
        app.store.create("e_test", columns=_split(1, 500), finished=True)
        job = {"kind": "model_builder", "train": "e_train",
               "test": "e_test", "pred_name": "e_pred",
               "classifiers": ["lr"], "label": "label", "steps": [],
               "hparams": {}}
        app.store.create("e_pred_lr", parent="e_test",
                         extra={"classifier": "lr", "label": "label",
                                "job": job})
        app.jobs.submit(
            "model_builder", ["e_pred_lr"],
            lambda: app.builder.build("e_train", "e_test", "e_pred",
                                      ["lr"], "label", existing=True))
    app.serve()             # blocks; the supervisor kills/restarts us


def _chaos_controller(cfg, root):
    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.models.builder import ModelBuilder
    from learningorchestra_tpu_torch.ops.histogram import create_histogram
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

    store = DatasetStore(cfg)
    runtime = DeviceRuntime(cfg, device="cpu")
    runtime.mesh
    store.create("c_train", columns=_split(0, 2000), finished=True)
    store.create("c_test", columns=_split(1, 500), finished=True)
    mb = ModelBuilder(store, runtime, cfg)
    state = {}

    def run_build():
        # May stay stuck in a collective once the worker dies — the
        # watchdog's job is to make the FAILURE visible meanwhile.
        try:
            mb.build("c_train", "c_test", "c_pred", ["lr"], "label")
            state["status"] = "returned"
        except Exception as exc:  # noqa: BLE001
            state["status"] = f"raised:{type(exc).__name__}"

    threading.Thread(target=run_build, daemon=True).start()
    out = {"error": None}
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            doc = store.read("c_pred_lr", limit=1)[0]
            if doc.get("finished") and doc.get("error"):
                out["error"] = doc["error"]
                break
        except Exception:  # noqa: BLE001 — dataset not created yet
            pass
        time.sleep(0.2)
    # The pod is now permanently short a worker: the next dispatch must
    # refuse immediately with the degradation reason.
    store.create("c_h", columns={"v": (np.arange(100) % 3)},
                 finished=True)
    t0 = time.time()
    try:
        create_histogram(store, "c_h", "c_hist", ["v"], runtime=runtime)
        out["second_job"] = "ran"
    except RuntimeError as exc:
        out["second_job"] = f"refused: {exc}"
    out["second_job_s"] = time.time() - t0
    out["build_thread"] = state.get("status", "stuck")
    with open(os.path.join(root, "chaos.json"), "w") as f:
        json.dump(out, f)
    os._exit(0)


def _rank_cmd(mode, pid, coord, job_port, http_port, root):
    return [sys.executable, HERE, mode, str(pid), "2", str(coord),
            str(job_port), str(http_port), str(root)]


def _env():
    return {k: v for k, v in os.environ.items()
            if k not in ("LO_TPU_MESH_EPOCH", "LO_TPU_RESTART_COUNT",
                         "LO_TPU_COORDINATOR", "LO_TPU_NUM_PROCESSES",
                         "LO_TPU_PROCESS_ID")}


def test_worker_death_mid_job_fails_pollably(tmp_path):
    """A worker dying AFTER 'go' (the mid-collective window) surfaces as
    a recorded, pollable job failure on process 0 — not a silent pod
    wedge — and later dispatches refuse fast."""
    coord, job_port = _free_port(), _free_port()
    procs = [subprocess.Popen(
        _rank_cmd("chaos", i, coord, job_port, 0, tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=90)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("chaos pod deadlocked:\n" + "\n---\n".join(
            o or "" for o in outs))
    assert procs[0].returncode == 0, f"process 0 failed:\n{outs[0]}"
    assert procs[1].returncode == 42, "the worker should have died"
    with open(tmp_path / "chaos.json") as f:
        result = json.load(f)
    assert result["error"] and result["error"].startswith("pod failure:")
    assert result["second_job"].startswith("refused"), result
    assert "degraded" in result["second_job"], result
    assert result["second_job_s"] < 10.0, result


def test_elastic_recovery_supervised_restart(tmp_path):
    """detect → fail → restart → retry → succeed: SIGKILL a worker
    mid-collective; the watchdog flips the job's output to a pollable
    failure; the supervisor restarts the pod under a new mesh epoch; the
    restarted process 0 rescans the store and re-runs the recorded build,
    which completes with correct outputs."""
    import requests

    coord, job_port, http_port = _free_port(), _free_port(), _free_port()
    cfg = Settings()
    cfg.restart_budget = 3
    cfg.restart_backoff_s = 0.2
    cfg.restart_backoff_max_s = 1.0
    cfg.health_interval_s = 0.5
    sup = Supervisor(
        [_rank_cmd("elastic", i, coord, job_port, http_port, tmp_path)
         for i in range(2)], cfg=cfg, env=_env(),
        health_url=f"http://127.0.0.1:{http_port}/cluster")
    runner = threading.Thread(target=sup.run, daemon=True)
    runner.start()
    try:
        meta_path = tmp_path / "store" / "e_pred_lr" / "metadata.json"
        deadline = time.time() + 80
        doc = None
        while time.time() < deadline:
            if meta_path.is_file():
                got = json.loads(meta_path.read_text() or "{}")
                if got.get("finished") and not got.get("error") \
                        and got.get("retries"):
                    doc = got
                    break
            time.sleep(0.5)
        assert doc is not None, (
            "retried job never reached a clean terminal state "
            f"(supervisor: restarts={sup.restarts}, epoch={sup.epoch}, "
            f"failure={sup.failure})")
        assert doc["retries"] == 1, doc
        assert sup.restarts == 1, sup.failure
        assert sup.epoch == 1
        assert doc["f1"] > 0.85, doc
        base = f"http://127.0.0.1:{http_port}"
        info = requests.get(f"{base}/cluster", timeout=10).json()
        assert info["mesh_epoch"] == 1, info
        assert info["healthy"] is True and info["pod_error"] is None, info
        assert info["process_count"] == 2, info
        assert info["mesh"] == {"data": 2, "model": 1, "seq": 1}, info
        assert info["backend"] == "gloo", info
        assert info["resources"]["0"]["host"]["rss_bytes"] > 0, info
        assert info["resources"]["1"]["host"]["rss_bytes"] > 0, info
        jobs_doc = requests.get(f"{base}/jobs", timeout=10).json()
        done = [j for j in jobs_doc
                if j["kind"].endswith("model_builder")
                and j["status"] == "done"]
        assert done, jobs_doc
        prof = done[0].get("profile") or {}
        assert prof.get("peak_hbm_bytes", 0) > 0, prof
        assert "compile_s" in prof, prof
        hz = requests.get(f"{base}/healthz", timeout=10)
        assert hz.status_code == 200, hz.text
        assert hz.json()["healthy"] is True, hz.text
        res = requests.get(f"{base}/resources", timeout=10).json()
        assert res["host"]["rss_bytes"] > 0, res
        assert res["disk"]["free_bytes"] > 0, res
    finally:
        sup.close()
        runner.join(timeout=15)


if __name__ == "__main__":
    _rank_main(sys.argv[1], *map(int, sys.argv[2:7]), sys.argv[7])
