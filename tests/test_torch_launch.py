"""The PyTorch package's pod launcher (``python -m
learningorchestra_tpu_torch.launch``) and ``deploy/run_pod_torch.sh``,
on the CPU.

The launcher runs as its own process, as the supervisor runs it. Its
ranks are small Python scripts written under the test's temporary
directory (they write what they see into files there), or, in the
end-to-end case, two ranks of ``python -m
learningorchestra_tpu_torch.serving --device cpu --dist-backend gloo``
under ``python -m learningorchestra_tpu_torch.supervisor``, joined at
``tcp://127.0.0.1:<free port>``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = [sys.executable, "-m", "learningorchestra_tpu_torch.launch"]

#: A rank: records its environment, then exits with ``code`` after
#: ``sleep`` seconds, or at once with 0 on SIGTERM, which it records. Its
#: argv is ``<dir>`` and one ``<sleep> <code>`` pair a global rank.
RANK = r'''
import json, os, signal, sys, time
out = sys.argv[1]
rank = int(os.environ["LO_TPU_PROCESS_ID"])
sleep_s, code = (float(sys.argv[2 + 2 * rank]), int(sys.argv[3 + 2 * rank]))
with open(os.path.join(out, "env%d.json" % rank), "w") as f:
    json.dump({k: v for k, v in os.environ.items()
               if k.startswith("LO_TPU_")} | {"pid": os.getpid()}, f)

def term(signum, frame):
    with open(os.path.join(out, "signal%d" % rank), "w") as f:
        f.write(str(signum))
    sys.exit(0)

signal.signal(signal.SIGTERM, term)
time.sleep(sleep_s)
with open(os.path.join(out, "done%d" % rank), "w") as f:
    f.write("done")
sys.exit(code)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LO_TPU_")}
    env.update({"LO_TPU_LOG_FORMAT": "json", **extra})
    return env


def _launch(tmp_path, args, plan, **env):
    """Start the launcher over ``plan`` ((sleep, code) a global rank)."""
    script = tmp_path / "rank.py"
    script.write_text(RANK)
    argv = [str(tmp_path)] + [str(v) for pair in plan for v in pair]
    return subprocess.Popen(
        LAUNCH + args + ["--", sys.executable, str(script)] + argv,
        cwd=REPO, env=_env(**env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _events(stderr: str, event: str) -> list:
    out = []
    for line in stderr.splitlines():
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if doc.get("logger") == "lo_tpu.launch" and doc.get("event") == event:
            out.append(doc)
    return out


def _wait_for(path, timeout_s=30.0):
    t0 = time.time()
    while not os.path.exists(path):
        assert time.time() - t0 < timeout_s, f"{path} never appeared"
        time.sleep(0.05)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_global_ids_of_the_second_host(tmp_path):
    """``--host-id 1 --num-hosts 2 --ranks 2``: ids 2 and 3 of 4; the
    rest of the environment passes through."""
    plan = [(0, 0)] * 4
    p = _launch(tmp_path, ["--ranks", "2", "--host-id", "1",
                           "--num-hosts", "2"], plan,
                LO_TPU_MESH_EPOCH="3", LO_TPU_MESH_SHAPE="2,2",
                LO_TPU_COORDINATOR="10.0.0.1:8476")
    _, err = p.communicate(timeout=60)
    assert p.returncode == 0, err
    assert not (tmp_path / "env0.json").exists()
    for rank in (2, 3):
        env = json.loads((tmp_path / f"env{rank}.json").read_text())
        assert env["LO_TPU_PROCESS_ID"] == str(rank)
        assert env["LO_TPU_NUM_PROCESSES"] == "4"
        assert env["LO_TPU_MESH_EPOCH"] == "3"
        assert env["LO_TPU_MESH_SHAPE"] == "2,2"
        assert env["LO_TPU_COORDINATOR"] == "10.0.0.1:8476"


def test_sigterm_reaches_every_rank_and_the_launcher_exits_after_them(
        tmp_path):
    p = _launch(tmp_path, ["--ranks", "2"], [(60, 0), (60, 0)])
    for rank in (0, 1):
        _wait_for(tmp_path / f"env{rank}.json")
    pids = [json.loads((tmp_path / f"env{r}.json").read_text())["pid"]
            for r in (0, 1)]
    p.send_signal(signal.SIGTERM)
    _, err = p.communicate(timeout=30)
    assert p.returncode == 0, err
    for rank, pid in enumerate(pids):
        assert (tmp_path / f"signal{rank}").read_text() == \
            str(int(signal.SIGTERM))
        assert not _alive(pid)


def test_ranks_die_with_a_killed_launcher(tmp_path):
    """The supervisor escalates to SIGKILL past its grace: the ranks go
    with the launcher instead of outliving the pod's incarnation."""
    p = _launch(tmp_path, ["--ranks", "2"], [(60, 0), (60, 0)])
    for rank in (0, 1):
        _wait_for(tmp_path / f"env{rank}.json")
    pids = [json.loads((tmp_path / f"env{r}.json").read_text())["pid"]
            for r in (0, 1)]
    p.kill()
    p.communicate(timeout=30)
    t0 = time.time()
    while any(_alive(pid) for pid in pids) and time.time() - t0 < 10:
        time.sleep(0.05)
    assert not any(_alive(pid) for pid in pids)


@pytest.mark.parametrize("plan,want", [
    # Rank 1 fails at once; rank 0 runs on to its end.
    ([(1.5, 0), (0, 7)], 7),
    # Both fail: the first to exit gives the code.
    ([(1.5, 5), (0, 7)], 7),
    ([(0, 5), (1.5, 7)], 5),
])
def test_exit_code_is_the_first_failing_ranks_and_others_run_on(
        tmp_path, plan, want):
    p = _launch(tmp_path, ["--ranks", "2"], plan)
    _, err = p.communicate(timeout=60)
    assert p.returncode == want, err
    for rank in (0, 1):
        assert (tmp_path / f"done{rank}").exists()
        assert not (tmp_path / f"signal{rank}").exists()


def test_each_rank_start_and_exit_is_a_structured_log_line(tmp_path):
    t0 = time.time()
    p = _launch(tmp_path, ["--ranks", "2"], [(1.5, 0), (0, 3)],
                LO_TPU_MESH_EPOCH="2")
    _, err = p.communicate(timeout=60)
    assert p.returncode == 3, err
    started = {d["rank"]: d for d in _events(err, "rank_start")}
    exits = {d["rank"]: d for d in _events(err, "rank_exit")}
    assert sorted(started) == sorted(exits) == [0, 1], err
    for rank, want in ((0, 0), (1, 3)):
        env = json.loads((tmp_path / f"env{rank}.json").read_text())
        doc = exits[rank]
        assert doc["code"] == want and doc["epoch"] == 2
        assert doc["pid"] == env["pid"] == started[rank]["pid"]
        assert t0 <= started[rank]["t"] <= doc["t"] <= time.time()
    assert exits[1]["t"] < exits[0]["t"]


def test_no_device_and_no_ranks_is_refused(tmp_path):
    code = ("import sys, torch\n"
            "torch.cuda.device_count = lambda: 0\n"
            "from learningorchestra_tpu_torch import launch\n"
            "sys.argv = ['launch', '--', 'true']\n"
            "sys.exit(launch.main())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2
    assert "no CUDA device on this host: pass --ranks" in p.stderr


def test_run_pod_torch_script_parses():
    p = subprocess.run(["bash", "-n",
                        os.path.join(REPO, "deploy", "run_pod_torch.sh")],
                       capture_output=True, text=True, timeout=30)
    assert p.returncode == 0, p.stderr


def test_supervisor_launches_a_two_rank_pod(tmp_path):
    """supervisor → launch → 2 × serving on the CPU over gloo: process 0
    answers ``/cluster`` with both ranks; a SIGTERM to the supervisor
    takes the pod down."""
    import requests

    http_port, coord, job_port = _free_port(), _free_port(), _free_port()
    store = tmp_path / "store"
    env = _env(LO_TPU_STORE_ROOT=str(store),
               LO_TPU_COORDINATOR=f"127.0.0.1:{coord}",
               LO_TPU_JOB_PORT=str(job_port), LO_TPU_DRAIN_TIMEOUT_S="2")
    logs = tmp_path / "logs"
    sup_log = open(tmp_path / "supervisor.log", "w")
    sup = subprocess.Popen(
        [sys.executable, "-m", "learningorchestra_tpu_torch.supervisor",
         "--health-url", f"http://127.0.0.1:{http_port}/cluster", "--"]
        + LAUNCH + ["--ranks", "2", "--log-dir", str(logs), "--",
                    sys.executable, "-m",
                    "learningorchestra_tpu_torch.serving", "--device", "cpu",
                    "--dist-backend", "gloo", "--host", "127.0.0.1",
                    "--port", str(http_port), "--store-root", str(store)],
        cwd=REPO, env=env, stdout=sup_log, stderr=subprocess.STDOUT,
        start_new_session=True)
    try:
        info, t0 = None, time.time()
        while time.time() - t0 < 120:
            try:
                info = requests.get(f"http://127.0.0.1:{http_port}/cluster",
                                    timeout=5).json()
                if str(1) in info.get("resources", {}):
                    break
            except (requests.RequestException, ValueError):
                pass
            assert sup.poll() is None, (tmp_path / "supervisor.log") \
                .read_text()
            time.sleep(0.25)
        assert info is not None and info["process_count"] == 2, info
        assert info["mesh"] == {"data": 2, "model": 1, "seq": 1}, info
        assert info["backend"] == "gloo" and info["healthy"], info
        assert sorted(info["resources"]) == ["0", "1"], info
        assert sorted(os.listdir(logs)) == ["rank0_epoch0.log",
                                            "rank1_epoch0.log"]
        sup.send_signal(signal.SIGTERM)
        assert sup.wait(timeout=60) == 0
    finally:
        if sup.poll() is None:
            os.killpg(sup.pid, signal.SIGKILL)
            sup.wait()
        sup_log.close()
    text = (tmp_path / "supervisor.log").read_text()
    exits = _events(text, "rank_exit")
    assert sorted(d["rank"] for d in exits) == [0, 1], text
