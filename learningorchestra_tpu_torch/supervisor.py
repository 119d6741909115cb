"""Pod supervisor — elastic recovery for degraded pods.

The reference self-heals at the orchestration tier: every service runs
under Docker Swarm with ``restart_policy: on-failure`` (reference
docker-compose.yml:14-15), so a crashed worker JVM comes back and Spark
re-runs its lost tasks (the MLlib execution model). Our pod runtime had
only the *detection* half: the SPMD watchdog (parallel/spmd.py) converts
a worker death into a poisoned pod with pollable job failures — and then
a human had to restart the pod.

This module closes the loop. A :class:`Supervisor` owns every pod
process on its host and

1. **watches** them — child exit codes, plus a periodic ``/cluster``
   health poll that catches degradations where no *local* process died
   (a remote host's worker vanished and the watchdog poisoned process 0);
2. **restarts** the whole pod on failure, under bounded exponential
   backoff and a restart budget (``Settings.restart_budget`` /
   ``restart_backoff_s``), killing every child first — half a pod can
   never rejoin, so the unit of recovery is the pod, not the process;
3. **advances the mesh epoch** (``LO_TPU_MESH_EPOCH``) on every restart.
   The job channel's handshake rejects a worker whose epoch differs
   (spmd._JobChannel), so a stale process that somehow outlived the kill
   is turned away instead of corrupting the new incarnation's
   collectives, and the epoch-scoped pod poison clears itself — the
   restarted pod serves without manual intervention;
4. **exhausts cleanly**: past the restart budget the supervisor stops
   trying and serves a minimal fallback ``/cluster`` on the pod's port
   reporting why, so operators (and the client SDK) see a reasoned
   failure instead of connection refused.

Job-level recovery composes on top: on startup, process 0's App rescans
the store for datasets failed with an infrastructure error (``pod
failure:`` / ``interrupted:``), and re-runs their recorded job specs up
to ``LO_TPU_JOB_RETRIES`` times (jobs.select_retry_groups +
serving/app.py) — safe because the chunk store is journaled and output
datasets are reset via ``DatasetStore.reopen`` before the re-run. The
full lifecycle is detect (watchdog) → fail (pollable outputs) → restart
(this module, new epoch) → retry (rescan) → succeed.

Run as ``python -m learningorchestra_tpu_torch.supervisor -- <pod
command>`` on each host (the command defaults to ``python -m
learningorchestra_tpu_torch.serving``; the README shows a pod's
environment). This is the JAX package's supervisor
(``learningorchestra_tpu/supervisor.py``) for this package's pod.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

from learningorchestra_tpu_torch.config import (
    Settings, settings as global_settings)
from learningorchestra_tpu_torch.utils import structlog

log = structlog.get_logger("supervisor")

#: Exit code a pod process uses for "this incarnation cannot continue but
#: the pod should" — controller lost / stale epoch (serving/__main__.py).
#: Follower supervisors treat it as pod-coordination, not local failure.
RESTARTABLE_EXIT = 3


class Supervisor:
    """Supervise the pod processes of one host; restart them together.

    ``commands`` is one argv per pod process to run on this host (one
    entry in production — the serving module decides server vs worker
    role from LO_TPU_PROCESS_ID; tests pass several to host a whole pod
    under a single supervisor). ``health_url`` optionally names process
    0's ``/cluster`` endpoint; a poll reporting ``pod_error`` triggers a
    restart just like a child death does. ``fallback_port`` is where the
    budget-exhausted failure report is served.

    **Multi-host epoch agreement.** On a pod spanning hosts, each host
    runs its own supervisor, and the job channel admits workers only at
    the exact pod epoch — so the counters must agree. The single source
    of truth is an epoch FILE on the shared store root
    (``<LO_TPU_STORE_ROOT>/.mesh_epoch`` — the same shared filesystem
    the data plane already requires). Host 0's supervisor (env
    ``LO_TPU_PROCESS_ID`` unset or ``0``) OWNS the file: it increments
    it on every restart. Every other supervisor FOLLOWS it: it respawns
    with the file's value, never counts its own increments, and treats
    a file change while its children run as the signal that the pod
    restarted — it restarts its local children at the new epoch without
    consuming restart budget (a coordinated follow-up, not a local
    failure). A worker that races ahead of a restart simply gets
    rejected at handshake, exits nonzero, and its supervisor respawns
    it with the then-current file value — convergent, because the owner
    only moves the epoch forward. Without ``LO_TPU_STORE_ROOT`` in the
    environment (single-host dev), the epoch is a local counter.
    """

    #: Child poll cadence, seconds.
    POLL_S = 0.2
    #: Grace between detecting an incident and killing survivors — lets
    #: process 0's watchdog flush ``pod failure:`` flags to the store so
    #: the restarted incarnation's retry rescan sees the root cause.
    SETTLE_S = 1.0
    #: SIGTERM → SIGKILL escalation grace, seconds.
    TERM_GRACE_S = 5.0

    def __init__(self, commands: Sequence[Sequence[str]], *,
                 cfg: Optional[Settings] = None,
                 env: Optional[Dict[str, str]] = None,
                 health_url: Optional[str] = None,
                 fallback_host: str = "0.0.0.0",
                 fallback_port: Optional[int] = None,
                 initial_epoch: int = 0,
                 epoch_file: Optional[str] = None):
        if not commands:
            raise ValueError("supervisor needs at least one command")
        self.commands = [list(c) for c in commands]
        self.cfg = cfg or global_settings
        self.env = dict(env if env is not None else os.environ)
        self.health_url = health_url
        self.fallback_host = fallback_host
        self.fallback_port = fallback_port
        # Shared-epoch wiring (see class docstring): the file lives on
        # the pod's shared store root; host 0 owns it, others follow it.
        if epoch_file is None and self.env.get("LO_TPU_STORE_ROOT"):
            epoch_file = os.path.join(self.env["LO_TPU_STORE_ROOT"],
                                      ".mesh_epoch")
        self.epoch_file = epoch_file
        self.epoch_owner = self.env.get("LO_TPU_PROCESS_ID", "0") in ("", "0")
        self.epoch = int(initial_epoch)
        if self.epoch_file:
            if self.epoch_owner:
                # Resume monotonically across supervisor restarts: a
                # worker that outlived a full redeploy must still read
                # as stale.
                self.epoch = max(self.epoch, self._read_epoch_file())
                self._write_epoch_file()
            else:
                self.epoch = self._read_epoch_file()
        self.restarts = 0
        self.failure: Optional[str] = None
        self.fallback_server = None
        self._procs: List[subprocess.Popen] = []
        self._stop = threading.Event()
        #: Planned rolling restart requested (SIGHUP / tests): children
        #: are SIGTERMed and given the full graceful-drain window
        #: (LO_TPU_DRAIN_TIMEOUT_S — the server finishes its accepted
        #: requests behind its drain gate) before SIGKILL; consumes no
        #: restart budget and advances the mesh epoch like any restart.
        self._planned = threading.Event()

    # -- shared mesh-epoch file ----------------------------------------------

    def _read_epoch_file(self) -> int:
        try:
            with open(self.epoch_file) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _write_epoch_file(self) -> None:
        try:
            os.makedirs(os.path.dirname(self.epoch_file), exist_ok=True)
            tmp = self.epoch_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(self.epoch))
            os.replace(tmp, self.epoch_file)
        except OSError as exc:
            log.error("could not write epoch file %s: %s",
                      self.epoch_file, exc)

    def _advance_epoch(self) -> None:
        """Move to the next incarnation's epoch: the owner increments
        (and publishes); followers adopt whatever the owner last
        published — convergent even when a follower restarts first."""
        if self.epoch_owner:
            self.epoch += 1
            if self.epoch_file:
                self._write_epoch_file()
        else:
            self.epoch = self._read_epoch_file() if self.epoch_file \
                else self.epoch + 1

    # -- process control -----------------------------------------------------

    def _spawn_all(self) -> None:
        env = dict(self.env)
        env["LO_TPU_MESH_EPOCH"] = str(self.epoch)
        env["LO_TPU_RESTART_COUNT"] = str(self.restarts)
        self._procs = [
            subprocess.Popen(argv, env=env) for argv in self.commands]
        log.info("spawned %d pod process(es) at mesh epoch %d",
                 len(self._procs), self.epoch)

    def _kill_all(self, grace_s: Optional[float] = None) -> None:
        """SIGTERM every child, escalate to SIGKILL after ``grace_s``
        (default: the crash-path TERM_GRACE_S). The planned-restart path
        passes the graceful-drain window instead — SIGTERM triggers the
        server's drain (serving/__main__.py), and killing it mid-drain
        would drop exactly the accepted requests the drain exists to
        finish."""
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.time() + (self.TERM_GRACE_S if grace_s is None
                                  else grace_s)
        for p in self._procs:
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
                p.wait()

    def request_planned_restart(self) -> None:
        """Ask for a graceful rolling restart (wired to SIGHUP in
        ``main``): drain-then-restart under a fresh mesh epoch, zero
        accepted requests lost, zero restart budget consumed."""
        self._planned.set()

    def request_stop(self) -> None:
        """Stop supervising: kill the children and end ``run()`` (tests,
        controlled shutdown)."""
        self._stop.set()

    def wait_for_stop(self) -> None:
        """Block until ``request_stop`` (signal handlers route here) —
        how ``main()`` keeps the budget-exhausted fallback responder up
        while staying killable by SIGTERM/SIGINT."""
        self._stop.wait()

    # -- health --------------------------------------------------------------

    def _poll_health(self) -> Optional[str]:
        """The pod's degradation reason per ``/cluster``, or None. An
        unreachable endpoint is NOT an incident — the server may still be
        initializing; child exit codes govern liveness."""
        if not self.health_url:
            return None
        try:
            with urllib.request.urlopen(self.health_url, timeout=2.0) as r:
                info = json.loads(r.read().decode("utf-8"))
        except (OSError, ValueError, urllib.error.URLError):
            return None
        err = info.get("pod_error")
        return str(err) if err else None

    # -- the supervision loop ------------------------------------------------

    def run(self) -> int:
        """Supervise until clean exit (0), stop request (0), or restart
        budget exhaustion (1, with the reason served on the fallback
        ``/cluster`` responder)."""
        self._spawn_all()
        next_health = time.time() + self.cfg.health_interval_s
        healthy_since = time.time()
        while not self._stop.is_set():
            if self._planned.is_set():
                self._planned.clear()
                log.info("planned rolling restart at epoch %d: draining "
                         "children (up to %.0fs)", self.epoch,
                         self.cfg.drain_timeout_s)
                # SIGTERM → the server drains (finishes accepted work,
                # rejects new 503) → exits; escalate only past the drain
                # window plus the usual grace. Not an incident: no
                # budget, no backoff — but a fresh epoch, like any
                # restart, so stale workers are turned away.
                self._kill_all(
                    grace_s=self.cfg.drain_timeout_s + self.TERM_GRACE_S)
                self._advance_epoch()
                next_health = time.time() + self.cfg.health_interval_s
                self._spawn_all()
                healthy_since = time.time()
                continue
            codes = [p.poll() for p in self._procs]
            if all(c == 0 for c in codes):
                log.info("all pod processes exited cleanly")
                return 0
            incident = None
            follow = False
            bad = [(i, c) for i, c in enumerate(codes)
                   if c is not None and c != 0]
            if bad:
                incident = "; ".join(
                    f"process {i} exited with code {c}" for i, c in bad)
                if (not self.epoch_owner and self.epoch_file
                        and all(c == RESTARTABLE_EXIT for _, c in bad)):
                    # Exit 3 = controller lost / epoch went stale
                    # (serving/__main__.py): the pod is restarting under
                    # host 0's supervisor. A coordinated follow-up, not a
                    # local failure — no budget; just wait out the new
                    # epoch below.
                    follow = True
            elif time.time() >= next_health:
                next_health = time.time() + self.cfg.health_interval_s
                reason = self._poll_health()
                if reason:
                    incident = f"pod degraded: {reason}"
                elif (not self.epoch_owner and self.epoch_file
                      and self._read_epoch_file() != self.epoch):
                    # The pod restarted under host 0's supervisor: follow
                    # it. A coordinated follow-up, not a local failure —
                    # it consumes no restart budget.
                    incident = (f"pod epoch advanced to "
                                f"{self._read_epoch_file()}")
                    follow = True
            if incident is None:
                # Restart-budget decay: after LO_TPU_RESTART_HEALTHY_S
                # of CONTINUOUS healthy uptime, consumed budget resets —
                # an incident from hours ago must not doom tonight's
                # single blip (exhaustion used to be permanent). A pod
                # flapping faster than the window never reaches here
                # with budget consumed long enough to reset, so repeated
                # failure still exhausts exactly as before.
                if (self.restarts > 0 and self.cfg.restart_healthy_s > 0
                        and time.time() - healthy_since
                        >= self.cfg.restart_healthy_s):
                    log.info(
                        "pod healthy for %.0fs: restart budget restored "
                        "(%d restart(s) forgiven)",
                        self.cfg.restart_healthy_s, self.restarts)
                    self.restarts = 0
                self._stop.wait(self.POLL_S)
                continue
            log.warning("pod incident at epoch %d: %s", self.epoch, incident)
            self._record_incident(incident, codes, follow)
            # Give the watchdog time to flush pollable failure records
            # before the survivors die with it.
            if self._stop.wait(self.SETTLE_S):
                break
            self._kill_all()
            if follow and not self.epoch_owner and self.epoch_file:
                # Respawn only once host 0 has published the next epoch —
                # respawning sooner would just be rejected at handshake
                # and look like a local failure. (If host 0's supervisor
                # exhausted its budget the pod is dead; we idle here,
                # still killable via request_stop/SIGTERM.)
                while (not self._stop.is_set()
                       and self._read_epoch_file() == self.epoch):
                    self._stop.wait(self.POLL_S)
                if self._stop.is_set():
                    break
            if not follow:
                self.restarts += 1
                if self.restarts > self.cfg.restart_budget:
                    self.failure = (
                        f"restart budget exhausted "
                        f"({self.cfg.restart_budget} restart(s)); "
                        f"last incident: {incident}")
                    log.error("%s", self.failure)
                    self._serve_fallback()
                    return 1
                backoff = min(
                    self.cfg.restart_backoff_max_s,
                    self.cfg.restart_backoff_s * (2 ** (self.restarts - 1)))
                log.info("restarting pod in %.1fs (restart %d/%d)",
                         backoff, self.restarts, self.cfg.restart_budget)
                if self._stop.wait(backoff):
                    break
            self._advance_epoch()
            next_health = time.time() + self.cfg.health_interval_s
            self._spawn_all()
            healthy_since = time.time()
        self._kill_all()
        return 0

    def _record_incident(self, incident: str, codes: List[Optional[int]],
                         follow: bool) -> None:
        """Drop a manifest-only flight-recorder bundle on the shared
        store root: the children about to be killed can no longer dump
        their own, and the supervisor is the only witness to exit
        codes. A coordinated epoch follow-up is not an incident worth a
        bundle. Best-effort — recording must never delay the restart."""
        if follow:
            return
        store_root = self.env.get("LO_TPU_STORE_ROOT") or \
            self.cfg.store_root
        from learningorchestra_tpu_torch.utils import flightrec

        flightrec.dump_minimal(
            store_root, "supervisor:incident",
            detail={"incident": incident,
                    "exit_codes": codes,
                    "mesh_epoch": self.epoch,
                    "restarts": self.restarts,
                    "restart_budget": self.cfg.restart_budget},
            keep=self.cfg.flightrec_keep)

    # -- budget-exhausted fallback -------------------------------------------

    def _serve_fallback(self) -> None:
        """Serve a minimal ``/cluster`` on the pod's port reporting the
        terminal failure — the pod stays *observably* failed instead of
        going connection-refused dark."""
        if self.fallback_port is None:
            return
        from learningorchestra_tpu_torch.serving.http import (
            HttpError, Router, Server)

        sup = self

        router = Router()

        @router.route("GET", "/cluster")
        def cluster(_req) -> Any:
            return 200, {
                "supervisor": "failed",
                "pod_error": sup.failure,
                "restarts": sup.restarts,
                "restart_budget": sup.cfg.restart_budget,
                "mesh_epoch": sup.epoch,
                "healthy": False,
            }

        @router.route("GET", "/status")
        def status(_req) -> Any:
            raise HttpError(503, sup.failure or "pod failed",
                            headers={"Retry-After": "60"})

        try:
            self.fallback_server = Server(
                router, self.fallback_host, self.fallback_port)
            self.fallback_server.start_background()
            log.info("fallback /cluster responder on %s:%d",
                     self.fallback_host, self.fallback_port)
        except OSError as exc:
            log.error("could not start fallback responder: %s", exc)

    def close(self) -> None:
        self.request_stop()
        self._kill_all()
        if self.fallback_server is not None:
            self.fallback_server.stop()
            self.fallback_server = None


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="learningorchestra_tpu_torch pod supervisor",
        epilog="Everything after '--' is the pod command to supervise; "
               "defaults to 'python -m learningorchestra_tpu_torch.serving'.")
    parser.add_argument("--health-url", default=None,
                        help="process 0's /cluster URL to poll (host 0 only)")
    parser.add_argument("--fallback-port", type=int, default=None,
                        help="serve the budget-exhausted failure report "
                             "on this port")
    args, rest = parser.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]
    command = rest or [sys.executable, "-m",
                       "learningorchestra_tpu_torch.serving"]

    sup = Supervisor([command], health_url=args.health_url,
                     fallback_port=args.fallback_port)
    signal.signal(signal.SIGTERM, lambda *_: sup.request_stop())
    signal.signal(signal.SIGINT, lambda *_: sup.request_stop())
    # SIGHUP = planned rolling restart: children drain gracefully (zero
    # accepted requests lost), then respawn under the next mesh epoch.
    signal.signal(signal.SIGHUP, lambda *_: sup.request_planned_restart())
    rc = sup.run()
    if rc != 0 and sup.fallback_server is not None:
        # Stay up serving the failure report until SIGTERM/SIGINT (the
        # handlers above set the stop event this waits on).
        sup.wait_for_stop()
        sup.close()
    return rc


if __name__ == "__main__":
    structlog.configure()
    sys.exit(main())
