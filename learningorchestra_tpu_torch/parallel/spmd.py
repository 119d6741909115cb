"""SPMD job dispatch — how one HTTP process drives a multi-process mesh.

The reference scales out by sending Spark jobs from a driver service to a
standalone master that fans work across worker JVMs (reference
docker-compose.yml:123-163, model_builder.py:70-95). Under
``torch.distributed`` the equivalent constraint is SPMD: every rank of the
pod must issue the same collectives (the trainers' all-reduces over the
data axis, parallel/mesh.py) in the same order, or they deadlock. But jobs
arrive dynamically over HTTP on one process only.

Design: **process 0 owns the catalog and the REST surface; every other
process runs a worker loop** (`worker_loop`). Before process 0 runs a mesh
computation for a job, it sends a job spec to every worker over a
persistent TCP channel (newline-delimited JSON — the minimal analogue of
the reference's Spark RPC control plane, ports 7077/41352 + py4j). A
device collective cannot play this role: workers idle between jobs, and
collective rendezvous carries initialization/barrier timeouts (Gloo's 30 s
handshake on CPU), so the control plane must tolerate unbounded idle —
TCP recv does. Workers decode the spec, rebuild identical host inputs
from the *shared dataset store* (the data plane replacing Mongo, which
played exactly this role for Spark executors), and execute the same
sequence of device calls and collectives. Results live replicated or are
all-gathered; process 0 persists them, workers discard.

The channel's address defaults to the process group's coordinator host
(process 0) at ``LO_TPU_JOB_PORT`` (coordinator port + 1 when unset).

Single-process runs skip all of this: every entry point no-ops unless
``torch.distributed`` is initialized with more than one rank. This is the
JAX package's module (``learningorchestra_tpu/parallel/spmd.py``) with
the process group's rank and world size in place of ``jax.process_*``;
each worker's job shipment also carries its kernel launch counts, which
``GET /cluster`` serves per process.
"""

from __future__ import annotations

import contextlib
import json
import socket
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from learningorchestra_tpu_torch import config as _config
from learningorchestra_tpu_torch.utils import failpoints, resources, tracing
from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("spmd")

#: Deterministic fault-injection site: process 0, every worker ready,
#: about to release them with 'go' — the dispatch-side crash window the
#: watchdog + supervisor recovery path must survive (utils/failpoints.py).
FP_DISPATCH_PRE_GO = failpoints.declare("spmd.dispatch.pre_go")
#: The worker-side window: a worker released with 'go', about to run the
#: job's device ops — a death here leaves process 0 alone in the job's
#: first collective (the watchdog's case; ``crash:N`` dies at the N-th).
FP_WORKER_PRE_DEVICE = failpoints.declare("spmd.worker.pre_device")


class PodDegraded(RuntimeError):
    """The pod cannot run mesh jobs until its supervisor restarts it.
    Mapped to HTTP 503 + Retry-After by the serving layer (a restarting
    pod is a transient condition, not an internal error)."""


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return _world() > 1


def local_host_id() -> int:
    """This host's placement identity for shard-map planning — which
    ingest-partition owner's chunks count as host-local when
    the runtime's streamed feed classifies its rows (catalog/ingest.py
    records the map; parallel/runtime.py consumes it).
    ``LO_TPU_SHARD_HOST`` overrides explicitly (tests / asymmetric pods);
    otherwise the process group's rank, which matches partition order
    because both follow pod rank."""
    override = _config.shard_host()
    if override is not None:
        return override
    return _rank()


def serialize_collectives(tree) -> None:
    """Fence between back-to-back fits of a dispatched build on a pod:
    with gloo and CUDA tensors in ``tree``, waits for the current CUDA
    stream; a no-op otherwise.

    Every collective here is issued by the host thread in program order,
    so the order itself needs no fence (the JAX package's CPU rig needed
    one because XLA ran in-flight programs concurrently). What gloo adds
    is a host hop: it copies a CUDA tensor to the host on its own stream
    after the work queued so far, and sums it on its own threads. Without
    the fence a rank enters the next family with this family's kernels
    still queued, so the first all-reduce of the next family waits
    behind them on one rank and not on the other, and on ranks that
    share one card each rank's queue delays the other's. The fence makes
    every rank finish a family before the next one starts, so their
    collectives meet at the same place and each family's ``fit_time``
    covers its own work. NCCL orders its collectives on the device stream
    with the kernels, and CPU tensors have no queue: neither needs it."""
    if not (is_multiprocess() and dist.get_backend() == "gloo"):
        return
    leaves = tree.values() if isinstance(tree, dict) else (tree,)
    for t in leaves:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
            return


def mesh_epoch() -> int:
    """This incarnation's mesh generation. The supervisor
    (learningorchestra_tpu_torch/supervisor.py) bumps
    ``LO_TPU_MESH_EPOCH`` on every pod restart; the job channel rejects
    workers whose epoch differs at handshake, so a stale worker from a
    previous incarnation can never join the new pod's collectives. Read
    dynamically (not cached) so the poison scope below follows the env."""
    return _config.mesh_epoch()


def _job_addr() -> tuple:
    """(host, port) of the job channel — coordinator host, port + 1."""
    coord = _config.coordinator_address("127.0.0.1:8476")
    host, _, port = coord.rpartition(":")
    return host or "127.0.0.1", _config.job_port(int(port) + 1)


def _close_quietly(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass


class _Conn:
    """One worker connection with line-buffered reads."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def recv_line(self, timeout: Optional[float]):
        """(status, line): ("ok", str) | ("timeout", None) | ("eof", None).

        Timeout and EOF are distinct on purpose: a slow worker (still
        prepping a big job) must not be treated as a dead one."""
        self.sock.settimeout(timeout)
        try:
            while b"\n" not in self.buf:
                data = self.sock.recv(1 << 16)
                if not data:
                    return "eof", None
                self.buf += data
        except (TimeoutError, socket.timeout):
            return "timeout", None
        except OSError:
            return "eof", None
        finally:
            try:
                self.sock.settimeout(None)
            except OSError:
                pass
        line, self.buf = self.buf.split(b"\n", 1)
        return "ok", line.decode("utf-8")


class _JobChannel:
    """Process-0 end: accepts one connection per worker, fans job specs
    out as JSON lines and collects per-worker ready/fail acks. Worker
    connections are accepted in the background so the server can start
    before (or after) its workers. Dead connections are pruned on IO
    errors — a worker process cannot rejoin a running pod (its rank in
    the process group died with it), so the channel's job is to
    fail *cleanly*, not to resync.

    Every connection starts with an epoch handshake: the worker sends
    ``{"op": "hello", "epoch": N}`` and is admitted only when N matches
    this process's ``mesh_epoch()``. A worker from a previous pod
    incarnation (stale epoch — e.g. one that outlived a supervisor
    restart) is rejected and closed instead of occupying a worker slot
    whose collectives it could never join correctly."""

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._lock = threading.Lock()
        #: Serializes all socket writes: a shutdown broadcast racing an
        #: in-flight dispatch must not interleave bytes within a line.
        self._wlock = threading.Lock()
        self._round = 0
        self._conns: List[_Conn] = []
        _, port = _job_addr()
        self._srv = socket.create_server(("", port))
        # thread-lifecycle: owner=_JobChannel; exits when close() closes
        # the server socket (accept raises OSError → return); daemon for
        # process teardown.
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="lo-spmd-accept")
        t.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # Handshake off-thread: a half-open connection that never
            # sends its hello must not block later workers from joining.
            # thread-lifecycle: owner=_JobChannel; exits after one
            # recv_line (30s timeout) — rejects or registers the worker
            # and returns; daemon.
            threading.Thread(target=self._handshake, args=(sock,),
                             daemon=True, name="lo-spmd-handshake").start()

    def _handshake(self, sock: socket.socket) -> None:
        conn = _Conn(sock)
        status, line = conn.recv_line(timeout=30.0)
        if status != "ok":
            _close_quietly(sock)
            return
        try:
            hello = json.loads(line)
        except json.JSONDecodeError:
            hello = {}
        epoch = mesh_epoch()
        if hello.get("op") != "hello" or hello.get("epoch") != epoch:
            log.warning(
                "rejecting job-channel connection (epoch %r != pod epoch "
                "%d): stale worker from a previous pod incarnation",
                hello.get("epoch"), epoch)
            try:
                sock.sendall((json.dumps(
                    {"op": "reject", "epoch": epoch,
                     "reason": f"stale mesh epoch {hello.get('epoch')!r}; "
                               f"pod is at epoch {epoch}"}) + "\n")
                    .encode("utf-8"))
            except OSError:
                pass
            _close_quietly(sock)
            return
        try:
            sock.sendall((json.dumps({"op": "welcome", "epoch": epoch})
                          + "\n").encode("utf-8"))
        except OSError:
            _close_quietly(sock)
            return
        # The hello's lite resource snapshot seeds /cluster's pod view
        # before this worker has run a single job.
        resources.note_remote(hello.get("process"),
                              hello.get("resources"))
        with self._lock:
            self._conns.append(conn)

    def close(self) -> None:
        """Tear down the listener and every worker connection (tests and
        controlled shutdown)."""
        try:
            self._srv.close()
        except OSError:
            pass
        for conn in self._live():
            self._drop(conn)

    def _live(self) -> List[_Conn]:
        with self._lock:
            return list(self._conns)

    def _drop(self, conn: _Conn) -> None:
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _sendall(self, conns: List[_Conn], msg: Dict[str, Any]) -> None:
        data = (json.dumps(msg) + "\n").encode("utf-8")
        with self._wlock:
            for conn in conns:
                try:
                    conn.sock.sendall(data)
                except OSError:
                    self._drop(conn)

    def _read_ack(self, conn: _Conn, rnd: int, deadline: float):
        """This round's ack from one worker, skipping stale acks from
        aborted earlier rounds. Returns (status, ack_dict|None)."""
        while True:
            status, line = conn.recv_line(max(1.0, deadline - time.time()))
            if status != "ok":
                return status, None
            try:
                ack = json.loads(line)
            except json.JSONDecodeError:
                continue
            if ack.get("op") == "spans":
                # A worker's span shipment from an earlier job that the
                # post-job drain timed out on: merge it late rather than
                # dropping it — and never mistake it for this round's
                # ack (it carries the OLD round id, but defense in
                # depth beats a coincidence). The piggybacked resource
                # snapshot still freshens the /cluster pod view; the
                # job it belonged to is long gone, so its watermarks
                # are NOT merged into whatever job is dispatching now.
                tracing.ingest(ack.get("spans") or [])
                res = ack.get("resources") or {}
                resources.note_remote(res.get("process"),
                                      res.get("snapshot"))
                continue
            if ack.get("round") == rnd:
                return "ok", ack
            # stale ack from an earlier aborted round — discard

    def dispatch(self, spec: Dict[str, Any], connect_timeout_s: float = 60.0,
                 prep_timeout_s: float = 600.0) -> None:
        """Two-phase fan-out: send the (round-stamped) spec, wait for every
        worker's ``ready`` ack (host-side prep done — datasets loaded,
        shapes agreed), then release them with ``go``. Any failed/missing
        ack aborts the round on every worker and raises, so process 0
        never enters a collective some worker will not join. A *timed-out*
        worker is not dropped — it may just be slow, and its stale ack is
        discarded by round id on the next dispatch; only EOF (the process
        died — it cannot rejoin a running pod) removes a connection. (A
        failure *after* go — mid-collective — still wedges; that is
        inherent to collectives without timeouts and surfaces at pod
        supervision.)"""
        deadline = time.time() + connect_timeout_s
        while len(self._live()) < self.n_workers:
            if time.time() > deadline:
                raise TimeoutError(
                    f"only {len(self._live())}/{self.n_workers} workers "
                    "connected to the job channel")
            time.sleep(0.05)
        with self._lock:
            self._round += 1
            rnd = self._round
        conns = self._live()[:self.n_workers]
        self._sendall(conns, dict(spec, round=rnd))
        deadline = time.time() + prep_timeout_s
        failures = []
        for conn in conns:
            status, ack = self._read_ack(conn, rnd, deadline)
            if status == "eof":
                self._drop(conn)
                failures.append("worker died before ack")
                # A dead worker can never rejoin: poison the pod NOW so
                # later dispatches refuse immediately instead of each
                # burning the full connect timeout against a permanently
                # short-handed pod (same rule as mid-job deaths).
                _set_pod_error("worker died before ack")
            elif status == "timeout":
                failures.append(
                    f"worker ack timed out after {prep_timeout_s:.0f}s")
            elif ack.get("status") != "ready":
                failures.append(ack.get("error", "worker prep failed"))
        if failures:
            self._sendall(self._live(), {"op": "abort", "round": rnd})
            raise RuntimeError(
                f"SPMD dispatch aborted ({len(failures)} worker(s)): "
                + "; ".join(failures[:3]))
        failpoints.fire(FP_DISPATCH_PRE_GO)
        self._sendall(conns, {"op": "go", "round": rnd})

    def broadcast(self, msg: Dict[str, Any]) -> None:
        """Fire-and-forget control message (shutdown) — no ack round."""
        self._sendall(self._live(), msg)

    def drain_spans(self, rnd: int, timeout_s: float = 5.0) -> int:
        """Collect each worker's span shipment for round ``rnd`` (sent
        unprompted after its device ops finish) and merge it into this
        process's trace buffer. Runs inside the dispatch guard right
        after the coordinator's own device ops complete — the workers
        ran the same collective program, so their shipments are
        imminent; the timeout bounds a wedged/slow worker (its spans
        then merge at the next round's ack read instead). Each shipment
        also carries the worker's resource watermarks for the job and a
        lite process snapshot: the watermarks merge into the CURRENT
        job's profile (this runs inside the job's body on the
        coordinator, so ``peak_hbm_bytes`` becomes a pod-wide max) and
        the snapshot freshens ``GET /cluster``. Returns how many
        workers' shipments merged."""
        merged = 0
        for conn in self._live():
            deadline = time.time() + timeout_s
            while True:
                status, line = conn.recv_line(
                    max(0.1, deadline - time.time()))
                if status != "ok":
                    break                      # timeout/EOF: catch up later
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if msg.get("op") == "spans":
                    tracing.ingest(msg.get("spans") or [])
                    res = msg.get("resources") or {}
                    resources.note_remote(res.get("process"),
                                          res.get("snapshot"))
                    from learningorchestra_tpu_torch import jobs

                    wm = res.get("watermarks") or {}
                    if isinstance(wm, dict) and (
                            wm.get("peak_hbm_bytes")
                            or wm.get("compile_s")):
                        jobs.record_job_watermarks(
                            peak_hbm_bytes=int(
                                wm.get("peak_hbm_bytes") or 0) or None,
                            compile_s=float(
                                wm.get("compile_s") or 0.0) or None)
                    if msg.get("round") == rnd:
                        merged += 1
                        break
                # stale ack from an aborted round — discard, keep reading
                if time.time() >= deadline:
                    break
        return merged

    def monitor_workers(self, stop: threading.Event, on_death) -> None:
        """Poll worker sockets for EOF (MSG_PEEK — never consumes ack
        bytes) while a dispatched job computes. A worker dying after 'go'
        used to be a silent pod wedge (the surviving processes block in a
        collective forever); the monitor converts it into a detected
        failure: ``on_death(reason)`` fires once, the caller fails the
        job's output datasets (pollable) and poisons the pod for fast
        failure of subsequent jobs."""
        while not stop.is_set():
            reason = self.dead_worker()
            if reason is not None:
                on_death(reason)
                return
            stop.wait(0.2)

    def dead_worker(self) -> Optional[str]:
        """One non-blocking pass over the worker sockets: why a worker is
        gone (EOF or a lost connection), or None while all are up."""
        for conn in self._live():
            try:
                data = conn.sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT)
                if data == b"":
                    return "worker process died mid-job"
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                return "worker connection lost mid-job"
        return None


_channel: Optional[_JobChannel] = None
_channel_lock = threading.Lock()
_dispatch_lock = threading.Lock()
#: ``(mesh_epoch, reason)`` recorded when a worker died mid-job. A dead
#: worker can never rejoin a *running* pod (its rank in the process group
#: died with it), so once set every subsequent dispatch in the same
#: incarnation fails fast with this reason instead of timing out against
#: a permanently short-handed pod. The poison is EPOCH-SCOPED: a
#: supervisor restart bumps the mesh epoch, and poison recorded under an
#: earlier epoch no longer degrades the pod — the restarted incarnation
#: serves again without any manual clearing.
_pod_error: Optional[tuple] = None
#: Thread-local mesh-job scope: set while this thread is allowed to enter
#: mesh collectives on a multi-process pod (process 0 inside dispatch_guard,
#: workers while executing a dispatched job's device ops).
_scope = threading.local()


class mesh_scope:
    """Marks the current thread as inside a dispatched SPMD job. The mesh
    runtime's device-entry points (shard_rows/replicate) refuse to run on a
    multi-process pod outside this scope — the *structural* guard that
    makes "forgot to dispatch" a clean client error instead of a wedged
    pod (every mesh op funnels host data through those entry points)."""

    def __enter__(self):
        _scope.depth = getattr(_scope, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _scope.depth -= 1
        return False


def in_mesh_scope() -> bool:
    return getattr(_scope, "depth", 0) > 0


def check_mesh_entry(what: str = "this mesh operation") -> None:
    """Called by DeviceRuntime.shard_rows/replicate: on a multi-process pod,
    device entry requires an active dispatch scope, else the collectives
    the op runs would execute on this process alone and deadlock the pod.
    Raises the clean 406-style error instead."""
    if is_multiprocess() and not in_mesh_scope():
        raise ValueError(
            f"{what} would enter mesh collectives on a multi-process pod "
            "without an SPMD dispatch; run it through a dispatched job "
            "(spmd.dispatch under dispatch_guard) or on a single-process "
            "deployment")


def _get_channel() -> _JobChannel:
    global _channel
    with _channel_lock:
        if _channel is None:
            _channel = _JobChannel(_world() - 1)
        return _channel


def ensure_channel() -> None:
    """Start the job channel's listener (process 0, at server startup).
    Without this, workers connecting at boot would exhaust their connect
    deadline while the channel waits for the first job. No-op elsewhere."""
    if is_multiprocess() and _rank() == 0:
        _get_channel()


def _set_pod_error(reason: str) -> None:
    global _pod_error
    _pod_error = (mesh_epoch(), reason)


def poison_pod(reason: str) -> None:
    """Externally-detected degradation (the job watchdog finding a hung
    device program): poison this incarnation exactly like a mid-job
    worker death — later dispatches fail fast, ``/cluster`` reports the
    reason, and the supervisor's health poll restarts the pod under the
    next mesh epoch (which is what actually tears the hung program
    down). Epoch-scoped like every poison: the restarted incarnation
    reads healthy with no manual clearing."""
    log.error("pod poisoned: %s", reason)
    _set_pod_error(reason)


def pod_error() -> Optional[str]:
    """The reason this pod is degraded, or None while healthy. Poison
    recorded under a previous mesh epoch is stale — the supervisor
    restarted the pod since — and reads as healthy."""
    if _pod_error is None:
        return None
    epoch, reason = _pod_error
    return reason if epoch == mesh_epoch() else None


def require_pod_health() -> None:
    """Raise :class:`PodDegraded` when this pod cannot run mesh jobs.
    The serving layer calls this at the top of every dispatching route so
    a degraded pod answers 503 + Retry-After (the supervisor is about to
    restart it) instead of accepting jobs doomed to fail."""
    reason = pod_error()
    if reason is not None:
        raise PodDegraded(
            f"pod is degraded ({reason}); a dead worker cannot rejoin a "
            "running pod — the supervisor will restart the pod under a "
            "new mesh epoch (supervisor.py)")


def dispatch(spec: Dict[str, Any]) -> None:
    """Process-0 side: announce the next mesh job to every worker and
    rendezvous on their readiness. No-op single-process. Caller must then
    execute exactly the device-op sequence `run_job` executes for this
    spec. The spec is stamped with the pod's mesh epoch — workers nack
    specs from a different incarnation (defense in depth behind the
    connection handshake) — and with the coordinator's ambient trace
    context, so worker-process spans join the SAME trace and merge back
    on the coordinator (``GET /trace/{id}`` covers the whole pod)."""
    if not is_multiprocess():
        return
    require_pod_health()
    stamped = dict(spec, epoch=mesh_epoch())
    wire = tracing.to_wire()
    if wire is not None:
        stamped["trace"] = wire
    _get_channel().dispatch(stamped)


@contextlib.contextmanager
def dispatch_job(store, inputs, make_spec, outputs=()):
    """Process-0 preamble shared by every dispatched surface (build,
    predict, embed, histogram): require a persisted shared store, commit
    the input datasets workers rebuild from, serialize the mesh job, and
    dispatch the spec — then run the caller's device ops inside the mesh
    scope. ``make_spec`` may be the spec dict or a thunk evaluated *after*
    the saves (specs that pin journaled state need the post-save view).
    Single-process: plain passthrough (no guard, jobs stay overlapped).

    ``outputs`` names the job's output datasets. While the device ops run,
    a watchdog thread peeks every worker socket: a worker dying after 'go'
    wedges the surviving processes in a collective (inherent to
    collectives without timeouts), but the watchdog converts it from a
    SILENT wedge into a recorded failure — each output dataset flips to
    ``finished: true`` with a pollable ``error``, and the pod is poisoned
    so every later dispatch fails fast instead of timing out against a
    permanently short-handed pod."""
    if not is_multiprocess():
        yield
        return
    if not store.cfg.persist:
        op = (make_spec() if callable(make_spec) else make_spec).get("op")
        raise RuntimeError(
            f"multi-process {op} jobs require a persisted shared store "
            "(LO_TPU_PERSIST=1 on a shared store_root)")
    require_pod_health()
    for name in inputs:
        store.save(name)
    from learningorchestra_tpu_torch import jobs

    with dispatch_guard():
        dispatch(make_spec() if callable(make_spec) else make_spec)
        # Progress mark: every worker acked ready and 'go' went out —
        # the job watchdog's liveness clock restarts here, so its
        # deadline bounds the one phase nothing else bounds: the 'go'
        # phase of the dispatched device program (connect and prep have
        # their own timeouts in _JobChannel.dispatch).
        jobs.heartbeat()
        stop = threading.Event()

        def on_death(reason: str) -> None:
            _set_pod_error(reason)
            log.error("pod degraded: %s — failing job outputs %s",
                      reason, list(outputs))
            for name in outputs:
                try:
                    store.fail(name, f"pod failure: {reason}")
                except Exception:  # noqa: BLE001 — best-effort flagging
                    log.exception("could not fail output %s", name)

        # thread-lifecycle: owner=dispatch_job; exits when the finally
        # below sets the stop event and joins it (2s timeout); on_death
        # failures are logged, never raised off-thread.
        monitor = threading.Thread(
            target=_get_channel().monitor_workers, args=(stop, on_death),
            daemon=True, name="lo-spmd-watchdog")
        monitor.start()
        try:
            yield
        finally:
            stop.set()
            monitor.join(timeout=2.0)
            # gloo raises at once when a peer's socket closes, where the
            # JAX package's collectives hang: the device ops can return
            # (their families failed on the collective's error) before
            # the monitor's next poll. One last pass catches the death
            # that failed them, so it reads as a pod failure.
            if pod_error() is None:
                reason = _get_channel().dead_worker()
                if reason is not None:
                    on_death(reason)
        # Merge the workers' spans + resource watermarks for this job
        # (they ship them unprompted once their device ops finish —
        # always, even untraced: the job profile's pod-wide
        # peak_hbm_bytes must not depend on the sampling decision).
        # Runs only when the device ops completed (an aborted round's
        # workers never ran, so waiting on their shipment would just
        # burn the timeout) and never on a degraded pod.
        if pod_error() is None:
            channel = _get_channel()
            with channel._lock:
                rnd = channel._round
            channel.drain_spans(rnd)
            # The workers' span/watermark shipments arriving is itself
            # progress: the pod-wide program completed end to end.
            jobs.heartbeat()
        # The compute may have completed on this process even though a
        # worker died (death after its last collective): the outputs were
        # already flagged failed, so surface the degradation to the caller
        # rather than silently persisting half-a-pod's results.
        require_pod_health()


class dispatch_guard:
    """Serializes mesh jobs under multi-process operation and opens the
    mesh scope for the calling thread.

    Collective programs from concurrently dispatched jobs would interleave
    differently on each process and deadlock; the guard makes dispatch +
    compute atomic. Single-process mode is a no-op (concurrent fits stay
    overlapped, the FAIR-scheduler behavior)."""

    def __init__(self):
        self._scope = mesh_scope()

    def __enter__(self):
        if is_multiprocess():
            _dispatch_lock.acquire()
            self._scope.__enter__()
        return self

    def __exit__(self, *exc):
        if is_multiprocess():
            self._scope.__exit__(*exc)
            _dispatch_lock.release()
        return False


# -- worker side -------------------------------------------------------------

def jsonable_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """Preprocessing state → JSON-safe (numpy scalars/arrays → Python).
    Python's json round-trips floats exactly (repr), so a worker applying
    the deserialized state reproduces process 0's design matrix
    bit-for-bit."""
    import numpy as np

    def conv(v):
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, np.ndarray):
            return [conv(x) for x in v.tolist()]
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return v

    return conv(state)


def _require_snapshot(seen: int, pinned: Optional[int], what: str) -> None:
    """Shared staleness guard for preppers: the dispatched spec pins a
    snapshot (row/chunk counts); a worker seeing *less* than the pin means
    the shared store is out of sync and prep must nack (fail before 'go')
    rather than let collectives diverge."""
    if pinned is not None and seen < pinned:
        raise RuntimeError(
            f"worker sees fewer {what} ({seen}) than the dispatched "
            f"snapshot ({pinned}) — shared store out of sync")


def prep_build_job(store, runtime, spec: Dict[str, Any]):
    """Host-side prep for a build job; returns the device-op callable.

    Mirrors ``ModelBuilder.build``'s per-classifier compute exactly (fit →
    predict_proba with the same shapes, same order). Host-only work
    (persistence, prediction datasets, metrics) is process-0 business and
    is skipped here. The spec pins process 0's snapshot: its row counts,
    fitted preprocessing state, and feature fields — a concurrent ingest
    commit between its save and this load may have appended rows or
    shifted stats, and any divergence would either wedge the collectives
    (shape mismatch) or silently assemble inconsistent global arrays.
    Rows only ever append, so truncating to the pinned counts reproduces
    the snapshot prefix; the pinned state makes the values identical.
    """
    from learningorchestra_tpu_torch.models.registry import get_trainer
    from learningorchestra_tpu_torch.ops import preprocess

    train_ds = store.load(spec["train"])
    test_ds = store.load(spec["test"])
    steps = spec.get("steps") or ()
    label = spec["label"]
    hparams = spec.get("hparams") or {}
    state = spec.get("state")
    ff = spec.get("feature_fields")
    n_train, n_test = spec.get("n_train"), spec.get("n_test")
    if spec.get("streamed"):
        # Mirror process 0's shard-local path: the same pinned state +
        # feature fields + row counts make every process's lazy design
        # identical, and each worker's device shards materialize from its
        # OWN row ranges only — the whole point of streaming (host RAM
        # divides by process count).
        _require_snapshot(train_ds.num_rows, n_train, "train rows")
        _require_snapshot(test_ds.num_rows, n_test, "test rows")
        X_train, y_train, ff, state = preprocess.design_matrix_streamed(
            train_ds, label, steps, state=state, feature_fields=ff,
            n_rows=n_train)
        X_test, y_test, _, _ = preprocess.design_matrix_streamed(
            test_ds, label, steps, state=state, feature_fields=ff,
            n_rows=n_test)
    else:
        X_train, y_train, ff, state = preprocess.design_matrix(
            train_ds, label, steps, state=state, feature_fields=ff)
        X_test, y_test, _, _ = preprocess.design_matrix(
            test_ds, label, steps, state=state, feature_fields=ff)
        if n_train is not None:
            _require_snapshot(len(X_train), n_train, "train rows")
            _require_snapshot(len(X_test), n_test, "test rows")
            X_train, y_train = X_train[:n_train], y_train[:n_train]
            X_test = X_test[:n_test]
            y_test = y_test[:n_test] if y_test is not None else None
    num_classes = int(max(int(y_train.max()) + 1,
                          2 if y_test is None else int(y_test.max()) + 1))

    def device_ops() -> None:
        # Batched dispatch round, mirroring ModelBuilder._build_dispatched
        # EXACTLY: every family's fit runs first, one after another, then
        # the probability passes run in the same order. A family that fails
        # here fails identically on process 0 (deterministic inputs), so
        # both sides skip the same device ops and collective-program
        # order stays aligned.
        models = []
        for c in spec["classifiers"]:
            try:
                trainer = get_trainer(c)
                model = trainer(runtime, X_train, y_train, num_classes,
                                **hparams.get(c, {}))
                # Mirrors process 0's phase-1 fence.
                serialize_collectives(model.params)
                models.append(model)
            except Exception:  # noqa: BLE001 — mirror per-model boundary
                log.exception("worker fit %s failed", c)
                models.append(None)
        for c, model in zip(spec["classifiers"], models):
            if model is None:
                continue
            try:
                model.predict_proba(runtime, X_test)
            except Exception:  # noqa: BLE001 — mirror per-model boundary
                log.exception("worker predict %s failed", c)

    return device_ops


def prep_predict_job(store, runtime, spec: Dict[str, Any]):
    """Host-side prep mirroring ``ModelBuilder.predict``; returns the
    device-op callable."""
    from learningorchestra_tpu_torch.models.persistence import ModelRegistry
    from learningorchestra_tpu_torch.ops import preprocess

    registry = ModelRegistry(store.cfg)
    man, model = registry.load(spec["model"])
    pp = man["preprocess"]
    ds = store.load(spec["dataset"])
    n = spec.get("n_rows")
    if spec.get("streamed"):
        _require_snapshot(ds.num_rows, n, "rows")
        X, _, _, _ = preprocess.design_matrix_streamed(
            ds, pp["label"], pp["steps"], state=pp["state"],
            feature_fields=pp["feature_fields"], n_rows=n, need_y=False)
    else:
        X, _, _, _ = preprocess.design_matrix(
            ds, pp["label"], pp["steps"], state=pp["state"],
            feature_fields=pp["feature_fields"])
        if n is not None:
            _require_snapshot(len(X), n, "rows")
            X = X[:n]
    return lambda: model.predict_proba(runtime, X)


def prep_embed_job(store, runtime, spec: Dict[str, Any]):
    """Host-side prep mirroring ``create_embedding_image``'s compute: build
    the identical design matrix from the shared store (pinned rows +
    preprocessing state) and return the device-op callable running the
    same tsne/pca embed. PNG rendering is process-0 business."""
    from learningorchestra_tpu_torch.ops import preprocess
    from learningorchestra_tpu_torch.viz.pca import pca_embed
    from learningorchestra_tpu_torch.viz.tsne import tsne_embed

    ds = store.load(spec["parent"])
    X, _, _, _ = preprocess.design_matrix(
        ds, spec["label"] or "__none__", (), state=spec.get("state"),
        feature_fields=spec.get("feature_fields"))
    n = spec["n_rows"]
    _require_snapshot(len(X), n, "rows")
    X = X[:n]
    kwargs = spec.get("embed_kwargs") or {}
    method = spec["method"]
    if method == "pca":
        return lambda: pca_embed(runtime, X)
    if method == "tsne":
        return lambda: tsne_embed(runtime, X, **kwargs)
    raise ValueError(f"unknown embed method: {method!r}")


def prep_histogram_job(store, runtime, spec: Dict[str, Any]):
    """Host-side prep mirroring ``create_histogram``'s streamed device
    counts. The spec pins the parent's journaled chunk count: chunk files
    are immutable and journal order is append-only, so truncating both
    sides to the pinned count makes every per-chunk device bincount (and
    the host/device path decision, which depends only on chunk data)
    identical across processes. Result writing is process-0 business.

    Unlike build/predict/embed (pure compute after 'go'), the streamed
    device ops re-read chunk files between collectives, so prep walks
    every chunk once first: a missing/corrupt chunk file nacks here —
    before 'go' — instead of wedging the pod mid-all-reduce. The re-read at
    device time is cheap (immutable files, warm page cache)."""
    from learningorchestra_tpu_torch.ops.histogram import histogram_totals

    ds = store.load(spec["parent"])
    n_chunks = spec["n_chunks"]
    fields = spec["fields"]
    _require_snapshot(len(ds.journal_files()), n_chunks, "chunks")
    for _ in ds.iter_chunks(list(fields), max_chunks=n_chunks):
        pass  # validation pass: every read that 'go' will need, fallible now
    return lambda: histogram_totals(ds, fields, max_chunks=n_chunks,
                                    runtime=runtime)


_PREPPERS = {"build": prep_build_job, "predict": prep_predict_job,
             "embed": prep_embed_job, "histogram": prep_histogram_job}


def _connect_to_controller(timeout_s: float = 120.0) -> socket.socket:
    host, port = _job_addr()
    deadline = time.time() + timeout_s
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
            sock.settimeout(None)  # jobs may be hours apart
            return sock
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)


def worker_loop(store, runtime) -> str:
    """Non-zero processes: block on the next job spec, prep host-side
    inputs, ack readiness, await ``go``, execute the device ops; repeat
    until shutdown. The store must point at the same (shared) store_root
    process 0 persists into — the data plane that replaces the reference's
    Mongo-as-shared-storage for Spark executors.

    Returns the exit reason — ``"shutdown"`` (controlled, exit 0) vs
    ``"controller-lost"`` / ``"stale-epoch"`` (this incarnation cannot
    continue; the caller should exit nonzero so the host's supervisor
    restarts the process into the pod's next incarnation)."""
    epoch = mesh_epoch()
    # Spans this process records carry its pod rank, so the merged
    # coordinator view can attribute per-process time (the 2-process
    # propagation test pins exactly this).
    tracing.set_process(_rank())
    log.info("worker %d/%d entering SPMD loop (epoch %d)",
             _rank(), _world(), epoch)
    sock = _connect_to_controller()
    conn = _Conn(sock)

    def reply(msg: Dict[str, Any]) -> bool:
        """Send an ack; False when the controller is gone (socket closed
        after an abort, controller restart) — exit cleanly, not by
        traceback."""
        try:
            sock.sendall((json.dumps(msg) + "\n").encode("utf-8"))
            return True
        except OSError:
            return False

    # Epoch handshake: identify this incarnation before taking a worker
    # slot; the controller rejects a stale epoch (supervisor restarted the
    # pod since this process started). The hello carries a lite resource
    # snapshot so /cluster shows this worker's host/device state from
    # the moment it joins, not only after its first job.
    if not reply({"op": "hello", "epoch": epoch,
                  "process": _rank(),
                  "resources": _lite_snapshot()}):
        log.info("controller lost during handshake; exiting")
        return "controller-lost"
    status, line = conn.recv_line(60.0)
    if status != "ok":
        log.info("controller lost during handshake; exiting")
        return "controller-lost"
    verdict = json.loads(line)
    if verdict.get("op") != "welcome":
        log.warning("controller rejected this worker: %s",
                    verdict.get("reason", verdict))
        return "stale-epoch"

    while True:
        status, line = conn.recv_line(None)
        if status != "ok":
            log.info("controller closed the job channel; exiting")
            return "controller-lost"
        spec = json.loads(line)
        op = spec.get("op")
        rnd = spec.get("round")
        if op == "shutdown":
            log.info("worker %d shutting down", _rank())
            return "shutdown"
        if op in ("go", "abort"):
            continue  # stray control line from an aborted round
        prepper = _PREPPERS.get(op)
        device_ops = None
        # The coordinator's trace context rides the spec: this worker's
        # prep + device spans join the SAME trace and ship back after
        # the job, so GET /trace/{id} on the coordinator covers the pod.
        wctx = tracing.from_wire(spec.get("trace"))
        if prepper is None:
            ok = reply({"status": "fail", "round": rnd,
                        "error": f"unknown job op: {op!r}"})
        elif spec.get("epoch") not in (None, epoch):
            # Defense in depth behind the connection handshake: never run
            # a spec stamped by a different pod incarnation.
            ok = reply({"status": "fail", "round": rnd,
                        "error": f"stale mesh epoch: spec epoch "
                                 f"{spec.get('epoch')} != worker {epoch}"})
        else:
            try:
                with tracing.attach(wctx), tracing.span("worker.prep",
                                                        op=op):
                    device_ops = prepper(store, runtime, spec)
                ok = reply({"status": "ready", "round": rnd})
            except Exception as exc:  # noqa: BLE001 — nack, keep loop alive
                log.exception("worker prep for %r failed", op)
                ok = reply({"status": "fail", "round": rnd,
                            "error": f"{type(exc).__name__}: {exc}"})
        if not ok:
            log.info("controller lost while acking; exiting")
            return "controller-lost"
        # Await the controller's verdict for this round (blocking: the
        # controller may legitimately spend minutes collecting other
        # workers' acks; its death surfaces as EOF).
        status, line = conn.recv_line(None)
        if status != "ok":
            log.info("controller lost mid-round; exiting")
            return "controller-lost"
        verdict = json.loads(line).get("op")
        if verdict == "go" and device_ops is not None:
            failpoints.fire(FP_WORKER_PRE_DEVICE)
            c0 = resources.compile_seconds()
            try:
                with tracing.attach(wctx), \
                        tracing.span("dispatch.device", op=op), \
                        mesh_scope():
                    device_ops()
            except Exception:  # noqa: BLE001 — keep the loop alive
                log.exception("worker device ops for %r failed", op)
            # Ship this job's spans + this process's resource watermarks
            # to the coordinator (it drains them right after its own
            # device ops; a missed drain merges at the next round's ack
            # read). Always sent — the coordinator's job profile needs
            # the pod-wide peak even for unsampled traces; spans ride
            # along only when the trace recorded any. Failure to send =
            # controller gone, caught at the next recv.
            reply({"op": "spans", "round": rnd,
                   "spans": (tracing.pop_spans(wctx.trace_id)
                             if wctx is not None and wctx.sampled else []),
                   "resources": {
                       "process": _rank(),
                       "snapshot": _lite_snapshot(),
                       "watermarks": {
                           "peak_hbm_bytes": resources.hbm_bytes_in_use(),
                           "compile_s": round(
                               resources.compile_seconds() - c0, 6)}}})
        elif verdict == "shutdown":
            return "shutdown"


def kernel_launches() -> Dict[str, int]:
    """This process's kernel launches by wrapper name since its start (or
    the last reset): the tree and t-SNE kernels' counters together."""
    from learningorchestra_tpu_torch.ops import tree_kernels, tsne_kernels

    return {**tree_kernels.launch_counts(), **tsne_kernels.launch_counts()}


def _lite_snapshot() -> Dict[str, Any]:
    """The lite resource snapshot a worker ships, with its launches and
    its collectives."""
    from learningorchestra_tpu_torch.parallel.mesh import collective_counts

    return dict(resources.process_snapshot(lite=True),
                launches=kernel_launches(), collectives=collective_counts())


def shutdown_workers() -> None:
    """Process 0: release every worker from its loop (server shutdown)."""
    if is_multiprocess():
        _get_channel().broadcast({"op": "shutdown"})
