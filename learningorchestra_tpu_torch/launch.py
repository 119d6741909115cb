"""``python -m learningorchestra_tpu_torch.launch`` — start the pod's
ranks of one host, one a card.

    python -m learningorchestra_tpu_torch.launch [--ranks N] [--host-id H]
        [--num-hosts K] [--log-dir DIR] [-- <rank command>]

The JAX package starts one process a host and ``jax.distributed`` joins
the host's chips (deploy/run_pod.sh). A rank of this package owns one
device (``parallel.distributed.initialize`` makes device ``process_id``
modulo the local device count current), so a host with N cards runs N
ranks. The launcher starts them — N defaults to
``torch.cuda.device_count()`` — with rank i's ``LO_TPU_PROCESS_ID =
H·N + i`` and ``LO_TPU_NUM_PROCESSES = K·N``, which is local card i;
the rest of its environment passes through (the coordinator, the job
port, ``LO_TPU_MESH_EPOCH`` and ``LO_TPU_MESH_SHAPE``). The rank command
defaults to ``python -m learningorchestra_tpu_torch.serving``; with
``--log-dir`` each rank writes its output to
``<DIR>/rank<id>_epoch<epoch>.log``.

It runs under the host's supervisor (supervisor.py) as its one pod
command, and keeps the supervisor's semantics:

- SIGTERM, SIGINT and SIGHUP are forwarded to every rank, and the
  launcher itself never escalates: a planned restart's drain lasts as
  long as the supervisor allows, and when the supervisor kills the
  launcher, the kernel kills its ranks (each is started with the parent
  death signal SIGKILL, and in a session of its own, so a terminal's
  signal reaches a rank once, through the launcher);
- a rank's exit kills no other rank: rank 0 stays up to record a dead
  worker as a ``pod failure:`` and the supervisor decides the restart;
- it waits for every rank and exits with the first non-zero code (a
  signal's 128 + its number), 0 when every rank exited cleanly;
- each rank's start and exit is a structured log line
  (utils/structlog.py, logger ``lo_tpu.launch``) with the fields
  ``event`` (``rank_start``/``rank_exit``), ``rank``, ``pid``, ``epoch``,
  ``t`` and, on exit, ``code``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from learningorchestra_tpu_torch.config import mesh_epoch
from learningorchestra_tpu_torch.utils import structlog

log = structlog.get_logger("launch")

#: The rank command when none is given.
RANK_COMMAND = (sys.executable, "-m", "learningorchestra_tpu_torch.serving")
#: Signals forwarded to every rank.
FORWARDED = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)
_PR_SET_PDEATHSIG = 1


def _rank_preexec():
    """The function a rank's child runs before exec: SIGKILL when the
    launcher dies, and the forwarded signals unblocked (``main`` blocks
    them while it starts the ranks). libc is loaded here, in the
    launcher."""
    libc = ctypes.CDLL(None, use_errno=True)

    def preexec() -> None:
        if libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
            raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
        signal.pthread_sigmask(signal.SIG_UNBLOCK, FORWARDED)

    return preexec


def exit_code(returncode: int) -> int:
    """A rank's return code as a process exit code: a signal's 128 + its
    number."""
    return 128 - returncode if returncode < 0 else returncode


def rank_env(base: Dict[str, str], local: int, ranks: int, host_id: int,
             num_hosts: int) -> Dict[str, str]:
    """Local rank ``local``'s environment: ``base`` with its global
    process id and the pod's process count."""
    env = dict(base)
    env["LO_TPU_PROCESS_ID"] = str(host_id * ranks + local)
    env["LO_TPU_NUM_PROCESSES"] = str(num_hosts * ranks)
    return env


class Launcher:
    """The ranks of one host: ``start`` them, ``forward`` signals to
    them, ``wait`` for all of them."""

    #: Rank poll cadence, seconds.
    POLL_S = 0.05

    def __init__(self, command: Sequence[str], ranks: int, *,
                 host_id: int = 0, num_hosts: int = 1,
                 env: Optional[Dict[str, str]] = None,
                 log_dir: Optional[str] = None):
        if ranks < 1 or num_hosts < 1 or not 0 <= host_id < num_hosts:
            raise ValueError(
                f"need ranks >= 1 and 0 <= host_id < num_hosts; got ranks "
                f"{ranks}, host_id {host_id}, num_hosts {num_hosts}")
        if not command:
            raise ValueError("the launcher needs a rank command")
        self.command = list(command)
        self.ranks, self.host_id, self.num_hosts = ranks, host_id, num_hosts
        self.env = dict(os.environ if env is None else env)
        self.log_dir = log_dir
        self.epoch = mesh_epoch()
        self.procs: List[subprocess.Popen] = []

    def _global(self, local: int) -> int:
        return self.host_id * self.ranks + local

    def start(self) -> None:
        preexec = _rank_preexec()
        for i in range(self.ranks):
            env = rank_env(self.env, i, self.ranks, self.host_id,
                           self.num_hosts)
            out = None
            if self.log_dir:
                os.makedirs(self.log_dir, exist_ok=True)
                out = open(os.path.join(
                    self.log_dir,
                    f"rank{self._global(i)}_epoch{self.epoch}.log"), "w")
            try:
                p = subprocess.Popen(
                    self.command, env=env, stdout=out,
                    stderr=subprocess.STDOUT if out else None,
                    preexec_fn=preexec, start_new_session=True)
            finally:
                if out is not None:
                    out.close()
            self.procs.append(p)
            log.info("rank %d started (pid %d, mesh epoch %d)",
                     self._global(i), p.pid, self.epoch,
                     extra=structlog.fields(
                         event="rank_start", rank=self._global(i),
                         pid=p.pid, epoch=self.epoch, t=time.time()))

    def forward(self, signum: int) -> None:
        """Send ``signum`` to every rank still running."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(signum)
                except OSError:
                    pass

    def wait(self) -> int:
        """Block until every rank has exited; the first non-zero exit
        code, or 0."""
        codes: List[Optional[int]] = [None] * len(self.procs)
        first = 0
        while any(c is None for c in codes):
            for i, p in enumerate(self.procs):
                if codes[i] is not None or p.poll() is None:
                    continue
                codes[i] = exit_code(p.returncode)
                first = first or codes[i]
                log.info("rank %d exited with code %d (pid %d, mesh epoch "
                         "%d)", self._global(i), codes[i], p.pid, self.epoch,
                         extra=structlog.fields(
                             event="rank_exit", rank=self._global(i),
                             pid=p.pid, code=codes[i], epoch=self.epoch,
                             t=time.time()))
            if any(c is None for c in codes):
                time.sleep(self.POLL_S)
        return first


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    own, command = argv, list(RANK_COMMAND)
    if "--" in argv:
        i = argv.index("--")
        own, command = argv[:i], argv[i + 1:] or command
    parser = argparse.ArgumentParser(
        description="start this host's ranks of a learningorchestra_tpu_"
                    "torch pod, one a card",
        epilog="Everything after '--' is the rank command; defaults to "
               "'python -m learningorchestra_tpu_torch.serving'.")
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks on this host (default: its CUDA "
                             "device count)")
    parser.add_argument("--host-id", type=int, default=0)
    parser.add_argument("--num-hosts", type=int, default=1)
    parser.add_argument("--log-dir", default=None,
                        help="write each rank's output to "
                             "<DIR>/rank<id>_epoch<epoch>.log")
    args = parser.parse_args(own)
    ranks = args.ranks
    if ranks is None:
        import torch

        ranks = torch.cuda.device_count()
        if ranks < 1:
            parser.error("no CUDA device on this host: pass --ranks")
    launcher = Launcher(command, ranks, host_id=args.host_id,
                        num_hosts=args.num_hosts, log_dir=args.log_dir)
    for signum in FORWARDED:
        signal.signal(signum, lambda s, _frame: launcher.forward(s))
    # A signal that arrives while the ranks start waits until all of them
    # have, so every rank receives it.
    signal.pthread_sigmask(signal.SIG_BLOCK, FORWARDED)
    try:
        launcher.start()
    finally:
        signal.pthread_sigmask(signal.SIG_UNBLOCK, FORWARDED)
    return launcher.wait()


if __name__ == "__main__":
    structlog.configure()
    sys.exit(main())
