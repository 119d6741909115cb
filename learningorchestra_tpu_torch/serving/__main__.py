"""``python -m learningorchestra_tpu_torch.serving`` — run the service.

Replaces the reference's per-service Flask ``app.run`` entrypoints + Docker
Swarm stack (reference run.sh, docker-compose.yml). One process serves
HTTP and owns one CUDA device (``--device``, ``cuda`` by default; ``cpu``
runs every kernel's plain PyTorch version on the host).
"""

import argparse
import os
import signal
import threading

from learningorchestra_tpu_torch.config import settings
from learningorchestra_tpu_torch.serving.app import App
from learningorchestra_tpu_torch.utils import structlog

log = structlog.get_logger("serving.main")


def install_graceful_shutdown(app: App, server) -> threading.Event:
    """Wire SIGTERM/SIGINT to a graceful drain of ``app`` + ``server``:
    the signal gates off new work (503 + Retry-After + Connection:
    close), in-flight predicts and queued jobs finish within
    ``LO_TPU_DRAIN_TIMEOUT_S``, then the server stops and the returned
    event is set — a planned restart loses zero accepted requests."""
    stopped = threading.Event()
    drain_started = threading.Event()

    def _graceful(signum, _frame):
        # Signal frame: do nothing blocking here. The drain itself —
        # waiting out in-flight predicts and queued jobs, then stopping
        # the server — runs on its own thread; SIGTERM/SIGINT land in
        # the main thread, which is parked on `stopped` by the caller.
        if drain_started.is_set():
            # Second signal while draining = the operator insists. The
            # drain is timeout-bounded but server.stop() is not — if it
            # wedged, nothing else would ever release the main thread,
            # leaving the process killable only by SIGKILL. Exit with
            # the conventional fatal-signal code so a supervisor reads
            # it as a kill, not a clean stop.
            log.error("second signal %d during drain: forcing exit",
                      signum)
            os._exit(128 + signum)
        drain_started.set()
        log.warning("signal %d received: graceful drain (up to %.0fs)",
                    signum, app.cfg.drain_timeout_s)

        def _drain():
            try:
                app.drain()
            finally:
                server.stop()
                stopped.set()

        # thread-lifecycle: owner=serving.__main__; exits after
        # drain+server.stop complete and sets `stopped`, which releases
        # the main thread to exit the process (daemon: a wedged stop
        # cannot outlive the interpreter).
        threading.Thread(target=_drain, name="lo-drain",
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    return stopped


def main() -> None:
    structlog.configure()
    parser = argparse.ArgumentParser(
        description="learningorchestra_tpu_torch server")
    parser.add_argument("--host", default=settings.host)
    parser.add_argument("--port", type=int, default=settings.port)
    parser.add_argument("--store-root", default=settings.store_root)
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (cuda, or cpu)")
    parser.add_argument("--no-recover", action="store_true",
                        help="skip loading persisted datasets at startup")
    args = parser.parse_args()

    settings.host = args.host
    settings.port = args.port
    settings.store_root = args.store_root

    app = App(settings, recover=not args.no_recover, device=args.device)
    server = app.serve(background=True)
    log.info("learningorchestra_tpu_torch serving on %s:%d (device: %s)",
             args.host, server.port, app.runtime.device)
    stopped = install_graceful_shutdown(app, server)
    stopped.wait()


if __name__ == "__main__":
    main()
