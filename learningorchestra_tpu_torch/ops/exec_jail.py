"""Child-process runner for ``exec`` preprocessing (ops/preprocess.py).

The reference runs user code with a bare ``exec()`` inside the service
process (reference model_builder.py:145-150): an infinite loop wedges the
worker, a memory bomb OOM-kills the server, a segfaulting C extension
takes every in-flight job down with it. Here the opt-in exec path runs in
THIS runner — a separate interpreter with POSIX rlimits (CPU seconds,
address space, no core dumps) — so runaway user code dies alone and the
server observes a clean, attributable failure.

This is a RESOURCE jail, not a security boundary: the child shares the
server's uid and filesystem. The gate against untrusted code remains
``settings.allow_exec_preprocessing`` (off by default; the declarative
step API is the default path).

Protocol: pickled request dict on stdin (the parent is trusted) → npz
archive on stdout, which the parent decodes with ``allow_pickle=False``.
The reply is deliberately NOT pickle: user code sharing the process can
always find the reply pipe (scan /proc/self/fd), so the parent must never
run a deserializer that executes. With npz, forged reply bytes yield at
worst wrong arrays — a power user code already has, since it defines
``features_training`` itself — or a clean decode failure. Never imported
by the server; invoked as
``python -m learningorchestra_tpu_torch.ops.exec_jail``. It imports numpy
and pandas only — never torch, never jax.
"""

from __future__ import annotations

import os
import pickle
import resource
import sys


def _apply_rlimits(cpu_s: int, mem_mb: int) -> None:
    resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
    if cpu_s > 0:
        resource.setrlimit(resource.RLIMIT_CPU, (cpu_s, cpu_s + 5))
    if mem_mb > 0:
        limit = mem_mb << 20
        try:
            resource.setrlimit(resource.RLIMIT_AS, (limit, limit))
        except (ValueError, OSError):
            pass  # some kernels refuse RLIMIT_AS below current usage


def main() -> int:
    req = pickle.load(sys.stdin.buffer)
    _apply_rlimits(int(req.get("cpu_s", 0)), int(req.get("mem_mb", 0)))

    import numpy as np
    import pandas as pd

    # Move the reply pipe OFF fd 1 before user code runs: dup it to a
    # private fd, then point fd 1 at stderr, so a stray print() or naive
    # os.write(1, ...) lands on stderr instead of corrupting the reply.
    # This is hygiene, not isolation — code in this process can still find
    # the dup'd fd — which is why the reply encoding (npz, decoded with
    # allow_pickle=False) is what actually keeps forged bytes harmless.
    reply_fd = os.dup(sys.stdout.fileno())
    os.set_inheritable(reply_fd, False)
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    response = os.fdopen(reply_fd, "wb")
    sys.stdout = sys.stderr
    sys.__stdout__ = sys.stderr

    scope = {
        "training_df": pd.DataFrame(req["train_cols"]),
        "testing_df": pd.DataFrame(req["test_cols"]),
        "np": np, "pd": pd, "label": req["label"],
    }
    out = None
    try:
        exec(req["code"], scope)  # noqa: S102 — the jail IS the handling
    except BaseException as exc:  # noqa: BLE001 — report, don't crash-loop
        out = {"error": f"{type(exc).__name__}: {exc}"}
    if out is None:
        required = ("features_training", "labels_training",
                    "features_testing")
        missing = [k for k in required if k not in scope]
        if missing:
            out = {"error": (
                f"preprocessor code must define {missing} "
                "(features_training, labels_training, features_testing)")}
        else:
            try:
                out = {
                    "X_train": np.asarray(scope["features_training"],
                                          np.float32),
                    "y_train": np.asarray(scope["labels_training"],
                                          np.int32),
                    "X_test": np.asarray(scope["features_testing"],
                                         np.float32),
                }
                y_test = scope.get("labels_testing")
                out["y_test"] = (np.asarray(y_test, np.int32)
                                 if y_test is not None else None)
            except BaseException as exc:  # noqa: BLE001
                out = {"error": f"{type(exc).__name__}: {exc}"}
    arrays = {}
    if "error" in out:
        arrays["error"] = np.array(str(out["error"]))   # dtype <U, no pickle
    else:
        for key in ("X_train", "y_train", "X_test"):
            arrays[key] = out[key]
        if out.get("y_test") is not None:
            arrays["y_test"] = out["y_test"]
    np.savez(response, **arrays)
    response.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
