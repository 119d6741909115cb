"""How far two float32 orders of the same mlp fit drift apart, on the CPU.

    python tests/mlp_divergence_probe.py [--rows 50000] [--iters 60 300]

Not a test (pytest does not collect it): it measures what a comparison
of two mlp fits row by row can hold. On ``benchmarks/workload.py``'s
HIGGS-like rows (seed 2; 20,000 test rows, seed 1), hidden 256, lr 1e-2,
at each iteration count it prints, as one JSON line, the largest
probability difference, the share of test rows with the same argmax and
both accuracies of two pairs of fits:

- ``port_threads``: the PyTorch package's one-card fit (seed 0) run with
  1 and with 4 CPU threads, which sum the same float32 products in
  another order;
- ``jax_mesh``: the JAX package's fit (seed 0) on one CPU device and on
  a (1, 2) mesh, whose model-axis program rounds the summed logits to
  bf16 where the one-device program does not.

``chip_smoke.py``'s ``pod_tp`` phase holds its rows at the count where
both stay within ``test_torch_mlp.py::test_fit_matches_jax``'s
tolerances.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.workload import higgs_like_xy  # noqa: E402
from learningorchestra_tpu.config import Settings as JaxSettings  # noqa: E402
from learningorchestra_tpu.models import mlp as jmlp  # noqa: E402
from learningorchestra_tpu.parallel.mesh import (  # noqa: E402
    MeshRuntime, local_mesh)
from learningorchestra_tpu_torch.config import Settings  # noqa: E402
from learningorchestra_tpu_torch.models import mlp  # noqa: E402
from learningorchestra_tpu_torch.parallel.runtime import (  # noqa: E402
    DeviceRuntime)

HIDDEN, LR = 256, 1e-2


def _compare(p_a, p_b, y) -> dict:
    acc = lambda p: float((np.argmax(p, 1) == y).mean())
    return {"max_abs_proba_diff": float(np.abs(p_a - p_b).max()),
            "argmax_agreement": float(
                (np.argmax(p_a, 1) == np.argmax(p_b, 1)).mean()),
            "accuracy": [acc(p_a), acc(p_b)]}


def _jax_proba(mesh_shape, X, y, Xt, iters):
    cfg = JaxSettings()
    cfg.mesh_shape = mesh_shape
    rt = MeshRuntime(cfg)
    n = int(np.prod([int(v) for v in mesh_shape.split(",")]))
    rt._mesh = local_mesh(cfg, jax.devices()[:n])
    model = jmlp.fit(rt, X.copy(), y.copy(), 2, seed=0, hidden=HIDDEN,
                     iters=iters, lr=LR)
    return np.asarray(model.predict_proba(rt, Xt))


def _port_proba(threads, X, y, Xt, iters):
    torch.set_num_threads(threads)
    rt = DeviceRuntime(Settings(), device="cpu")
    model = mlp.fit(rt, X.copy(), y.copy(), 2, seed=0, hidden=HIDDEN,
                    iters=iters, lr=LR)
    return model.predict_proba(rt, Xt)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=50_000)
    ap.add_argument("--iters", type=int, nargs="+", default=[60, 300])
    args = ap.parse_args()
    X, y = higgs_like_xy(args.rows, 2)
    Xt, yt = higgs_like_xy(20_000, 1)
    X, Xt, y = X.astype(np.float32), Xt.astype(np.float32), y.astype(np.int32)
    for iters in args.iters:
        print(json.dumps({
            "rows": args.rows, "iters": iters, "hidden": HIDDEN, "lr": LR,
            "port_threads": _compare(_port_proba(1, X, y, Xt, iters),
                                     _port_proba(4, X, y, Xt, iters), yt),
            "jax_mesh": _compare(_jax_proba("1,1", X, y, Xt, iters),
                                 _jax_proba("1,2", X, y, Xt, iters), yt)}),
            flush=True)


if __name__ == "__main__":
    main()
