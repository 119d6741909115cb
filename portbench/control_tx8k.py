"""The control of ``kimilinear48b.tx_build_8k``'s comparison: the plain
reference put in the program's place at a lower precision than the
configuration states — in bfloat16 (``--precision bfloat16``: the
weights cast at their use, activations and the recurrent state in
bfloat16, gradients and Adam in float32) or in float32 with TF32 matrix
products allowed (``--precision tf32``) — then judged against the
float32 reference exactly as a run's program is
(``kinds/txbuild_hybrid.reference_numbers``). Its numbers have to come
out above their limits; the benchmark's own runs never run it.

    python3 -m portbench.control_tx8k --precision bfloat16 --seeds <n> ...

prints one JSON line a seed with each number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

from portbench.control_tx import set_tf32

WORKLOAD = "kimilinear48b.tx_build_8k"


def control(spec: dict, seed: int, precision: str, device: str) -> dict:
    import torch

    from portbench import harness
    from portbench.kinds import txbuild, txbuild_hybrid as kind
    from portbench.reference import kimi_linear as ref

    run = harness.Run(spec, seed, 0.0, False, device, time.monotonic())
    try:
        run.state["data"] = txbuild.make_data(run)
        hp = kind.hparams(run.config)
        cfg = kind.reference_config(run)
        first, held = ref.held_experts(cfg)
        dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
        X, y = run.state["data"]["train"]
        Xt, _ = run.state["data"]["test"]
        routes, pairs = {}, [0]

        def observe(step, layer, chosen):
            if step == 0:
                routes[layer] = chosen
            pairs[0] += int(((chosen >= first)
                             & (chosen < first + held)).sum())

        params = ref.init_params(cfg, hp["seed"], device)
        set_tf32(precision == "tf32")
        try:
            losses = ref.train(params, torch.from_numpy(X).to(device),
                               torch.from_numpy(y).to(device),
                               kind.batches(run), cfg, hp["lr"],
                               observe=observe, remat=True, dtype=dtype)
            logits = ref.forward(params, torch.from_numpy(Xt).to(device),
                                 cfg, dtype=dtype)
        finally:
            set_tf32(False)
        probs = torch.softmax(logits.double(), -1).cpu().numpy()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        prog = {"losses": losses, "params": params, "routes": routes,
                "pairs_held": pairs[0], "probs": probs}
        numbers = kind.reference_numbers(run, prog, device)
    finally:
        shutil.rmtree(run.work, ignore_errors=True)
    limits = run.config["limits"]["txbuild8k"]
    checks = [(k, v, limits[k]) for k, v in numbers]
    return {"workload": WORKLOAD, "seed": seed, "precision": precision,
            "fails": any(v > lim for _, v, lim in checks),
            "checks": {k: {"value": v, "limit": lim}
                       for k, v, lim in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", choices=("bfloat16", "tf32"),
                    required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from portbench import harness

    root = Path.cwd()
    spec = harness.cell_spec(harness.load_benchmark(root), root, WORKLOAD)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control_tx8k: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(control(spec, seed, args.precision, "cuda")),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
