"""The control of a cell's correctness check: the plain reference put in
the program's place and computed in the nearest precision below the one
the configuration states. Its numbers have to come out above their
limits; the benchmark's own runs never run it. Its trees are judged as
the program's are.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed with each number the cell compares, beside
its limit. For ``build`` the control is the reference in bfloat16 (the
design rounded to it, every float of the trees rounded to it). For
``tsne`` it is the affinities computed in float32 with TF32 matrix
products and each judged step computed in bfloat16, from the program's
states of one image.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def build_control(run) -> list:
    import torch

    from portbench.kinds import build
    from portbench.reference import build as ref_build

    train, test = build.make_columns(run)
    cfg = run.config
    features = [f"f{i}" for i in range(cfg["data"]["features"])]
    families = list(run.traffic["classifiers"])
    hp = build.hparams(cfg)
    low = ref_build.fit_predict(train, test, features, build.LABEL,
                                families, hp, run.device,
                                precision="bfloat16")
    if run.on_card:
        torch.cuda.empty_cache()
    ref = ref_build.fit_predict(train, test, features, build.LABEL, families,
                                hp, run.device, follow=low["trees"])
    y = np.asarray(test[build.LABEL])
    prog = {"design": low["design"],
            "preds": {c: [low["preds"][c]] for c in families},
            "metrics": {c: [ref_build.classification_metrics(
                y, low["preds"][c])] for c in families}}
    limits = cfg["limits"]["build"]
    return [(k, v, limits[k]) for k, v in ref_build.judge(ref, prog, y,
                                                           families)]


def tsne_control(run) -> list:
    import torch

    from portbench.kinds import tsne

    tsne.setup(run)
    run.seconds = 0.0
    tsne.window(run)
    tsne.release(run)
    shape = run.config["data"]
    X = tsne.design(run.state["cols"], shape["rows"], shape["features"])
    limits = run.config["limits"]["tsne"]
    return [(k, v, limits[k]) for k, v in tsne.numbers(
        run, run.state["recorder"], X, dtype=torch.bfloat16, tf32=True)]


def tune_control(run) -> list:
    """The reference in bfloat16 in the program's place: two
    configurations drawn from the seed, the first as kept past the first
    rung and the second as dropped there, their bfloat16 fold scores as
    the leaderboard, and the winner's bfloat16 forest on every row as
    the promoted model."""
    import torch

    from portbench.kinds import build, tune
    from portbench.reference import tune as ref_tune

    train, _ = build.make_columns(run)
    run.state["train"] = train
    X, y = tune._design(run)
    t = run.traffic
    rng = np.random.default_rng(run.seed)
    pair = rng.choice(len(t["configs"]), 2, replace=False).tolist()
    results = []
    for ci, rungs in zip(pair, (t["rungs"], 1)):
        c = t["configs"][ci]
        grown = min(rungs * tune.per_rung(run, c), int(c["n_trees"]))
        low = ref_tune.member_scores(X, y, c, folds=t["folds"],
                                     grows=[grown], device=run.device,
                                     precision="bfloat16")[grown]
        results.append({"config": c, "fold_scores": low,
                        "mean_score": float(np.mean(low)),
                        "rungs_survived": rungs, "alive": rungs > 1,
                        "wave": 0})
    board = {"results": results, "winner": results[0]}
    forest = ref_tune.promoted(X, y, results[0]["config"],
                               device=run.device, precision="bfloat16")
    promoted = ([{k: tr[k] for k in ("feat", "thr", "internal")}
                 for tr in forest],
                torch.stack([tr["leaf"] for tr in forest]))
    limits = run.config["limits"]["tune"]
    return [(k, v, limits[k]) for k, v in tune.reference_numbers(
        run, X, y, [board], promoted)]


CONTROLS = {"build": build_control, "tsne": tsne_control,
            "tune": tune_control}


def control(spec: dict, seed: int, device: str) -> dict:
    from portbench import harness

    run = harness.Run(spec, seed, 0.0, False, device, time.monotonic())
    try:
        checks = CONTROLS[spec["traffic"]["kind"]](run)
    finally:
        import shutil

        shutil.rmtree(run.work, ignore_errors=True)
    return {"workload": spec["cell"]["name"], "seed": seed,
            "fails": any(v > lim for _, v, lim in checks),
            "checks": {k: {"value": v, "limit": lim}
                       for k, v, lim in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from portbench import harness

    root = Path.cwd()
    spec = harness.cell_spec(harness.load_benchmark(root), root,
                             args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(control(spec, seed, "cuda")), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
