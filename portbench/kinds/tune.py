"""A hyperparameter sweep as the tune route serves it:
``ModelBuilder.tune`` of one family over the traffic mix's
configurations, folds and rungs, with the winner promoted, one sweep at
a time (a closed loop).

Set-up makes the train columns from the seed on the card, builds the
train dataset's design matrix (the sweeps find it in the dataset's memo,
as on a server that already built it) and warms up with a small sweep of
the same configurations. The window's end-to-end value is ``tune_s``:
its seconds over the sweeps it completed.

The reference is a random forest's (``reference.tune``), so the mix's
``family`` has to be ``rf``. It judges the window's leaderboards by two
configurations drawn from the seed, one the last sweep kept past its
first rung and one it dropped there (their fold scores, and that the
dropped one scored no better), and the last sweep's promoted model, tree
by tree.
"""

from __future__ import annotations

import gc
import math

import numpy as np

from portbench.kinds import build
from portbench.reference import trees
from portbench.reference import tune as ref_tune

LABEL = build.LABEL


def _launches() -> dict:
    from learningorchestra_tpu_torch.ops import tree_kernels, tsne_kernels

    return {**tree_kernels.launch_counts(), **tsne_kernels.launch_counts()}


def setup(run) -> None:
    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.models.builder import ModelBuilder
    from learningorchestra_tpu_torch.ops import preprocess
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

    if run.traffic["family"] != "rf":
        raise ValueError("portbench's tune reference is a random forest's; "
                         f"family {run.traffic['family']!r} has none")
    train, _ = build.make_columns(run)
    cfg = run.settings()
    store = DatasetStore(cfg)
    runtime = DeviceRuntime(cfg, device=run.device)
    mb = ModelBuilder(store, runtime, cfg)
    t = run.traffic
    warm = int(t["warmup_rows"])
    store.create("warm", columns={k: v[:warm] for k, v in train.items()},
                 finished=True)
    mb.tune("warm", "warm_tune", t["family"], t["configs"], LABEL,
            folds=t["folds"], rungs=t["rungs"], promote=t["promote"])
    for name in ("warm", "warm_tune"):
        store.delete(name)
    ds = store.create("train", columns=train, finished=True)
    ds.memo(("design", LABEL, "[]"),
            lambda: preprocess.design_matrix(ds, LABEL))
    run.state.update(train=train, store=store, runtime=runtime, mb=mb,
                     boards=[], sweeps=0)


def _one_sweep(run) -> None:
    st, t = run.state, run.traffic
    i = st["sweeps"]
    if i:
        st["store"].delete(f"tune{i - 1}")
    board = st["mb"].tune("train", f"tune{i}", t["family"], t["configs"],
                          LABEL, folds=t["folds"], rungs=t["rungs"],
                          promote=t["promote"])
    st["sweeps"] += 1
    st["boards"].append(board)
    run.attempted += 1
    if t["promote"] and "promoted" not in board:
        run.failed += 1


def window(run) -> dict:
    before = _launches()
    seconds, sweeps = run.closed_loop("tune", lambda: _one_sweep(run))
    after = _launches()
    run.state["launches"] = sum(after.values()) - sum(before.values())
    return {"tune_s": seconds / sweeps}


def release(run) -> None:
    """Keep the last sweep's promoted model (its trees and leaves) for
    the judgement, then free the program."""
    import torch

    from portbench.reference import trees

    st = run.state
    name = f"tune{st['sweeps'] - 1}"
    st["promoted"] = None
    if st["mb"].registry.exists(name):
        params = st["mb"].registry.load(name)[1].params
        st["promoted"] = (trees.program_trees(params, "rf"),
                          torch.as_tensor(params["leaf"]))
    for k in ("mb", "runtime", "store"):
        st.pop(k)
    gc.collect()
    if run.on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def per_rung(run, config: dict) -> int:
    return ref_tune.trees_per_rung(int(config["n_trees"]),
                                   run.traffic["rungs"])


def sampled_pair(run, board: dict) -> tuple:
    """(kept, dropped) configuration indices, drawn from the seed: one
    that ``board`` kept past its first rung and one it dropped there, in
    one wave; ``dropped`` is None where no wave dropped one."""
    configs = run.traffic["configs"]
    index = {ref_tune.json_key(c): i for i, c in enumerate(configs)}
    waves = {}
    for r in board["results"]:
        i = index.get(ref_tune.json_key(r["config"]))
        if i is not None:
            side = "kept" if r["rungs_survived"] > 1 else "dropped"
            waves.setdefault(r.get("wave", 0), {"kept": [], "dropped": []})[
                side].append(i)
    rng = np.random.default_rng(run.seed)
    both = sorted(w for w, s in waves.items() if s["kept"] and s["dropped"])
    if both:
        side = waves[both[int(rng.integers(len(both)))]]
        return (int(rng.choice(sorted(side["kept"]))),
                int(rng.choice(sorted(side["dropped"]))))
    kept = sorted(i for s in waves.values() for i in s["kept"])
    return (int(rng.choice(kept)) if kept else 0), None


def _design(run) -> tuple:
    st = run.state
    features = [f"f{i}" for i in range(run.config["data"]["features"])]
    X = np.stack([st["train"][f] for f in features], axis=1)
    return X, np.asarray(st["train"][LABEL])


def reference_numbers(run, X, y, boards: list, promoted, *,
                      precision: str = "float32") -> list:
    """The numbers that judge ``boards`` and the ``promoted`` (trees,
    leaves) of the last against the reference."""
    t = run.traffic
    configs = t["configs"]
    board = boards[-1]
    kept, dropped = sampled_pair(run, board)
    by_cfg = {ref_tune.json_key(r["config"]): r for r in board["results"]}
    sampled = {}
    for ci in (kept, dropped):
        if ci is None:
            continue
        c = configs[ci]
        r = by_cfg.get(ref_tune.json_key(c))
        grown = per_rung(run, c) * (r["rungs_survived"] if r else 1)
        grows = sorted({per_rung(run, c), min(grown, int(c["n_trees"]))})
        sampled[ci] = ref_tune.member_scores(
            X, y, c, folds=t["folds"], grows=grows, device=run.device,
            precision=precision)
    out = ref_tune.judge(boards, sampled, configs, t["rungs"])
    first = {ci: s[per_rung(run, configs[ci])] for ci, s in sampled.items()}
    out.append(("halving_gap", 0.0 if dropped is None else
                ref_tune.halving_gap(kept, dropped, first)))
    winner = board["winner"]["config"]
    prog = promoted if t["promote"] else None
    if prog is None or len(prog[0]) != int(winner["n_trees"]):
        return out + [("split_gap.promoted", math.inf),
                      ("leaf_gap.promoted", math.inf)]
    forest = ref_tune.promoted(X, y, winner, device=run.device,
                               follow=prog[0])
    return out + [("split_gap.promoted", trees.split_gap(forest)),
                  ("leaf_gap.promoted", ref_tune.leaf_gap(prog[1], forest))]


def judge(run) -> list:
    st = run.state
    X, y = _design(run)
    limits = run.config["limits"]["tune"]
    return [(k, v, limits[k]) for k, v in reference_numbers(
        run, X, y, st["boards"], st["promoted"])]
