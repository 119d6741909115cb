"""The plain reference of a random-forest tune sweep's members and of
its promoted winner, and the numbers that judge the program's
leaderboard and promoted model against it.

A member is one (configuration, fold) pair: fold f holds the rows whose
index is f modulo the fold count; the member's forest is the
configuration's random forest (its own quantile edges at its bin count,
its depth and feature count, bootstrap and feature draws from a
generator seeded with its seed) fitted on the other folds' rows, and its
score is the accuracy of the trees grown so far on fold f's rows. A
rung grows ``trees_per_rung`` more trees; after every rung but the last
the sweep keeps the better half of the configurations still running,
by mean score, ties to the lower index.

The promoted winner is the winning configuration's forest on every row;
the reference judges the program's trees split by split
(``trees.split_gap``) and their leaves against its own sums.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import trees


def _codes(X: np.ndarray, n_bins: int, q, dev) -> torch.Tensor:
    Xd = q(torch.from_numpy(X).to(dev))
    return trees.bin_codes(Xd, torch.from_numpy(
        trees.quantile_edges(Xd.cpu().numpy(), n_bins)).to(dev))


def member_scores(X: np.ndarray, y: np.ndarray, config: Dict, *, folds: int,
                  grows: List[int], device, num_classes: int = 2,
                  precision: str = "float32") -> Dict[int, List[float]]:
    """The fold scores of one configuration after each count of trees in
    ``grows``; ``precision`` below float32 rounds the design and every
    float the trees compute to it (the control)."""
    from portbench.reference.build import rounder

    q = rounder(precision)
    dev = torch.device(device)
    nb = int(config.get("n_bins", 32))
    B = _codes(X, nb, q, dev)
    yd = torch.from_numpy(np.asarray(y)).to(dev)
    idx = torch.arange(len(y), device=dev)
    depth = int(config.get("max_depth", 5))
    out = {g: [] for g in grows}
    for f in range(folds):
        ev = (idx % folds) == f
        forest = trees.fit_forest(
            B, yd, num_classes, n_trees=int(config.get("n_trees", 20)),
            max_depth=depth, n_bins=nb, seed=int(config.get("seed", 0)),
            mtry=config.get("mtry"), row_weight=(~ev).float(),
            grow_trees=max(grows), q=q)
        for g in grows:
            p = trees.forest_proba(B[ev], forest[:g], depth, q=q)
            out[g].append(float((p.argmax(1) == yd[ev]).double().mean()))
        del forest
    return out


def promoted(X: np.ndarray, y: np.ndarray, config: Dict, *, device,
             num_classes: int = 2, precision: str = "float32",
             follow: Optional[List[Dict]] = None) -> List[Dict]:
    """The configuration's forest on every row: the reference's own (at
    ``precision``), or with ``follow`` the program's trees judged, each
    with its ``gap`` and the reference's float64 leaves."""
    from portbench.reference.build import rounder

    q = rounder(precision)
    dev = torch.device(device)
    nb = int(config.get("n_bins", 32))
    B = _codes(X, nb, q, dev)
    yd = torch.from_numpy(np.asarray(y)).to(dev)
    return trees.fit_forest(
        B, yd, num_classes, n_trees=int(config.get("n_trees", 20)),
        max_depth=int(config.get("max_depth", 5)), n_bins=nb,
        seed=int(config.get("seed", 0)), mtry=config.get("mtry"), q=q,
        follow=follow)


def leaf_gap(prog_leaf, judged: List[Dict]) -> float:
    """The largest difference of a leaf's class share between the
    program's leaves (T, M, S) and the judged forest's."""
    if prog_leaf is None or prog_leaf.shape[0] != len(judged):
        return math.inf

    def shares(t):
        t = t.double()
        return t / t.sum(-1, keepdim=True).clamp(min=1e-300)

    return max(float((shares(prog_leaf[i].to(j["leaf"].device))
                      - shares(j["leaf"])).abs().max())
               for i, j in enumerate(judged))


def halving_gap(kept: int, dropped: int,
                first: Dict[int, List[float]]) -> float:
    """Of a configuration the sweep kept past the first rung and one it
    dropped there: how far the dropped one's mean score after the first
    rung lies above the kept one's, by the reference's fold scores (0
    where it lies below or level)."""
    mk, md = float(np.mean(first[kept])), float(np.mean(first[dropped]))
    return md - mk if md > mk else 0.0


def judge(boards: List[Dict], sampled: Dict[int, Dict[int, List[float]]],
          configs: List[Dict], rungs: int) -> List[tuple]:
    """``fold_gap``: the largest difference, over the window's sweeps and
    the sampled configurations, between a fold score the leaderboard
    wrote and the reference's after as many trees as the configuration
    survived to grow; ``board_gap``: the largest difference between a
    written mean and the mean of its written fold scores, and whether
    the winner is the best surviving configuration by the written means
    (1 where it is not). A sweep whose leaderboard lacks a sampled
    configuration, or whose configuration grew a count of trees the
    reference did not score, reads infinity."""
    fold_gap, board_gap = 0.0, 0.0
    for board in boards:
        by_cfg = {json_key(r["config"]): r for r in board["results"]}
        for ci, ref in sampled.items():
            r = by_cfg.get(json_key(configs[ci]))
            n_trees = int(configs[ci]["n_trees"])
            grown = None if r is None else min(
                r["rungs_survived"] * trees_per_rung(n_trees, rungs), n_trees)
            if grown not in ref:
                fold_gap = math.inf
                continue
            fold_gap = max(fold_gap, max(abs(a - b) for a, b in
                                         zip(r["fold_scores"], ref[grown])))
        finishers = [r for r in board["results"] if r["alive"]] \
            or board["results"]
        best = max(r["mean_score"] for r in finishers)
        if board["winner"]["mean_score"] != best or \
                json_key(board["winner"]["config"]) not in {
                    json_key(r["config"]) for r in finishers}:
            board_gap = max(board_gap, 1.0)
        for r in board["results"]:
            board_gap = max(board_gap, abs(
                r["mean_score"] - float(np.mean(r["fold_scores"]))))
    return [("fold_gap", fold_gap), ("board_gap", board_gap)]


def trees_per_rung(n_trees: int, rungs: int) -> int:
    """Trees a rung grows: a rung is an equal share of the forest's tree
    batches (the largest divisor of the tree count up to 8, else 8), as
    the serial fit checkpoints them."""
    tb = max(t for t in range(1, min(8, n_trees) + 1) if n_trees % t == 0)
    if tb < 4 and n_trees > 8:
        tb = 8
    batches = -(-n_trees // tb)
    return -(-batches // max(1, min(rungs, batches))) * tb


def json_key(config: Dict) -> str:
    return repr(sorted(config.items()))
