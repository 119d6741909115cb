"""The plain reference of a five-family build, and the numbers that judge
the program's build against it.

The reference makes its own design matrix from the catalog columns (the
numeric feature columns in order, float32), its own quantile edges and
bin codes, fits each family (``reference.trees``, ``reference.linear``)
and predicts the test rows. It reads the program's outputs only to
judge them: the program's design matrix, its fitted trees (each split
judged against the reference's gains, rows routed by the program's
splits, leaves the reference's own), each family's predicted class of
every test row, and the accuracy and F1 the build wrote.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import linear, trees

PRECISIONS = {"float32": None, "bfloat16": torch.bfloat16,
              "float8_e4m3": torch.float8_e4m3fn}
#: The precision below each family's stated one: the port states float32
#: for the trees and naive Bayes, and bfloat16 operands (float32 sums)
#: for logistic regression's products, whose next step down is fp8.
BELOW = {"bfloat16": {"lr": "float8_e4m3"}}


def rounder(precision: str):
    """Rounding to ``precision`` and back; the identity for float32."""
    low = PRECISIONS[precision]
    if low is None:
        return lambda t: t
    return lambda t: t.to(low).to(t.dtype)


def design(cols: Dict[str, np.ndarray], features: List[str]) -> np.ndarray:
    return np.stack([np.asarray(cols[f], np.float32) for f in features],
                    axis=1)


def fit_predict(cols_train: dict, cols_test: dict, features: List[str],
                label: str, families: List[str], hp: Dict[str, dict],
                device, precision: str = "float32",
                follow: Optional[Dict[str, list]] = None) -> dict:
    """The reference's design matrices and each family's predicted class
    and probabilities of the test rows, and its trees. ``precision``
    below float32 rounds the design and every float the trees compute to
    it (the control). ``follow`` maps a tree family to the program's
    trees: those are judged (``split_gap``) instead of grown; a tree
    family missing from it reads infinity."""
    q = rounder(precision)
    dev = torch.device(device)
    X = torch.from_numpy(design(cols_train, features)).to(dev)
    Xt = torch.from_numpy(design(cols_test, features)).to(dev)
    X, Xt = q(X), q(Xt)
    y = torch.from_numpy(np.asarray(cols_train[label])).to(dev)
    num_classes = int(max(int(y.max()),
                          int(np.asarray(cols_test[label]).max()))) + 1
    out = {"design": (X.cpu().numpy(), Xt.cpu().numpy()), "preds": {},
           "probs": {}, "trees": {}, "split_gap": {}}
    binned = {}

    def codes(n_bins):
        if n_bins not in binned:
            edges = torch.from_numpy(trees.quantile_edges(
                out["design"][0], n_bins)).to(dev)
            binned[n_bins] = (trees.bin_codes(X, edges),
                              trees.bin_codes(Xt, edges))
        return binned[n_bins]

    for kind in families:
        h = hp.get(kind, {})
        if kind == "lr":
            m = linear.fit_logistic(
                X, y, num_classes, iters=h["iters"], l2=h["l2"],
                q=rounder(BELOW.get(precision, {}).get("lr", "float32")))
            p = linear.logistic_proba(m, Xt)
        elif kind == "nb":
            m = linear.fit_bayes(X, y, num_classes,
                                 smoothing=h["smoothing"])
            p = linear.bayes_proba(m, Xt)
        elif kind in ("dt", "rf", "gb"):
            B, Bt = codes(h["n_bins"])
            prog = None if follow is None else follow.get(kind)
            size = h["n_rounds"] if kind == "gb" else h["n_trees"]
            if follow is not None and (prog is None or len(prog) != size):
                out["split_gap"][kind] = math.inf
                prog = None
            if kind == "gb":
                forest = trees.fit_boosted(
                    B, y, n_rounds=h["n_rounds"], max_depth=h["max_depth"],
                    n_bins=h["n_bins"], step=h["step_size"], lam=h["lam"],
                    q=q, follow=prog)
                p = trees.boosted_proba(Bt, forest, h["max_depth"],
                                        step=h["step_size"], q=q)
            else:
                forest = trees.fit_forest(
                    B, y, num_classes, n_trees=h["n_trees"],
                    max_depth=h["max_depth"], n_bins=h["n_bins"],
                    seed=h["seed"], mtry=h.get("mtry"), q=q, follow=prog)
                p = trees.forest_proba(Bt, forest, h["max_depth"], q=q)
            out["trees"][kind] = forest
            if prog is not None:
                out["split_gap"][kind] = trees.split_gap(forest)
        else:
            raise ValueError(f"no reference for family {kind!r}")
        out["probs"][kind] = p.double().cpu().numpy()
        out["preds"][kind] = out["probs"][kind].argmax(1)
    return out


def classification_metrics(y: np.ndarray, pred: np.ndarray) -> tuple:
    """(accuracy, support-weighted F1)."""
    classes = np.unique(np.concatenate([y, pred]))
    f1s, support = [], []
    for c in classes:
        tp = float(np.sum((pred == c) & (y == c)))
        pp, sp = float(np.sum(pred == c)), float(np.sum(y == c))
        prec = tp / pp if pp else 0.0
        rec = tp / sp if sp else 0.0
        f1s.append(2 * prec * rec / (prec + rec) if prec + rec else 0.0)
        support.append(sp)
    support = np.asarray(support)
    return (float(np.mean(pred == y)),
            float(np.dot(f1s, support) / max(support.sum(), 1.0)))


def judge(ref: dict, prog: dict, y_test: np.ndarray,
          families: List[str]) -> List[tuple]:
    """Numbers of the program's build against the reference's, before
    their limits: ``design_gap`` the largest difference of a design
    value; ``split_gap.<family>`` a tree family's ``trees.split_gap``;
    ``disagree.<family>`` the largest share, over the window's builds,
    of test rows whose class differs from the reference's; ``metric_gap``
    the largest difference between a written accuracy or F1 and the one
    the program's own predictions give."""
    gap = 0.0
    for a, b in zip(prog["design"], ref["design"]):
        if a.shape != b.shape:
            gap = float("inf")
        elif not np.array_equal(a, b):
            gap = max(gap, float(np.nanmax(np.abs(
                a.astype(np.float64) - b))))
            if np.isnan(a).any() != np.isnan(b).any():
                gap = float("inf")
    out = [("design_gap", gap)]
    out += [(f"split_gap.{k}", ref["split_gap"][k])
            for k in families if k in ref["split_gap"]]
    metric_gap = 0.0
    for kind in families:
        worst = 0.0
        for preds, written in zip(prog["preds"][kind],
                                  prog["metrics"][kind]):
            if preds is None or len(preds) != len(y_test):
                worst = 1.0
                continue
            worst = max(worst, float(np.mean(preds != ref["preds"][kind])))
            acc, f1 = classification_metrics(y_test, preds)
            metric_gap = max(metric_gap, abs(acc - written[0]),
                             abs(f1 - written[1]))
        out.append((f"disagree.{kind}", worst))
    out.append(("metric_gap", metric_gap))
    return out
