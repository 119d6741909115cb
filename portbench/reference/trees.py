"""Plain histogram trees: decision tree (gini), random forest and
gradient-boosted trees (Newton steps on the logistic loss), as Spark 2.4
defines them with ``maxBins`` quantile bins.

Written from the algorithm, in plain PyTorch, one level of one tree at a
time: quantile edges from a seeded row sample, uint8 bin codes, per level
a (node, feature, bin, stat) histogram summed in float64 by
``index_add_``, the split gains from cumulative sums over the bins, the
best split by ``argmax``, then every row routed to its child. A random
forest's trees draw their Poisson(1) bootstrap weights and their feature
subsets from one ``torch.Generator`` seeded with the fit's seed, tree by
tree, weights first. ``q`` rounds every float the trees compute (the
identity for float32; a lower precision for the control).

Given the program's trees (``follow``), the reference judges them rather
than growing its own: at every node it works out, in float64, the gain of
every allowed split of the rows the program's tree sent there, and
counts how far the program's chosen split (or its choice to stop) lies
below the best, in float32 units of the node's impurity (``EPS32`` times
``gain_scale``). Splits whose gains tie to rounding then agree however
either side orders its sums. Rows are routed by the program's splits and
the leaves are the reference's own float64 sums.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

NEG = -1e30
_BLOCK = 1 << 20
#: One float32 rounding unit (2^-23).
EPS32 = 2.0 ** -23


def _identity(t):
    return t


def quantile_edges(X: np.ndarray, n_bins: int,
                   sample: int = 200_000) -> np.ndarray:
    """(d, n_bins - 1) edges: the quantiles of a seeded sample of rows."""
    n = len(X)
    Xs = X[np.random.default_rng(0).choice(n, sample, replace=False)] \
        if n > sample else X
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.ascontiguousarray(
        np.quantile(Xs, qs, axis=0).T.astype(np.float32))


def bin_codes(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """A feature's code is the number of its edges strictly below it."""
    out = torch.empty(X.shape, dtype=torch.uint8, device=X.device)
    for a in range(0, X.shape[0], 1 << 18):
        out[a:a + (1 << 18)] = (X[a:a + (1 << 18), :, None]
                                > edges[None]).sum(-1).to(torch.uint8)
    return out


def gini_gain(left, total):
    right = total - left
    lw, rw, tw = left.sum(-1), right.sum(-1), total.sum(-1)

    def gini_w(c, w):
        return w - (c ** 2).sum(-1) / torch.clamp(w, min=1e-12)

    child = gini_w(left, lw) + gini_w(right, rw)
    return (gini_w(total, tw) - child) / torch.clamp(tw, min=1e-12)


def newton_gain(lam: float) -> Callable:
    def gain(left, total):
        right = total - left
        gl, hl = left[..., 0], left[..., 1]
        gr, hr = right[..., 0], right[..., 1]
        g, h = total[..., 0], total[..., 1]
        return (gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam)
                - g ** 2 / (h + lam))
    return gain


def gini_scale(total, best):
    """The size of a gini gain's terms at a node: its children's and
    parent's weighted impurities over the node's weight, about 1."""
    return torch.ones_like(best)


def newton_scale(lam: float) -> Callable:
    """The size of a Newton gain's terms at a node: the parent's
    G^2/(H + lam) twice (the children's sum is the parent's plus the
    gain) and the best gain."""
    def scale(total, best):
        g, h = total[..., 0], total[..., 1]
        return 2.0 * g ** 2 / (h + lam) + best.clamp(min=0.0)
    return scale


def grow(B: torch.Tensor, stats: torch.Tensor, allowed: torch.Tensor, *,
         max_depth: int, n_bins: int, gain_fn, weight_fn,
         min_child_weight: float, min_gain: float,
         q: Callable = _identity, follow: Optional[Dict] = None,
         scale_fn: Callable = gini_scale) -> Dict[str, torch.Tensor]:
    """One tree over bin codes B (n, d) and per-row stats (S, n).
    Children of node i are 2i+1 and 2i+2. Returns the tree's tables and
    every row's leaf; with ``follow`` (the program's ``feat``, ``thr``
    and ``internal`` of this tree), its tables and ``gap``, the largest
    distance of one of its choices below the best, in units of
    ``EPS32 * scale_fn``."""
    n, d = B.shape
    S = stats.shape[0]
    dev = B.device
    M = 2 ** (max_depth + 1) - 1
    if follow is not None:
        q = _identity
        follow = {k: follow[k].to(dev) for k in ("feat", "thr", "internal")}
        follow = {"feat": follow["feat"].long().clamp(0, d - 1),
                  "thr": follow["thr"].long(),
                  "internal": follow["internal"].bool()}
    feat = torch.zeros(M, dtype=torch.long, device=dev)
    thr = torch.zeros(M, dtype=torch.long, device=dev)
    internal = torch.zeros(M, dtype=torch.bool, device=dev)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    # Only the allowed features are summed; gains stay ordered by feature.
    fidx = torch.nonzero(allowed)[:, 0]
    dd = int(fidx.shape[0])
    slot = torch.full((d,), -1, dtype=torch.long, device=dev)
    slot[fidx] = torch.arange(dd, device=dev)
    cols = torch.arange(dd, device=dev)
    gap = torch.zeros((), dtype=torch.float64, device=dev)
    for level in range(max_depth):
        off, width = (1 << level) - 1, 1 << level
        hist = torch.zeros((width * dd * n_bins, S), dtype=torch.float64,
                           device=dev)
        for a in range(0, n, _BLOCK):
            rel = node[a:a + _BLOCK] - off
            act = (rel >= 0) & (rel < width)
            key = ((rel[act][:, None] * dd + cols) * n_bins
                   + B[a:a + _BLOCK][act][:, fidx].long())
            val = stats[:, a:a + _BLOCK][:, act].T.double()
            hist.index_add_(0, key.reshape(-1),
                            val[:, None, :].expand(-1, dd, -1)
                            .reshape(-1, S))
        if follow is None:
            hist = q(hist.float())
        hist = hist.reshape(width, dd, n_bins, S)
        left = q(torch.cumsum(hist, dim=2))
        total = left[:, :, -1:, :]
        gain = q(gain_fn(left, total))
        gain[..., -1] = NEG
        lw = weight_fn(left)
        rw = weight_fn(total) - lw
        ok = (lw >= min_child_weight) & (rw >= min_child_weight)
        gain = torch.where(ok, gain, torch.full_like(gain, NEG))
        flat = gain.reshape(width, dd * n_bins)
        best = torch.argmax(flat, dim=1)
        ids = off + torch.arange(width, device=dev)
        if follow is None:
            split = flat.gather(1, best[:, None])[:, 0] > min_gain
            bf, bt = fidx[best // n_bins], best % n_bins
        else:
            split = follow["internal"][ids]
            bf, bt = follow["feat"][ids], follow["thr"][ids]
            gap = torch.maximum(gap, _choice_gap(
                flat, total[:, 0, 0, :], slot[bf], bt, split, n_bins,
                min_gain, weight_fn, scale_fn))
        feat[ids] = torch.where(split, bf, 0)
        thr[ids] = torch.where(split, bt, 0)
        internal[ids] = split
        for a in range(0, n, _BLOCK):
            nd = node[a:a + _BLOCK]
            rel = nd - off
            act = (rel >= 0) & (rel < width)
            r = rel.clamp(0, width - 1)
            go = act & split[r]
            v = B[a:a + _BLOCK].gather(1, bf[r][:, None])[:, 0].long()
            node[a:a + _BLOCK] = torch.where(go, 2 * nd + 1 + (v > bt[r]),
                                             nd)
    leaf = torch.zeros((M, S), dtype=torch.float64, device=dev)
    leaf.index_add_(0, node, stats.T.double())
    out = {"feat": feat, "thr": thr, "internal": internal,
           "leaf": leaf if follow is not None else q(leaf.float()),
           "node": node}
    if follow is not None:
        if bool((follow["internal"][(1 << max_depth) - 1:]).any()):
            gap = torch.full_like(gap, math.inf)
        out["gap"] = gap
    return out


def _choice_gap(flat, total, slot_f, thr, split, n_bins: int,
                min_gain: float, weight_fn, scale_fn) -> torch.Tensor:
    """The largest distance, over one level's nodes, of the program's
    choice below the reference's best, in units of EPS32 * scale: a
    split's gain below the best, or, where the program stops, the best
    gain above ``min_gain``. A split on a feature the tree may not use,
    at a bin whose children are too light, or at a node with no rows
    reads infinity."""
    best = flat.max(dim=1).values
    unit = EPS32 * scale_fn(total, best).clamp(min=1e-300)
    pos = slot_f.clamp(min=0) * n_bins + thr.clamp(0, n_bins - 1)
    chosen = flat.gather(1, pos[:, None])[:, 0]
    bad = (slot_f < 0) | (thr < 0) | (thr >= n_bins - 1) | (chosen <= NEG / 2)
    on_split = torch.where(
        bad, torch.full_like(best, math.inf),
        torch.maximum(best - chosen, min_gain - chosen).clamp(min=0.0))
    on_stop = (best - min_gain).clamp(min=0.0)
    g = torch.where(split, on_split, on_stop) / unit
    rows = weight_fn(total) > 0
    g = torch.where(rows, g, torch.where(split, math.inf, 0.0))
    return g.max()


def descend(B: torch.Tensor, tree: Dict, max_depth: int) -> torch.Tensor:
    """Every row's leaf: from the root, child 2a+1+(code > thr) while the
    node splits."""
    node = torch.zeros(B.shape[0], dtype=torch.long, device=B.device)
    for _ in range(max_depth):
        go = tree["internal"][node]
        v = B.gather(1, tree["feat"][node][:, None])[:, 0].long()
        node = torch.where(go, 2 * node + 1 + (v > tree["thr"][node]), node)
    return node


def fit_forest(B, y, num_classes: int, *, n_trees: int, max_depth: int,
               n_bins: int, seed: int, mtry=None, q=_identity,
               row_weight=None, grow_trees=None,
               follow: Optional[List[Dict]] = None):
    """dt (one tree on every row, every feature) or rf (Poisson(1)
    bootstrap weights and mtry of the d features a tree). ``row_weight``
    (n,) weighs the rows (a fold's training rows); ``grow_trees`` stops
    after that many of the n_trees trees; ``follow`` (the program's
    trees) judges those instead of growing the reference's own, each
    tree then carrying its ``gap``."""
    n, d = B.shape
    dev = B.device
    base = (y[None, :] == torch.arange(num_classes, device=dev)[:, None]
            ).float()
    if row_weight is not None:
        base = base * row_weight[None, :]
    mtry = mtry or max(1, int(math.sqrt(d)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    trees = []
    for t in range(n_trees if grow_trees is None else grow_trees):
        if n_trees == 1:
            stats = base
            allowed = torch.ones(d, dtype=torch.bool, device=dev)
        else:
            w = torch.poisson(torch.ones((n,), dtype=torch.float32,
                                         device=dev), generator=gen)
            perm = torch.randperm(d, generator=gen, device=dev)
            allowed = torch.zeros(d, dtype=torch.bool, device=dev)
            allowed[perm[:mtry]] = True
            stats = q(base * w[None, :])
        tree = grow(B, stats, allowed, max_depth=max_depth, n_bins=n_bins,
                    gain_fn=gini_gain, weight_fn=lambda s: s.sum(-1),
                    min_child_weight=1.0, min_gain=1e-9, q=q,
                    follow=None if follow is None else follow[t])
        del tree["node"]
        trees.append(tree)
    return trees


def program_trees(params: Dict, kind: str) -> List[Dict]:
    """A saved model's trees (``feat``, ``thr``, ``internal``: one row a
    tree, or for gb one row a round of the binary model) as dicts."""
    feat, thr, internal = (torch.as_tensor(params[k])
                           for k in ("feat", "thr", "internal"))
    if kind == "gb":
        feat, thr, internal = (t.reshape(-1, t.shape[-1])
                               for t in (feat, thr, internal))
    return [{"feat": feat[i], "thr": thr[i], "internal": internal[i]}
            for i in range(feat.shape[0])]


def split_gap(trees: List[Dict]) -> float:
    """The largest ``gap`` of a judged model's trees."""
    return max(float(t["gap"]) for t in trees) if trees else math.inf


def forest_proba(B, trees, max_depth: int, q=_identity) -> torch.Tensor:
    """Mean over the trees of each tree's leaf class shares."""
    acc = None
    for tree in trees:
        counts = tree["leaf"][descend(B, tree, max_depth)]
        p = q(counts / torch.clamp(counts.sum(-1, keepdim=True), min=1e-12))
        acc = p if acc is None else q(acc + p)
    return q(acc / len(trees))


def fit_boosted(B, y, *, n_rounds: int, max_depth: int, n_bins: int,
                step: float = 0.1, lam: float = 1.0, q=_identity,
                follow: Optional[List[Dict]] = None):
    """Binary boosting: each round a Newton tree on the gradient and
    hessian of the logistic loss at the current margin, whose leaf values
    -G/(H + lam) move the margin by ``step``. With ``follow`` (the
    program's rounds) every round is judged, in float64."""
    n, d = B.shape
    dev = B.device
    dtype = torch.float32 if follow is None else torch.float64
    yf = y.to(dtype)
    margin = torch.zeros(n, dtype=dtype, device=dev)
    allowed = torch.ones(d, dtype=torch.bool, device=dev)
    rounds = []
    for r in range(n_rounds):
        p = q(1.0 / (1.0 + torch.exp(-margin)))
        g = q(p - yf)
        h = q(torch.clamp(p * (1 - p), min=1e-6))
        tree = grow(B, torch.stack([g, h]), allowed, max_depth=max_depth,
                    n_bins=n_bins, gain_fn=newton_gain(lam),
                    weight_fn=lambda s: s[..., 1], min_child_weight=1e-3,
                    min_gain=1e-9, q=q,
                    follow=None if follow is None else follow[r],
                    scale_fn=newton_scale(lam))
        tree["value"] = q(-tree["leaf"][:, 0] / (tree["leaf"][:, 1] + lam))
        margin = q(margin + step * tree["value"][tree.pop("node")])
        rounds.append(tree)
    return rounds


def boosted_proba(B, rounds, max_depth: int, step: float = 0.1,
                  q=_identity) -> torch.Tensor:
    margin = None
    for tree in rounds:
        v = tree["value"][descend(B, tree, max_depth)]
        margin = v if margin is None else q(margin + v)
    p1 = q(1.0 / (1.0 + torch.exp(-q(step * margin))))
    return torch.stack([1 - p1, p1], dim=1)
