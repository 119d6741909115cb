"""Tree-ensemble trainers: "dt", "rf", "gb" — histogram-split trees.

The reference fits ``pyspark.ml`` DecisionTreeClassifier,
RandomForestClassifier and GBTClassifier (reference
model_builder.py:153-155). Spark's tree algorithm is histogram-based
(maxBins feature quantization + per-node sufficient statistics), and so is
this one, level by level as in the JAX package
(``learningorchestra_tpu/models/trees.py``):

- Features are quantized once to ``n_bins`` quantile bins (Spark's maxBins).
- A tree grows *level-wise*: every node at a level gets a (node, feature,
  bin, stat) histogram in one pass over the rows (``tree_histogram``),
  split quality for every candidate comes from a cumulative sum over bins,
  the best split is an argmax, and one routing pass
  (``tree_route_level``) moves rows to their children.
- One generic builder serves all three families: classification trees carry
  per-class weight stats (gini criterion); boosted trees carry
  gradient/hessian stats (Newton gain, XGBoost-hist style).

The histogram, leaf-statistics, routing and descent passes are the
hand-written CUDA kernels of ``ops/tree_kernels.py``; everything between
them is a few small tensor ops per level. Node ids, the fixed per-level
width and the split arithmetic follow the JAX package exactly, so a fit
on the same bins and stats gives the same trees.

On a pod (rows sharded over the data axis, parallel/runtime.py) each rank
runs the kernels on its own rows, and the JAX package's psums become
all-reduces: once per level for the histogram, once per tree for the
leaf stats. The histogram kernel sums in fixed point at a scale taken
from the stats' max |value|, so the ranks first agree on one scale (the
max over the data axis), then add their int64 totals and convert once:
dt and gb trees are bit-identical to one rank's, whatever the number of
ranks. Routing and descent need no collective; rf draws its bootstrap
per rank, as the JAX package folds the shard index into its key.

Defaults match Spark 2.4's: maxDepth=5, maxBins=32, numTrees=20 (rf),
maxIter=20 + stepSize=0.1 (gb).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch

from learningorchestra_tpu_torch import jobs
from learningorchestra_tpu_torch.models.base import (
    TrainedModel, as_design, ordered_sigmoid, ordered_sum)
from learningorchestra_tpu_torch.ops import tree_kernels
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, all_gather, all_reduce_)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import fitckpt

NEG = -1e30
#: Rows per block of ``bin_features`` (bounds its (blk, d, n_bins-1)
#: comparison transient).
_BIN_BLOCK = 1 << 18


# ---------------------------------------------------------------------------
# Quantization (Spark's maxBins analogue)
# ---------------------------------------------------------------------------

def quantile_edges(X: np.ndarray, n_bins: int,
                   sample: int = 200_000) -> np.ndarray:
    """Per-feature bin edges from quantiles of a row sample. (d, n_bins-1)."""
    n = len(X)
    if n > sample:
        idx = np.random.default_rng(0).choice(n, sample, replace=False)
        Xs = X[idx]
    else:
        Xs = X
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    edges = np.quantile(Xs, qs, axis=0).T.astype(np.float32)  # (d, n_bins-1)
    return np.ascontiguousarray(edges)


def validate_n_bins(n_bins: int) -> None:
    """Single guard for the uint8 bin-code representation ``bin_features``
    produces — every tree entry point funnels through it."""
    if n_bins > 256:
        raise ValueError("n_bins is capped at 256 (uint8 bin codes)")


def _route_codes(B: torch.Tensor) -> Optional[torch.Tensor]:
    """The routing kernel's feature-major copy of a bin matrix, or of a
    population's (P, n, d) stack of them in one launch, on the card: made
    once and shared by every level of every tree fitted on it; None on
    the CPU, where routing reads B itself."""
    return tree_kernels.feature_major(B) if B.is_cuda else None


def bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """float features → uint8 bin codes: code = #edges strictly below x
    (NaN lands in bin 0, as in the JAX package). Row-blocked compare+sum."""
    n, d = X.shape
    out = torch.empty((n, d), dtype=torch.uint8, device=X.device)
    for i in range(0, n, _BIN_BLOCK):
        out[i:i + _BIN_BLOCK] = (
            X[i:i + _BIN_BLOCK, :, None] > edges[None, :, :]).sum(
            dim=-1, dtype=torch.int32).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# Generic level-wise histogram tree builder
# ---------------------------------------------------------------------------

def _build_trees(B, code_idx, stats_T, feat_gain_mask, *, max_depth,
                 n_bins, gain_fn, weight_fn, min_child_weight, min_gain,
                 codes_T=None, bin_gain_mask=None, level_allow=None,
                 mesh=None):
    """Grow G trees at once, one a slice of the kernels' slice launches.

    B: (P, n, d) uint8 bin matrices; code_idx: G ints, tree g's matrix;
    codes_T: the (P, d, n) feature-major stack on the card (the routing
    kernel's layout, made once per bin matrix). stats_T: (G, S, n)
    float32 per-row sufficient statistics (zero columns for excluded
    rows). feat_gain_mask: (G, d) float32 — 0 allows a feature, NEG
    forbids it (random-forest per-tree feature subsampling). gain_fn(left,
    total) -> gain over the trailing stat dim; weight_fn(stat_sums) ->
    node weight for min_child_weight.

    bin_gain_mask: optional (G, n_bins) — 0 allows a split threshold, NEG
    forbids it; level_allow: optional (G, max_depth) bool — False forbids
    splitting at that level. A population fit (models/tune.py) builds at
    its members' largest n_bins and max_depth and gives each member its
    own with these masks, which reproduce the member's own fit exactly
    (its high bins hold no rows, and forbidden levels leave leaves).

    Each tree's arithmetic is the same whatever G is: every kernel
    slice is bit-identical to a one-slice launch, and the torch ops
    between levels act on each tree's rows alone.

    mesh: the process mesh when B holds this rank's rows of a
    row-sharded design. With a data-axis group, the histogram and leaf
    sums are the kernels' fixed-point totals at a scale shared by every
    rank, all-reduced as integers and converted once — the same floats
    one rank's launch over all the rows gives. Returns (feat (G, M),
    thr (G, M), is_internal (G, M), leaf_stats (G, M, S)) with M =
    2^(max_depth+1) - 1 nodes; children of i at 2i+1 / 2i+2.
    """
    P, n, d = B.shape
    G = len(code_idx)
    dev = B.device
    M = 2 ** (max_depth + 1) - 1
    #: Fixed per-level node width, as in the JAX builder: every level runs
    #: at the deepest level's width 2^(max_depth-1). Slots past a level's
    #: real node count carry zero stats, so their gain is NEG and they
    #: never split; their node-id writes land in ids later levels rewrite.
    NL = 2 ** max(max_depth - 1, 0)
    feat = torch.zeros((G, M), dtype=torch.int32, device=dev)
    thr = torch.zeros((G, M), dtype=torch.int32, device=dev)
    is_internal = torch.zeros((G, M), dtype=torch.bool, device=dev)
    assign = torch.zeros((G, n), dtype=torch.int32, device=dev)
    slots = torch.arange(NL, device=dev)
    # The histogram kernel's fixed-point scales: one pass over the stats,
    # which every level of the tree shares. Across ranks: the largest.
    max_abs = tree_kernels.stat_max_abs(stats_T)
    pod = mesh is not None and mesh.groups[DATA_AXIS] is not None
    if pod:
        max_abs = all_gather(max_abs[None], mesh, DATA_AXIS, 0).amax(0)
    for level in range(max_depth):
        offset = (1 << level) - 1
        rel = assign - offset
        active = (rel >= 0) & (rel < offset + 1)
        rel = torch.where(active, rel, torch.zeros_like(rel))

        # Only the level's offset + 1 nodes hold rows: the histogram
        # accumulates those alone and leaves the other slots 0.
        if pod:
            totals = tree_kernels.tree_histogram_fixed(
                B, code_idx, stats_T, rel, active, n_nodes=NL,
                n_bins=n_bins, max_abs=max_abs, n_live=offset + 1)
            all_reduce_(totals, mesh, DATA_AXIS)
            hist = tree_kernels.fixed_to_float(totals, max_abs)
        else:
            hist = tree_kernels.tree_histogram_slices(
                B, code_idx, stats_T, rel, active, n_nodes=NL,
                n_bins=n_bins, max_abs=max_abs,
                n_live=offset + 1)                           # (G,NL,d,nb,S)
        left = torch.cumsum(hist, dim=3)                         # ≤ bin t
        total = left[:, :, :, -1:, :]                        # (G,NL,d,1,S)
        gain = gain_fn(left, total)                          # (G,NL,d,nb)
        # A split at the last bin sends everything left — forbid it.
        gain[..., -1] = NEG
        lw = weight_fn(left)
        rw = weight_fn(total) - lw
        ok = (lw >= min_child_weight) & (rw >= min_child_weight)
        gain = (torch.where(ok, gain, torch.full_like(gain, NEG))
                + feat_gain_mask[:, None, :, None])
        if bin_gain_mask is not None:
            gain = gain + bin_gain_mask[:, None, None, :]

        flat = gain.reshape(G, NL, d * n_bins)
        best = torch.argmax(flat, dim=2)
        best_gain = flat.gather(2, best[:, :, None])[:, :, 0]
        best_f = (best // n_bins).int()
        best_t = (best % n_bins).int()
        split = best_gain > min_gain
        if level_allow is not None:
            split = split & level_allow[:, level, None]

        node_ids = offset + slots
        feat[:, node_ids] = torch.where(split, best_f, 0).int()
        thr[:, node_ids] = torch.where(split, best_t, 0).int()
        is_internal[:, node_ids] = split

        assign = tree_kernels.tree_route_level_slices(
            B, code_idx, rel.int(), active, assign, best_f, best_t, split,
            codes_T=codes_T)

    # Leaf sufficient statistics over ALL nodes (every row sits at a leaf).
    if pod:
        totals = tree_kernels.tree_leaf_stats_fixed(assign, stats_T,
                                                    n_nodes=M,
                                                    max_abs=max_abs)
        all_reduce_(totals, mesh, DATA_AXIS)
        return feat, thr, is_internal, tree_kernels.fixed_to_float(
            totals, max_abs)
    leaf = tree_kernels.tree_leaf_stats_slices(assign, stats_T, n_nodes=M,
                                               max_abs=max_abs)
    return feat, thr, is_internal, leaf.transpose(1, 2).contiguous()


def _build_tree(B, stats_T, feat_gain_mask, *, codes_T=None, **kw):
    """Grow one tree: ``_build_trees`` with one slice. B (n, d) uint8;
    codes_T ``feature_major(B)`` on the card; stats_T (S, n);
    feat_gain_mask (d,). Returns (feat (M,), thr (M,), is_internal (M,),
    leaf_stats (M, S))."""
    out = _build_trees(B[None], (0,), stats_T[None], feat_gain_mask[None],
                       codes_T=None if codes_T is None else codes_T[None],
                       **kw)
    return tuple(t[0] for t in out)


# ---------------------------------------------------------------------------
# Criteria
# ---------------------------------------------------------------------------

def _gini_gain(left, total):
    """Weighted gini impurity decrease; stats are per-class weights."""
    right = total - left
    lw = left.sum(-1)
    rw = right.sum(-1)
    tw = total.sum(-1)

    def gini_w(counts, w):
        # w * gini = w - sum(c^2)/w
        return w - (counts ** 2).sum(-1) / torch.clamp(w, min=1e-12)

    parent = gini_w(total, tw)
    child = gini_w(left, lw) + gini_w(right, rw)
    return (parent - child) / torch.clamp(tw, min=1e-12)


def _make_newton_gain(lam: float):
    """XGBoost-style gain on [grad, hess] stats."""

    def gain(left, total):
        right = total - left
        gl, hl = left[..., 0], left[..., 1]
        gr, hr = right[..., 0], right[..., 1]
        g, h = total[..., 0], total[..., 1]
        return (gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam)
                - g ** 2 / (h + lam))

    return gain


# ---------------------------------------------------------------------------
# dt / rf  (classification trees, gini)
# ---------------------------------------------------------------------------

def _edge_prep(X, n_bins: int = 32, **_ignored) -> dict:
    """Host-side prep shared by every tree family: per-feature quantile
    bin edges from a row sample. Exposed as the trainers' ``host_prep``
    hook so the pipelined builder runs it outside the device phase —
    overlapping another family's device work. Deterministic (seeded
    sampler). Lazy designs never exist fully on the host: the sample
    comes from strided range reads (quantile sketches over samples are
    the norm for histogram GBTs — the full-matrix path itself subsamples
    to 200k)."""
    validate_n_bins(n_bins)
    X = as_design(X)
    return {"edges": quantile_edges(
        X if isinstance(X, np.ndarray) else X.sample_rows(200_000), n_bins)}


def _forest_batch_shape(n_trees: int):
    """(trees per batch, batch count) — the JAX package's vmapped tree
    batches, kept here as the rf checkpoint boundaries: batch = the
    largest divisor of n_trees ≤ 8, else batches of 8 when n_trees has
    no usable divisor (20 trees: 4 batches of 5)."""
    tb = max((t for t in range(1, min(8, n_trees) + 1)
              if n_trees % t == 0), default=1)
    if tb < 4 and n_trees > 8:
        tb = 8
    nb = -(-n_trees // tb)
    return tb, nb


_TREE_PARAMS = ("feat", "thr", "internal", "leaf")
_GBT_PARAMS = ("feat", "thr", "internal", "leaf_val")


def _host_params(names, stacked) -> dict:
    return {k: t.cpu().numpy() for k, t in zip(names, stacked)}


def _resume(ckpt, unit: str, of: int, ok) -> Optional[tuple]:
    """The checkpoint a segmented fit resumes from: ``(progress, arrays)``
    when ``ok(progress, arrays)`` accepts it (counted and recorded on the
    job), else None — a rejected one is cleared."""
    loaded = ckpt.load()
    if loaded is None:
        return None
    progress, arrays, meta = loaded
    if not ok(progress, arrays):
        ckpt.clear()
        return None
    fitckpt.count_resume()
    jobs.record_job_resume(ckpt.family, {
        unit: int(progress), "of": int(of),
        "mesh_epoch": meta.get("mesh_epoch")})
    return progress, arrays


def _poisson_rows(n, generator, device):
    """Poisson(1) bootstrap weights of n rows."""
    return torch.poisson(torch.ones((n,), dtype=torch.float32,
                                    device=device), generator=generator)


def _feature_draw(d, mtry, generator, device):
    """A tree's feature subset: mtry of the d features, (d,) bool."""
    perm = torch.randperm(d, generator=generator, device=device)
    allowed = torch.zeros((d,), dtype=torch.bool, device=device)
    allowed[perm[:mtry]] = True
    return allowed


def _tree_draw(n, d, mtry, generator, device):
    """One tree's Poisson(1) bootstrap weights (n,) and feature subset
    (d,) bool, drawn on ``device`` from ``generator``."""
    w = _poisson_rows(n, generator, device)
    return w, _feature_draw(d, mtry, generator, device)


def _shard_generator(runtime: DeviceRuntime, seed: int) -> torch.Generator:
    """The bootstrap generator of this rank's rows on a pod: seeded from
    the fit's seed and the rank's index on the data axis."""
    _, k = runtime.data_shards()
    gen = torch.Generator(device=runtime.device)
    gen.manual_seed(int(np.random.SeedSequence(
        [int(seed), int(k)]).generate_state(1)[0]))
    return gen


def _fit_cls_trees(kind, runtime, X, y, num_classes, seed, *, n_trees,
                   max_depth, n_bins, mtry=None, edges=None, weights=None,
                   feature_allowed=None, ckpt=None):
    validate_n_bins(n_bins)
    X = as_design(X)
    if edges is None:
        edges = _edge_prep(X, n_bins)["edges"]
    # One cached host→device copy of X shared with every other family in a
    # multi-classifier build; binning runs on the device.
    X_dev, n = runtime.shard_rows(X)
    B = bin_features(X_dev, runtime.replicate(edges))
    B_T = _route_codes(B)
    y_dev, _ = runtime.shard_rows(np.asarray(y, np.int32))
    d = X.shape[1]
    dev = B.device
    n_local = B.shape[0]
    mesh = runtime.mesh
    classes = torch.arange(num_classes, dtype=torch.int32, device=dev)
    base_stats = (y_dev[None, :] == classes[:, None]).float()    # (C, n)
    valid = runtime.valid_rows(n)
    if valid is not None:
        base_stats = base_stats * valid[None, :]         # padding rows: 0
    mtry = mtry or max(1, int(np.sqrt(d)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    # On a pod the bootstrap draws depend on the shard (the JAX package
    # folds the shard index into its key); the feature subsets stay the
    # ones every rank draws from ``gen``.
    row_gen = _shard_generator(runtime, seed) if valid is not None else None

    tb, nb = _forest_batch_shape(n_trees)

    def one_batch(b):
        """Batch b's trees (``_forest_batch_shape``) grown as the slices
        of one ``_build_trees`` call: the kernels launch once a level for
        the batch, as the JAX package's vmapped tree batch does. Each
        tree's draws come from the generators in the serial order, so
        every tree is the one a one-tree build gives it."""
        if n_trees == 1:
            stats = base_stats[None]
            fmask = torch.zeros((1, d), dtype=torch.float32, device=dev)
        else:
            ts = range(b * tb, min((b + 1) * tb, n_trees))
            stats = torch.empty((len(ts),) + base_stats.shape,
                                dtype=base_stats.dtype, device=dev)
            fmask = torch.empty((len(ts), d), dtype=torch.float32,
                                device=dev)
            for i, t in enumerate(ts):
                if row_gen is None:
                    w, allowed = _tree_draw(n_local, d, mtry, gen, dev)
                else:
                    w = _poisson_rows(n_local, row_gen, dev)
                    allowed = _feature_draw(d, mtry, gen, dev)
                if weights is not None:
                    w, _ = runtime.shard_rows(
                        np.asarray(weights[t], np.float32))
                if feature_allowed is not None:
                    allowed = torch.as_tensor(feature_allowed[t], device=dev)
                torch.mul(base_stats, w[None, :], out=stats[i])
                fmask[i] = torch.where(allowed.bool(), 0.0, NEG)
        return _build_trees(
            B[None], (0,) * len(stats), stats, fmask, max_depth=max_depth,
            n_bins=n_bins, gain_fn=_gini_gain,
            weight_fn=lambda s: s.sum(-1), min_child_weight=1.0,
            min_gain=1e-9, codes_T=None if B_T is None else B_T[None],
            mesh=mesh)

    if ckpt is not None and ckpt.enabled and nb > 1:
        feat, thr, internal, leaf = _run_forest_checkpointed(
            ckpt, one_batch, gen, n_trees, dev)
    else:
        batches = [one_batch(b) for b in range(nb)]
        feat, thr, internal, leaf = (torch.cat(p) for p in zip(*batches))
    params = {"edges": runtime.replicate(edges), "feat": feat, "thr": thr,
              "internal": internal, "leaf": leaf}
    return TrainedModel(
        kind=kind, params=params,
        predict_proba_fn=partial(_forest_proba_static, max_depth=max_depth),
        num_classes=num_classes,
        hparams={"n_trees": n_trees, "max_depth": max_depth,
                 "n_bins": n_bins})


def _run_forest_checkpointed(ckpt, one_batch, gen, n_trees, dev):
    """The forest fitted batch by batch (``_forest_batch_shape``;
    ``one_batch(b)`` grows batch b), with a checkpoint at every batch
    boundary but the last. Every tree draws its bootstrap from the one
    generator, so the checkpoint carries the generator's state beside
    the trees done, and a resume restores it: the resumed trees see the
    draws an uninterrupted fit gives them, and the stacked result is
    bit-identical to it."""
    tb, nb = _forest_batch_shape(n_trees)
    host: dict = {}
    done = 0
    got = _resume(ckpt, "trees", n_trees, lambda p, a: (
        p % tb == 0 and 0 < p < n_trees
        and all(k in a for k in _TREE_PARAMS + ("gen_state",))))
    if got is not None:
        done, arrays = got
        host = {k: arrays[k] for k in _TREE_PARAMS}
        gen.set_state(torch.from_numpy(arrays["gen_state"].copy()))
    for b in range(done // tb, nb):
        seg = _host_params(_TREE_PARAMS, one_batch(b))
        host = ({k: np.concatenate([host[k], seg[k]]) for k in _TREE_PARAMS}
                if host else seg)
        jobs.heartbeat()
        if b + 1 < nb:
            ckpt.save(len(host["feat"]),
                      dict(host, gen_state=gen.get_state().numpy()))
    return tuple(torch.from_numpy(host[k]).to(dev) for k in _TREE_PARAMS)


def _forest_proba_leaves(leaf, assign):
    """Mean over trees of each tree's leaf class shares: leaf (T, M, S)
    stats, assign (T, n) leaf ids → (n, S). Sums over the classes and
    over the trees run in index order (row-invariant, models/base.py);
    the leaf gather is exact."""
    S = leaf.shape[2]
    counts = leaf.gather(1, assign.long()[:, :, None].expand(-1, -1, S))
    total = ordered_sum([counts[:, :, s] for s in range(S)])     # (T, n)
    probs = counts / torch.clamp(total, min=1e-12)[:, :, None]
    return ordered_sum(list(probs)) / probs.shape[0]


def _forest_proba_static(params, X, *, max_depth):
    B = bin_features(X, params["edges"])
    assign = tree_kernels.tree_descend(
        B, params["feat"], params["thr"], params["internal"],
        max_depth=max_depth)                                     # (T, n)
    return _forest_proba_leaves(params["leaf"], assign)


def fit_dt(runtime: DeviceRuntime, X, y, num_classes, seed=0, *,
           max_depth: int = 5, n_bins: int = 32,
           edges=None, ckpt=None) -> TrainedModel:
    return _fit_cls_trees("dt", runtime, X, y, num_classes, seed,
                          n_trees=1, max_depth=max_depth, n_bins=n_bins,
                          edges=edges, ckpt=ckpt)


def fit_rf(runtime: DeviceRuntime, X, y, num_classes, seed=0, *,
           n_trees: int = 20, max_depth: int = 5,
           n_bins: int = 32, mtry: Optional[int] = None,
           edges=None, weights=None, feature_allowed=None,
           ckpt=None) -> TrainedModel:
    """Random forest. Bootstrap weights and feature subsets come from a
    ``torch.Generator`` seeded with ``seed`` (on a pod the bootstrap from
    one seeded with ``seed`` and the rank's data-axis index), unless
    given: ``weights`` (n_trees, n) over all rows and ``feature_allowed``
    (n_trees, d) bool replace the draws (the parity tests feed the JAX
    package's own draws). An
    enabled ``ckpt`` (utils/fitckpt.py) checkpoints at the tree-batch
    boundaries of ``_forest_batch_shape``."""
    return _fit_cls_trees("rf", runtime, X, y, num_classes, seed,
                          n_trees=n_trees, max_depth=max_depth,
                          n_bins=n_bins, mtry=mtry, edges=edges,
                          weights=weights, feature_allowed=feature_allowed,
                          ckpt=ckpt)


fit_dt.host_prep = _edge_prep
fit_rf.host_prep = _edge_prep


# ---------------------------------------------------------------------------
# gb  (gradient-boosted trees, logistic loss — as Spark's GBT)
# ---------------------------------------------------------------------------

def _fit_gbt(B, yf, *, max_depth, n_bins, n_rounds, step_size=0.1,
             lam=1.0, codes_T=None, margin=None, valid=None, mesh=None):
    """Binary boosting: per round, a Newton tree on the logistic loss's
    gradient/hessian, then the margin moves by the new tree's leaf values
    (``tree_descend`` finds every row's leaf). codes_T as for
    ``_build_tree``; ``margin`` the carry of earlier rounds (zeros when
    None). On a pod B holds this rank's rows: ``valid`` masks its padding
    rows out of the stats and ``mesh`` sums the trees' stats over the
    data axis. Returns stacked per-round (feat, thr, internal, leaf_val)
    and the margin after the last round."""
    gain_fn = _make_newton_gain(lam)
    n, d = B.shape
    if margin is None:
        margin = torch.zeros((n,), dtype=torch.float32, device=B.device)
    zero_mask = torch.zeros((d,), dtype=torch.float32, device=B.device)
    rounds = []
    for _ in range(n_rounds):
        # Element by element (row-invariant, models/base.py): a row's
        # gradient must not depend on where its shard starts.
        p = ordered_sigmoid(margin)
        g = p - yf                                  # d loss / d margin
        h = torch.clamp(p * (1 - p), min=1e-6)
        if valid is not None:
            g, h = g * valid, h * valid
        stats = torch.stack([g, h], dim=0)          # (2, n)
        feat, thr, internal, leaf = _build_tree(
            B, stats, zero_mask, max_depth=max_depth, n_bins=n_bins,
            gain_fn=gain_fn, weight_fn=lambda s: s[..., 1],
            min_child_weight=1e-3, min_gain=1e-9, codes_T=codes_T,
            mesh=mesh)
        leaf_val = -leaf[:, 0] / (leaf[:, 1] + lam)       # (M,)
        assign = tree_kernels.tree_descend(B, feat, thr, internal,
                                           max_depth=max_depth)
        margin = _margin_step(margin, step_size, leaf_val, assign)
        rounds.append((feat, thr, internal, leaf_val))
    return tuple(torch.stack(p) for p in zip(*rounds)), margin


def _margin_step(margin, step_size, leaf_val, assign):
    """One round's margin update — shared by the fit and the resume's
    replay, so both do the same float operations."""
    return margin + step_size * leaf_val[assign.long()]


def _gbt_replay_margin(B, feat, thr, internal, leaf_val, *, max_depth,
                       step_size):
    """The margin after the rounds of a checkpoint, rebuilt from its
    trees: one descent launch walks every saved tree (descent is integer
    arithmetic, the same leaves as each round's own walk), then the
    rounds' updates fold in their order, as ``_fit_gbt`` made them — so
    the resumed margin is bit-identical to the interrupted fit's carry.
    The histogram builds, which dominate a round, never run again."""
    assign = tree_kernels.tree_descend(B, feat, thr, internal,
                                       max_depth=max_depth)       # (R, n)
    margin = torch.zeros((B.shape[0],), dtype=torch.float32,
                         device=B.device)
    for r in range(feat.shape[0]):
        margin = _margin_step(margin, step_size, leaf_val[r], assign[r])
    return margin


def _run_gbt_checkpointed(ckpt, B, yf, *, n_rounds, **kw):
    """gb fitted ``ckpt.every`` rounds at a time with a checkpoint after
    every segment but the last. The margin stays on the device between
    segments; on resume it is replayed from the saved trees
    (``_gbt_replay_margin``), so the continued fit is bit-identical to
    an uninterrupted one. Returns the stacked per-round tree params."""
    host: dict = {}
    done = 0
    margin = None
    got = _resume(ckpt, "rounds", n_rounds, lambda p, a: (
        0 < p <= n_rounds and all(k in a for k in _GBT_PARAMS)))
    if got is not None:
        done, arrays = got
        host = {k: arrays[k] for k in _GBT_PARAMS}
        saved = [torch.from_numpy(host[k]).to(B.device) for k in _GBT_PARAMS]
        margin = _gbt_replay_margin(
            B, *saved, max_depth=kw["max_depth"],
            step_size=kw["step_size"])
    every = max(1, int(ckpt.every))
    while done < n_rounds:
        k = min(every, n_rounds - done)
        trees, margin = _fit_gbt(B, yf, n_rounds=k, margin=margin, **kw)
        seg = _host_params(_GBT_PARAMS, trees)
        host = ({kk: np.concatenate([host[kk], seg[kk]]) for kk in _GBT_PARAMS}
                if host else seg)
        done += k
        jobs.heartbeat()
        if done < n_rounds:
            ckpt.save(done, host)
    return tuple(torch.from_numpy(host[k]).to(B.device) for k in _GBT_PARAMS)


def _gbt_proba_leaves(leaf_val, step_size, assign):
    """Binary booster probabilities from its rounds' leaf values (R, M),
    its step size and the rows' leaf ids (R, n) → (n, 2)."""
    vals = leaf_val.gather(1, assign.long())                     # (R, n)
    # Rounds summed in order (row-invariant, models/base.py).
    margin = step_size * ordered_sum(list(vals))
    p1 = ordered_sigmoid(margin)
    return torch.stack([1 - p1, p1], dim=1)


def _gbt_proba_static(params, X, *, max_depth):
    B = bin_features(X, params["edges"])
    # One descent launch for all rounds of the booster.
    assign = tree_kernels.tree_descend(
        B, params["feat"], params["thr"], params["internal"],
        max_depth=max_depth)                                     # (R, n)
    return _gbt_proba_leaves(params["leaf_val"], params["step_size"], assign)


def _gbt_ovr_proba_static(params, X, *, max_depth):
    """Multiclass gb probabilities: per-class booster margins (leading
    class axis on every tree param), class scores p_k = σ(margin_k),
    normalized — standard one-vs-rest calibration."""
    B = bin_features(X, params["edges"])
    C, R, M = params["feat"].shape
    flat = [params[k].reshape(C * R, M)
            for k in ("feat", "thr", "internal", "leaf_val")]
    assign = tree_kernels.tree_descend(B, flat[0], flat[1], flat[2],
                                       max_depth=max_depth).long()
    vals = flat[3].gather(1, assign).reshape(C, R, -1)           # (C, R, n)
    # Rounds, then classes, summed in order (row-invariant).
    margins = ordered_sum([vals[:, r] for r in range(R)])       # (C, n)
    p = ordered_sigmoid(params["step_size"] * margins).T         # (n, C)
    total = ordered_sum([p[:, c] for c in range(C)])
    return p / torch.clamp(total, min=1e-12)[:, None]


def fit_gb(runtime: DeviceRuntime, X, y, num_classes, seed=0, *,
           n_rounds: int = 20, max_depth: int = 5, n_bins: int = 32,
           step_size: float = 0.1, edges=None, ckpt=None) -> TrainedModel:
    """Gradient-boosted trees. Binary is the reference-parity path (one
    booster, Spark 2.4's GBTClassifier). ``num_classes > 2`` fits one
    booster per class on labels ``y == k`` over the same bins, and
    normalizes the sigmoid scores (one-vs-rest). An enabled ``ckpt``
    (utils/fitckpt.py) checkpoints a binary fit every ``ckpt.every``
    rounds; the one-vs-rest loop runs unsegmented."""
    validate_n_bins(n_bins)
    X = as_design(X)
    if edges is None:
        edges = _edge_prep(X, n_bins)["edges"]
    X_dev, n = runtime.shard_rows(X)
    B = bin_features(X_dev, runtime.replicate(edges))
    y_dev, _ = runtime.shard_rows(np.asarray(y, np.int32))
    hparams = {"n_rounds": n_rounds, "max_depth": max_depth,
               "n_bins": n_bins, "step_size": step_size}
    kw = dict(max_depth=max_depth, n_bins=n_bins, step_size=step_size,
              codes_T=_route_codes(B), valid=runtime.valid_rows(n),
              mesh=runtime.mesh)
    step = torch.tensor(step_size, dtype=torch.float32, device=B.device)
    if num_classes == 2:
        if ckpt is not None and ckpt.enabled and n_rounds > 1:
            feat, thr, internal, leaf_val = _run_gbt_checkpointed(
                ckpt, B, y_dev.float(), n_rounds=n_rounds, **kw)
        else:
            (feat, thr, internal, leaf_val), _ = _fit_gbt(
                B, y_dev.float(), n_rounds=n_rounds, **kw)
        params = {"edges": runtime.replicate(edges), "feat": feat,
                  "thr": thr, "internal": internal, "leaf_val": leaf_val,
                  "step_size": step}
        return TrainedModel(
            kind="gb", params=params,
            predict_proba_fn=partial(_gbt_proba_static,
                                     max_depth=max_depth),
            num_classes=2, hparams=hparams)
    per_class = [_fit_gbt(B, (y_dev == k).float(), n_rounds=n_rounds, **kw)[0]
                 for k in range(num_classes)]
    feat, thr, internal, leaf_val = (
        torch.stack([pc[i] for pc in per_class]) for i in range(4))
    params = {"edges": runtime.replicate(edges), "feat": feat, "thr": thr,
              "internal": internal, "leaf_val": leaf_val, "step_size": step}
    return TrainedModel(
        kind="gb", params=params,
        predict_proba_fn=partial(_gbt_ovr_proba_static,
                                 max_depth=max_depth),
        num_classes=num_classes,
        hparams=dict(hparams, ovr_classes=num_classes))


fit_gb.host_prep = _edge_prep


# ---------------------------------------------------------------------------
# Config-population programs (models/tune.py)
#
# A population of same-family configs, each fitted on every fold, grows
# its trees together: tree t of every live member is one slice of the
# same kernel launches (``_build_trees``). Static shapes are the
# population's maxima (max_depth, n_bins); a member's smaller depth and
# bin count ride as ``level_allow``/``bin_gain_mask``, which reproduce
# the member's own fit exactly. Per-member row weights carry k-fold
# membership (fold masks over the one resident design, never copies).
# Members that share n_bins share one bin matrix. A dropped member, or a
# gb member past its own rounds, grows nothing: its slots stay inert
# (zero trees score nothing), as the JAX package's zeroed weights make
# them.
# ---------------------------------------------------------------------------

#: Rows a population scoring pass descends at a time (bounds its
#: (members, trees, rows) leaf ids).
_SCORE_ROWS = 1 << 19


def _bin_features_pop(X, edges_pop):
    """Bin matrices for a population: (n, d) features × (P, d,
    n_bins_max - 1) edge stacks, each padded with +inf past its own
    n_bins - 1 edges → (P, n, d) uint8. ``x > inf`` is never true, so a
    padded stack gives the codes its own shorter edge list gives."""
    n, d = X.shape
    out = torch.empty((len(edges_pop), n, d), dtype=torch.uint8,
                      device=X.device)
    for p, e in enumerate(edges_pop):
        out[p] = bin_features(X, e)
    return out


def _fit_forest_pop_batch(B, code_idx, y, w_pop, draws, bin_mask,
                          level_allow, *, num_classes, max_depth, n_bins,
                          codes_T=None):
    """One batch of trees for the live members of a dt/rf population, in
    one ``_build_trees`` call whose G · T slices are each member's T
    trees (member-major; a slice reads its member's matrix). B (P, n, d)
    with member m on matrix code_idx[m]; w_pop (G, n) row weights (fold
    membership); draws: per tree, (boot, fmask (G, d)) with boot None
    for dt, else G (n,) Poisson weights, one a member (a config's folds
    share one tensor); bin_mask (G, n_bins), level_allow (G, max_depth).
    Stats are the serial fit's: class one-hot × row weights × bootstrap.
    Returns (feat, thr, internal, leaf) with a (G, T) leading shape."""
    G, T = len(code_idx), len(draws)
    classes = torch.arange(num_classes, dtype=y.dtype, device=y.device)
    base = ((y[None, None, :] == classes[None, :, None]).float()
            * w_pop[:, None, :])                                 # (G, C, n)
    if draws[0][0] is None:
        stats = base
    else:
        stats = torch.empty((G, T) + base.shape[1:], dtype=base.dtype,
                            device=base.device)
        for t, (boot, _) in enumerate(draws):
            for m in range(G):
                torch.mul(base[m], boot[m][None, :], out=stats[m, t])
        stats = stats.reshape((G * T,) + base.shape[1:])
    fmask = torch.stack([f for _, f in draws], dim=1).reshape(G * T, -1)
    out = _build_trees(
        B, [i for i in code_idx for _ in range(T)], stats, fmask,
        max_depth=max_depth, n_bins=n_bins, gain_fn=_gini_gain,
        weight_fn=lambda s: s.sum(-1), min_child_weight=1.0,
        min_gain=1e-9, codes_T=codes_T,
        bin_gain_mask=bin_mask.repeat_interleave(T, dim=0),
        level_allow=level_allow.repeat_interleave(T, dim=0))
    return tuple(p.reshape((G, T) + p.shape[1:]) for p in out)


def _pop_accuracy(B, code_idx, y, ew_pop, tables, max_depth, proba):
    """Per-member accuracy on per-member (eval-fold) row weights: the
    members' trees descend their own bin matrices in one slice launch per
    block of rows, and ``proba(m, assign)`` gives member m's
    probabilities from its (T, rows) leaf ids — the family's own predict
    arithmetic, so a member's predictions are its serial fit's.
    Returns (G,) float64 host values."""
    n = B.shape[1]
    G = len(code_idx)
    hits = torch.zeros((G,), dtype=torch.float64, device=B.device)
    for a in range(0, n, _SCORE_ROWS):
        b = min(n, a + _SCORE_ROWS)
        assign = tree_kernels.tree_descend_slices(
            B[:, a:b], code_idx, *tables, max_depth=max_depth)   # (G, T, r)
        for m in range(G):
            pred = torch.argmax(proba(m, assign[m]), dim=1)
            hits[m] += ((pred == y[a:b]).double() * ew_pop[m, a:b]).sum()
    tot = ew_pop.double().sum(dim=1)
    return (hits / torch.clamp(tot, min=1.0)).cpu().numpy()


def _forest_pop_scores(B, code_idx, y, ew_pop, feat, thr, internal, leaf, *,
                       max_depth):
    """Per-member forest accuracy. Tree arrays arrive at the full (G,
    n_trees, ...) shape with all-zero slots for trees not built yet (zero
    leaf counts, no probability mass), and the mean divides by n_trees,
    as the serial forest's does once every tree is built."""
    return _pop_accuracy(
        B, code_idx, y, ew_pop, (feat, thr, internal), max_depth,
        lambda m, assign: _forest_proba_leaves(leaf[m], assign))


def _fit_gbt_pop_seg(B, code_idx, y, w_pop, margin, step_sizes,
                     round_active, bin_mask, level_allow, *, max_depth,
                     n_bins, n_rounds, codes_T=None):
    """One segment of boost rounds for a gb population. Per round, the
    members whose ``round_active`` (G, n_rounds) entry is set grow one
    tree each in one ``_build_trees`` call and descend it in one slice
    launch; the others keep their margin and get an inert round (zero
    leaf values). The round's arithmetic is the serial fit's (lam = 1.0)
    on per-member row weights w_pop (G, n) and step sizes (G,). Returns
    the segment's (feat, thr, internal, leaf_val) with a (G, n_rounds)
    leading shape, and the margins (G, n)."""
    G, n = margin.shape
    d = B.shape[2]
    M = 2 ** (max_depth + 1) - 1
    dev = B.device
    gain_fn = _make_newton_gain(1.0)
    yf = y.float()
    feat = torch.zeros((G, n_rounds, M), dtype=torch.int32, device=dev)
    thr = torch.zeros_like(feat)
    internal = torch.zeros((G, n_rounds, M), dtype=torch.bool, device=dev)
    leaf_val = torch.zeros((G, n_rounds, M), dtype=torch.float32,
                           device=dev)
    ractive = round_active.bool().cpu().numpy()
    for r in range(n_rounds):
        live = [m for m in range(G) if ractive[m, r]]
        if not live:
            continue
        rows = torch.tensor(live, device=dev)
        p = ordered_sigmoid(margin[rows])
        w = w_pop[rows]
        g = (p - yf) * w
        h = torch.clamp(p * (1 - p), min=1e-6) * w
        stats = torch.stack([g, h], dim=1)                       # (L, 2, n)
        f, t, it, leaf = _build_trees(
            B, [code_idx[m] for m in live], stats,
            torch.zeros((len(live), d), dtype=torch.float32, device=dev),
            max_depth=max_depth, n_bins=n_bins, gain_fn=gain_fn,
            weight_fn=lambda s: s[..., 1], min_child_weight=1e-3,
            min_gain=1e-9, codes_T=codes_T, bin_gain_mask=bin_mask[rows],
            level_allow=level_allow[rows])
        lv = -leaf[:, :, 0] / (leaf[:, :, 1] + 1.0)              # (L, M)
        assign = tree_kernels.tree_descend_slices(
            B, [code_idx[m] for m in live], f[:, None], t[:, None],
            it[:, None], max_depth=max_depth)[:, 0]              # (L, n)
        margin[rows] = (margin[rows] + step_sizes[rows][:, None]
                        * lv.gather(1, assign.long()))
        feat[rows, r], thr[rows, r] = f, t
        internal[rows, r], leaf_val[rows, r] = it, lv
    return (feat, thr, internal, leaf_val), margin


def _gbt_pop_replay_margin(B, code_idx, feat, thr, internal, leaf_val,
                           step_sizes, *, max_depth):
    """Per-member margins rebuilt from a checkpoint's population trees —
    the resume path's analogue of ``_gbt_replay_margin``: every member's
    rounds descend in one slice launch, and the rounds' updates fold in
    order, as ``_fit_gbt_pop_seg`` made them (inert rounds add zero)."""
    G, R = feat.shape[:2]
    assign = tree_kernels.tree_descend_slices(
        B, code_idx, feat, thr, internal, max_depth=max_depth)   # (G, R, n)
    margin = torch.zeros((G, B.shape[1]), dtype=torch.float32,
                         device=B.device)
    for r in range(R):
        margin = margin + step_sizes[:, None] * leaf_val[:, r].gather(
            1, assign[:, r].long())
    return margin


def _gbt_pop_scores(B, code_idx, y, ew_pop, feat, thr, internal, leaf_val,
                    step_sizes, *, max_depth):
    """Per-member binary-gb accuracy. Unbuilt and inert rounds carry zero
    leaf values, so a member's margin is its own rounds' sum."""
    return _pop_accuracy(
        B, code_idx, y, ew_pop, (feat, thr, internal), max_depth,
        lambda m, assign: _gbt_proba_leaves(leaf_val[m], step_sizes[m],
                                            assign))
