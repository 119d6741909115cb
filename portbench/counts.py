"""The yardstick's arithmetic: the card's peaks, the least time a piece
of work can take on it, and the work each piece needs.

Peaks are one NVIDIA H100 SXM's published dense rates at its 700 W
limit. A bound is the larger of needed bytes over the bandwidth and
needed operations over the float32 rate. Needed work is counted from a
problem's shape alone, each input byte once and each output byte once,
whatever an implementation reads again, so the count is the same
whatever implements the work.

The per-family counts are a copy of the port's analytic model
(``models/flops.py``: fit and probability pass of each family, the
trees' kernel-path formulas); the kernel counts follow the recounted
bounds of the port's kernel table (K1's codes once per bin matrix, K3's
descent by the least a walk reads, K4 17 operations a valid unordered
pair).
"""

from __future__ import annotations

from typing import Dict, Optional

PEAK_FP32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12

#: Operations a valid unordered pair costs the t-SNE repulsion (the
#: kernel table's recount: distance, q, q², Z and two force terms).
TSNE_OPS_PER_PAIR = 17
#: Operations an attraction edge costs a descent step (difference,
#: squared distance, q, weight and the two force terms).
TSNE_OPS_PER_EDGE = 10


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The least seconds the card needs for ``nbytes`` and ``ops``."""
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_OPS)


# -- kernels ------------------------------------------------------------------

def hist_work(G: int, n: int, d: int, n_bins: int, S: int, n_nodes: int,
              active_rows: float, matrix_rows: float,
              out_bytes: int = 4) -> tuple:
    """K1 (histogram, slice form): flags and node ids of every row and
    slice, stats of the active rows, codes once per bin matrix (the rows
    active in any of its slices), the (G, nodes, d, bins, S) output.
    ``active_rows`` sums over the slices; ``matrix_rows`` over the
    matrices. Returns (bytes, operations)."""
    nbytes = (G * 5 * n + active_rows * 4 * S + matrix_rows * d
              + G * out_bytes * n_nodes * d * n_bins * S)
    return nbytes, active_rows * d * S


def leaf_work(G: int, n: int, S: int, n_nodes: int,
              out_bytes: int = 4) -> tuple:
    """K1's leaf form: every row's node id and stats, the (G, nodes, S)
    output."""
    return G * n * (4 + 4 * S) + G * out_bytes * n_nodes * S, G * n * S


def route_work(G: int, n: int, n_nodes: int, moving_rows: float) -> tuple:
    """K2: node id, flag and node id out of every row and slice, a code
    byte per row that moves (active, at a node that splits), the level
    tables."""
    return G * 13 * n + moving_rows + G * 9 * n_nodes, 0.0


def feature_major_work(P: int, n: int, d: int) -> tuple:
    """The feature-major copy: each code byte read once, written once."""
    return 2 * P * n * d, 0.0


def descend_work(G: int, T: int, n: int, P: int, M: int) -> tuple:
    """K3: a leaf id out of every row, tree and slice, the tree tables,
    and of the codes the least any walk reads: one byte of each row of a
    bin matrix (the features a row's path reads depend on the data, so
    this count stays below the path bytes)."""
    return 4 * G * T * n + 12 * G * T * M + P * n, 0.0


def repulsion_work(n: int, n_valid: float) -> tuple:
    """K4: Y and the valid flags read once, forces and Z written once; 17
    operations a valid unordered pair."""
    return 20 * n + 4, TSNE_OPS_PER_PAIR * n_valid * (n_valid - 1) / 2


# -- whole steps --------------------------------------------------------------

def _tree_build_flops(n, d, n_bins, max_depth, n_stats):
    NL = 2 ** max(int(max_depth) - 1, 0)
    per_level = (2.0 * n * d * n_stats + n * d * n_bins
                 + 6.0 * NL * d * n_bins * n_stats + 5.0 * n)
    return max_depth * per_level + 2.0 * n * n_stats


def _tree_build_bytes(n, d, max_depth, n_stats):
    hist_level = n * (d + 4.0 * n_stats + 8.0)
    route_level = n * (d + 12.0)
    leaf = n * (4.0 * n_stats + 4.0)
    return max_depth * (hist_level + route_level) + leaf


def _binning_flops(n, d, n_bins):
    return n * d * (n_bins - 1)


def _descend_flops(n, d, max_depth):
    M = 2 ** (int(max_depth) + 1) - 1
    return max_depth * n * (d + 3.0 * M)


def fit_flops(kind: str, n: int, d: int, num_classes: int,
              hp: Optional[Dict] = None) -> float:
    hp = dict(hp or {})
    n, d, C = float(n), float(d), float(max(num_classes, 2))
    if kind == "lr":
        d1 = d + 1
        solver = hp.get("solver", "auto")
        if solver == "auto":
            solver = "newton" if C * d1 <= 256 else "adam"
        if solver == "newton":
            iters = min(float(hp.get("iters", 300)), 20.0)
            per = (2.0 * n * (C * d1) ** 2 + 2.0 * n * C * d1 ** 2
                   + 5.0 * n * C * d1)
            return iters * per + 4.0 * n * d
        return float(hp.get("iters", 300)) * 6.0 * n * d * C + 4.0 * n * d
    if kind == "nb":
        return 4.0 * n * C * d + 3.0 * n * d + n * C
    if kind in ("dt", "rf"):
        n_trees = float(hp.get("n_trees", 1 if kind == "dt" else 20))
        max_depth = float(hp.get("max_depth", 5))
        n_bins = float(hp.get("n_bins", 32))
        return (_binning_flops(n, d, n_bins)
                + n_trees * _tree_build_flops(n, d, n_bins, max_depth, C))
    if kind == "gb":
        n_rounds = float(hp.get("n_rounds", 20))
        max_depth = float(hp.get("max_depth", 5))
        n_bins = float(hp.get("n_bins", 32))
        boosters = C if C > 2 else 1.0
        M = 2 ** (int(max_depth) + 1) - 1
        per_round = (_tree_build_flops(n, d, n_bins, max_depth, 2.0)
                     + _descend_flops(n, d, max_depth) + n * M + 6.0 * n)
        return boosters * n_rounds * per_round + _binning_flops(n, d, n_bins)
    raise ValueError(f"no count for family {kind!r}")


def fit_bytes(kind: str, n: int, d: int, num_classes: int,
              hp: Optional[Dict] = None) -> float:
    """Modeled bytes of a tree family's fit; 0 for lr and nb, whose fits
    the model prices by operations alone."""
    if kind not in ("dt", "rf", "gb"):
        return 0.0
    hp = dict(hp or {})
    n, d, C = float(n), float(d), float(max(num_classes, 2))
    max_depth = float(hp.get("max_depth", 5))
    binning = 5.0 * n * d
    if kind in ("dt", "rf"):
        n_trees = float(hp.get("n_trees", 1 if kind == "dt" else 20))
        return binning + n_trees * _tree_build_bytes(n, d, max_depth, C)
    n_rounds = float(hp.get("n_rounds", 20))
    boosters = C if C > 2 else 1.0
    per_round = (_tree_build_bytes(n, d, max_depth, 2.0) + n * (d + 4.0)
                 + 20.0 * n)
    return binning + boosters * n_rounds * per_round


def predict_flops(kind: str, n: int, d: int, num_classes: int,
                  hp: Optional[Dict] = None) -> float:
    hp = dict(hp or {})
    n, d, C = float(n), float(d), float(max(num_classes, 2))
    if kind == "lr":
        return 2.0 * n * d * C + 3.0 * n * d
    if kind == "nb":
        return 4.0 * n * d * C + 3.0 * n * d
    n_bins = float(hp.get("n_bins", 32))
    max_depth = float(hp.get("max_depth", 5))
    if kind == "gb":
        trees = float(hp.get("n_rounds", 20)) * (C if C > 2 else 1.0)
        leaf_cols = 1.0
    else:
        trees = float(hp.get("n_trees", 1 if kind == "dt" else 20))
        leaf_cols = C
    M = 2 ** (int(max_depth) + 1) - 1
    return (_binning_flops(n, d, n_bins)
            + trees * (_descend_flops(n, d, max_depth)
                       + 2.0 * n * M * leaf_cols))


def build_bound_s(families, n_train: int, n_test: int, d: int,
                  num_classes: int, hparams: Optional[Dict] = None) -> float:
    """One build's needed work as roofline seconds: each family's fit and
    probability pass, bounded by its operations or its modeled bytes."""
    hparams = hparams or {}
    total = 0.0
    for kind in families:
        hp = hparams.get(kind)
        ops = (fit_flops(kind, n_train, d, num_classes, hp)
               + predict_flops(kind, n_test, d, num_classes, hp))
        total += bound_s(fit_bytes(kind, n_train, d, num_classes, hp), ops)
    return total


def tsne_bound_s(n_valid: int, edges: int, iters: int) -> float:
    """One t-SNE descent's needed work as roofline seconds: every step's
    repulsion over the valid unordered pairs and attraction over the
    edge table's entries."""
    pairs = n_valid * (n_valid - 1) / 2
    ops = iters * (TSNE_OPS_PER_PAIR * pairs + TSNE_OPS_PER_EDGE * edges)
    nbytes = iters * (8.0 * edges + 20.0 * n_valid)
    return bound_s(nbytes, ops)
