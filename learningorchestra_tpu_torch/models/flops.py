"""Analytic per-family FLOP and byte counts — the numerators of a fit's
``mfu`` and ``bw_util``.

These formulas count the *algorithmically required* floating-point work
of each trainer's device program (the dominant terms, from the shapes
the modules document), so

    mfu = flops / (device_s * peak_flops)

is a falsifiable utilization figure next to wall-clock. Counts are
analytic on purpose: they price the algorithm, not what the kernels or
PyTorch happened to execute, so wasted work shows up as LOW mfu instead
of inflating the numerator to hide itself.

Conventions: one multiply-add = 2 flops; compare/select passes count 1
flop per element; terms an order of magnitude below the leading one are
dropped. Shapes mirror models/logistic.py, models/trees.py and
models/naive_bayes.py.

The tree families (dt/rf/gb) run the binned-histogram kernels
(ops/tree_kernels.py), and their count prices the *algorithm*: a binned
scatter-add is one accumulate per (row, feature, stat) per level. Tree
fits are memory-bound by design, so their honest utilization figure is
``bw_util`` — modeled device-memory bytes (``fit_bytes``) over device
time against peak bandwidth — with mfu reported beside it. These are
the JAX package's kernel-path formulas (its ``tree_kernel=True``); the
port has no dense one-hot path to price.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from learningorchestra_tpu_torch import config

#: Peak float32 FLOP/s of one NVIDIA H100 SXM outside the tensor cores
#: (NVIDIA's data sheet, dense, at the 700 W power limit): the fits'
#: arithmetic is float32 on the CUDA cores. Override with
#: LO_TPU_PEAK_FLOPS (config.peak_flops) for other cards.
H100_PEAK_FP32 = 67e12

PEAK_FLOPS = config.peak_flops() or H100_PEAK_FP32

#: Peak HBM3 bandwidth of one NVIDIA H100 SXM (3.35 TB/s, the same data
#: sheet) — the denominator of ``bw_util`` for the memory-bound tree
#: fits. Override with LO_TPU_PEAK_BW (config.peak_bw).
H100_HBM_BW = 3.35e12

PEAK_BW = config.peak_bw() or H100_HBM_BW


def _tree_build_flops(n: float, d: float, n_bins: float, max_depth: float,
                      n_stats: float) -> float:
    """One level-wise histogram tree (models/trees.py ``_build_tree``):
    one accumulate per (row, feature, stat) per level (2·n·d·S), the
    n·d·n_bins bin compares, ~5·n routing ops per level, the
    ~6·NL·d·n_bins·S gain evaluation (NL = 2^(max_depth-1) nodes a
    level), and n·S leaf accumulates."""
    NL = 2 ** max(int(max_depth) - 1, 0)
    per_level = (2.0 * n * d * n_stats            # binned scatter-add
                 + n * d * n_bins                 # bin one-hot
                 + 6.0 * NL * d * n_bins * n_stats  # split gains
                 + 5.0 * n)                       # routing
    return max_depth * per_level + 2.0 * n * n_stats


def _tree_build_bytes(n: float, d: float, max_depth: float,
                      n_stats: float) -> float:
    """Modeled device-memory traffic of one tree build: per level the
    histogram pass streams the uint8 bin matrix (n·d), the f32 stats
    (4·n·S) and the int32 rel/active columns (~8·n); the routing pass
    re-streams the bin matrix and reads+writes assignment (~12·n). The
    leaf pass reads stats and assignment once."""
    hist_level = n * (d + 4.0 * n_stats + 8.0)
    route_level = n * (d + 12.0)
    leaf = n * (4.0 * n_stats + 4.0)
    return max_depth * (hist_level + route_level) + leaf


def _binning_flops(n: float, d: float, n_bins: float) -> float:
    """bin_features: an (n, d, n_bins-1) compare+sum."""
    return n * d * (n_bins - 1)


def _descend_flops(n: float, d: float, max_depth: float) -> float:
    """Leaf routing: per depth step, three M-wide table selects and one
    d-wide column select per row."""
    M = 2 ** (int(max_depth) + 1) - 1
    return max_depth * n * (d + 3.0 * M)


def fit_flops(kind: str, n: int, d: int, num_classes: int,
              hparams: Optional[Dict[str, Any]] = None) -> float:
    """Analytic FLOPs of one family's *fit* device program on (n, d)
    rows. ``hparams`` are the request's overrides; defaults mirror the
    trainer signatures (Spark-2.4 parity defaults)."""
    hp = dict(hparams or {})
    n, d, C = float(n), float(d), float(max(num_classes, 2))
    if kind == "lr":
        solver = hp.get("solver", "auto")
        d1 = d + 1
        if solver == "auto":
            solver = "newton" if C * d1 <= 256 else "adam"
        if solver == "newton":
            # Per Newton step: logits 2·n·d1·C, the A-operand n·C·d1,
            # T2 = AᵀA at 2·n·(C·d1)², T1's C blocked d1×d1 products at
            # 2·n·C·d1², gradient 2·n·d1·C; plus the (C·d1)³ solve
            # (negligible at n≫d).
            iters = min(float(hp.get("iters", 300)), 20.0)
            per = (2.0 * n * (C * d1) ** 2 + 2.0 * n * C * d1 ** 2
                   + 5.0 * n * C * d1)
            stats = 4.0 * n * d            # standardisation, two passes
            return iters * per + stats
        iters = float(hp.get("iters", 300))
        # Adam full-batch value and gradient ≈ 3× the forward 2·n·d·C.
        return iters * 6.0 * n * d * C + 4.0 * n * d
    if kind == "nb":
        # One pass: centering 2·n·d, the two (C, n) @ (n, d) moment
        # products 4·n·C·d, one-hot n·C.
        return 4.0 * n * C * d + 3.0 * n * d + n * C
    if kind in ("dt", "rf"):
        n_trees = float(hp.get("n_trees", 1 if kind == "dt" else 20))
        max_depth = float(hp.get("max_depth", 5))
        n_bins = float(hp.get("n_bins", 32))
        return (_binning_flops(n, d, n_bins)
                + n_trees * _tree_build_flops(n, d, n_bins, max_depth,
                                              n_stats=C))
    if kind == "gb":
        n_rounds = float(hp.get("n_rounds", 20))
        max_depth = float(hp.get("max_depth", 5))
        n_bins = float(hp.get("n_bins", 32))
        boosters = C if C > 2 else 1.0     # one-vs-rest above binary
        # Per round: grad/hess stats ~6·n, one tree build (S=2 stats),
        # leaf-value descent + margin update (~_descend + n·M select).
        M = 2 ** (int(max_depth) + 1) - 1
        per_round = (_tree_build_flops(n, d, n_bins, max_depth,
                                       n_stats=2.0)
                     + _descend_flops(n, d, max_depth) + n * M + 6.0 * n)
        return boosters * (n_rounds * per_round) + _binning_flops(n, d,
                                                                  n_bins)
    return 0.0


def predict_flops(kind: str, n: int, d: int, num_classes: int,
                  hparams: Optional[Dict[str, Any]] = None) -> float:
    """Analytic FLOPs of one family's probability pass on (n, d) rows."""
    hp = dict(hparams or {})
    n, d, C = float(n), float(d), float(max(num_classes, 2))
    if kind == "lr":
        return 2.0 * n * d * C + 3.0 * n * d
    if kind == "nb":
        # Two (n, d) @ (d, C) products.
        return 4.0 * n * d * C + 3.0 * n * d
    if kind in ("dt", "rf", "gb"):
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
    return 0.0


def build_flops(kind: str, n_train: int, n_test: int, d: int,
                num_classes: int,
                hparams: Optional[Dict[str, Any]] = None) -> float:
    """Fit + probability pass — the device work one family contributes
    to a model build (models/builder.py fit device phase)."""
    return (fit_flops(kind, n_train, d, num_classes, hparams)
            + predict_flops(kind, n_test, d, num_classes, hparams))


def mfu(flops: float, device_s: float,
        peak_flops: float = 0.0) -> Optional[float]:
    """Achieved fraction of peak: flops / (device_s · peak). None when
    the span is degenerate (failed fit, unmeasured)."""
    peak = peak_flops or PEAK_FLOPS
    if device_s <= 0.0 or peak <= 0.0 or flops <= 0.0:
        return None
    return flops / (device_s * peak)


def fit_bytes(kind: str, n: int, d: int, num_classes: int,
              hparams: Optional[Dict[str, Any]] = None) -> Optional[float]:
    """Modeled device-memory bytes moved by one family's fit — the
    roofline numerator for memory-bound programs. Modeled for the tree
    families only; None elsewhere."""
    if kind not in ("dt", "rf", "gb"):
        return None
    hp = dict(hparams or {})
    n, d, C = float(n), float(d), float(max(num_classes, 2))
    max_depth = float(hp.get("max_depth", 5))
    binning = 5.0 * n * d                      # read f32, write uint8
    if kind in ("dt", "rf"):
        n_trees = float(hp.get("n_trees", 1 if kind == "dt" else 20))
        return binning + n_trees * _tree_build_bytes(
            n, d, max_depth, n_stats=C)
    n_rounds = float(hp.get("n_rounds", 20))
    boosters = C if C > 2 else 1.0
    # Per round: the tree build, full-tree descent (bin matrix + assign),
    # and the margin/grad/hess elementwise passes (~5 f32 row vectors).
    per_round = (_tree_build_bytes(n, d, max_depth, n_stats=2.0)
                 + n * (d + 4.0) + 20.0 * n)
    return binning + boosters * n_rounds * per_round


def bw_util(bytes_moved: Optional[float], device_s: float,
            peak_bw: float = 0.0) -> Optional[float]:
    """Achieved fraction of peak memory bandwidth: bytes / (device_s ·
    peak); None when unmodeled or degenerate."""
    peak = peak_bw or PEAK_BW
    if bytes_moved is None or device_s <= 0.0 or peak <= 0.0 \
            or bytes_moved <= 0.0:
        return None
    return bytes_moved / (device_s * peak)
