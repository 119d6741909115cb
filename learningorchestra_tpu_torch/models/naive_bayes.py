"""Naive Bayes trainer ("nb" in the classifier registry).

The reference's "nb" is ``pyspark.ml.classification.NaiveBayes`` — a
single-pass sufficient-statistics fit (reference model_builder.py:156).
Gaussian naive Bayes by default: per-class masked sums of x and x² as two
matrix products over the design matrix, giving class priors, means and
variances in one pass. Gaussian rather than the reference's multinomial
event model because stored datasets carry signed continuous features;
``event_model="multinomial"`` fits the reference's exact event model
(count likelihood with Laplace smoothing, pyspark's default) and is valid
only for non-negative features, which it checks up front.

On a pod (rows sharded over the data axis) the class counts, the feature
sums and the masked totals are all-reduced over the data axis, as XLA
all-reduces the JAX package's sums over its sharded rows; padding rows
carry zero weight.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from learningorchestra_tpu_torch.models.base import (
    TrainedModel, as_design, ordered_matmul, ordered_softmax)
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, all_gather, all_reduce_)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

_VAR_FLOOR = 1e-6


def _dsum(t, mesh):
    """``t`` summed over the data axis (in place; no-op without one)."""
    if mesh is not None:
        all_reduce_(t, mesh, DATA_AXIS)
    return t


def _class_stats(y, num_classes, valid=None, mesh=None):
    """(onehot_T (C, n), counts (C,), log_prior (C,)); ``valid`` (n,)
    zeroes padding rows, and the counts sum over ``mesh``'s data axis."""
    classes = torch.arange(num_classes, dtype=y.dtype, device=y.device)
    onehot_T = (y[None, :] == classes[:, None]).float()
    if valid is not None:
        onehot_T = onehot_T * valid[None, :]
    counts = _dsum(onehot_T.sum(dim=1), mesh)
    prior = torch.log(torch.clamp(counts, min=1.0)
                      / torch.clamp(counts.sum(), min=1.0))
    return onehot_T, counts, prior


def _fit(X, y, *, num_classes, smoothing, n=None, valid=None, mesh=None):
    onehot_T, counts, prior = _class_stats(y, num_classes, valid, mesh)
    # Center features by their global mean before the moment products:
    # E[x²]−E[x]² cancels catastrophically in float32 for unstandardized
    # large-magnitude features; on centered data both moments are O(var).
    total = max(float(X.shape[0] if n is None else n), 1.0)
    Xm = X if valid is None else X * valid[:, None]
    center = _dsum(Xm.sum(dim=0), mesh) / total      # (d,) global mean
    Xc = X - center[None, :]
    sums = _dsum(onehot_T @ Xc, mesh)                # (C, d)
    sqsums = _dsum(onehot_T @ (Xc * Xc), mesh)       # (C, d)
    denom = torch.clamp(counts, min=1.0)[:, None]
    mean_c = sums / denom
    var = torch.clamp(sqsums / denom - mean_c ** 2, min=_VAR_FLOOR) \
        + smoothing
    return {"mean": mean_c + center[None, :], "var": var,
            "log_prior": prior}


def _predict_proba(params, X):
    mean, var, log_prior = params["mean"], params["var"], params["log_prior"]
    # log N(x; mu, var) summed over features, per class, in expanded
    # quadratic form: Σ_d (x−μ)²/v = x²·(1/v) − 2x·(μ/v) + Σ μ²/v — two
    # (n,d)@(d,C) products instead of an (n, C, d) broadcast, each summed
    # over the features in a fixed order (row-invariant, models/base.py).
    # Shifting x and μ by the across-class mean is exact and keeps x²
    # small.
    c = mean.mean(dim=0)
    Xc = X - c[None, :]
    mu = mean - c[None, :]
    inv_v = (1.0 / var).T                              # (d, C)
    mu_v = (mu / var).T                                # (d, C)
    const = ((mu ** 2 / var) + torch.log(2.0 * math.pi * var)).sum(dim=1)
    quad = (ordered_matmul(Xc * Xc, inv_v)
            - 2.0 * ordered_matmul(Xc, mu_v))          # (n, C)
    loglik = -0.5 * (quad + const[None, :])
    return ordered_softmax(loglik + log_prior[None])


def _fit_multinomial(X, y, *, num_classes, alpha, valid=None, mesh=None):
    """The reference's exact event model: per-class feature-count sums
    with Laplace smoothing (pyspark NaiveBayes' default multinomial)."""
    d = X.shape[1]
    onehot_T, counts, _ = _class_stats(y, num_classes, valid, mesh)
    # Spark smooths the class prior too: pi_c = log((n_c + lambda) /
    # (n + numLabels*lambda)).
    prior = (torch.log(counts + alpha)
             - torch.log(counts.sum() + alpha * num_classes))
    Ncd = _dsum(onehot_T @ X, mesh)                  # (C, d)
    theta = (torch.log(Ncd + alpha)
             - torch.log(Ncd.sum(dim=1, keepdim=True) + alpha * d))
    return {"theta": theta, "log_prior": prior}


def _predict_multinomial(params, X):
    loglik = (ordered_matmul(X, params["theta"].T)
              + params["log_prior"][None])
    return ordered_softmax(loglik)


def fit(runtime: DeviceRuntime, X: np.ndarray, y: np.ndarray,
        num_classes: int, seed: int = 0, *,
        smoothing: Optional[float] = None,
        event_model: str = "gaussian") -> TrainedModel:
    # Per-event-model smoothing defaults: the knob means variance floor
    # for gaussian (1e-3) but Laplace alpha for multinomial, where the
    # reference's pyspark default is lambda = 1.0.
    if smoothing is None:
        smoothing = 1.0 if event_model == "multinomial" else 1e-3
    X = as_design(X)
    X_dev, n = runtime.shard_rows(X)
    y_dev, _ = runtime.shard_rows(np.asarray(y, np.int32))
    valid = runtime.valid_rows(n)
    pod = valid is not None
    mesh = runtime.mesh if pod else None
    if event_model == "multinomial":
        # The check's answer must be every rank's: the smallest value
        # over the data axis (padding rows are zeros).
        lo = X_dev.min() if X_dev.numel() else X_dev.new_zeros(())
        if pod:
            lo = all_gather(lo.reshape(1), mesh, DATA_AXIS, 0).min()
        if X.shape[0] and X.shape[1] and float(lo) < 0.0:
            raise ValueError(
                "multinomial naive Bayes requires non-negative features "
                "(counts); use the default gaussian event model for signed "
                "continuous data")
        params = _fit_multinomial(X_dev, y_dev, num_classes=num_classes,
                                  alpha=float(np.float32(max(smoothing,
                                                             1e-9))),
                                  valid=valid, mesh=mesh)
        predict = _predict_multinomial
    elif event_model == "gaussian":
        params = _fit(X_dev, y_dev, num_classes=num_classes,
                      smoothing=float(np.float32(smoothing)), n=n,
                      valid=valid, mesh=mesh)
        predict = _predict_proba
    else:
        raise ValueError(f"unknown nb event_model {event_model!r}")
    return TrainedModel(kind="nb", params=params,
                        predict_proba_fn=predict,
                        num_classes=num_classes,
                        hparams={"smoothing": smoothing,
                                 "event_model": event_model})
