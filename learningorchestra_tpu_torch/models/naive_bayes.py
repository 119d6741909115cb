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
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from learningorchestra_tpu_torch.models.base import (
    TrainedModel, as_design, ordered_matmul, ordered_softmax)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

_VAR_FLOOR = 1e-6


def _class_stats(y, num_classes):
    """(onehot_T (C, n), counts (C,), log_prior (C,))."""
    classes = torch.arange(num_classes, dtype=y.dtype, device=y.device)
    onehot_T = (y[None, :] == classes[:, None]).float()
    counts = onehot_T.sum(dim=1)
    prior = torch.log(torch.clamp(counts, min=1.0)
                      / torch.clamp(counts.sum(), min=1.0))
    return onehot_T, counts, prior


def _fit(X, y, *, num_classes, smoothing):
    onehot_T, counts, prior = _class_stats(y, num_classes)
    # Center features by their global mean before the moment products:
    # E[x²]−E[x]² cancels catastrophically in float32 for unstandardized
    # large-magnitude features; on centered data both moments are O(var).
    total = max(float(X.shape[0]), 1.0)
    center = X.sum(dim=0) / total                    # (d,) global mean
    Xc = X - center[None, :]
    sums = onehot_T @ Xc                             # (C, d)
    sqsums = onehot_T @ (Xc * Xc)                    # (C, d)
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


def _fit_multinomial(X, y, *, num_classes, alpha):
    """The reference's exact event model: per-class feature-count sums
    with Laplace smoothing (pyspark NaiveBayes' default multinomial)."""
    d = X.shape[1]
    onehot_T, counts, _ = _class_stats(y, num_classes)
    # Spark smooths the class prior too: pi_c = log((n_c + lambda) /
    # (n + numLabels*lambda)).
    prior = (torch.log(counts + alpha)
             - torch.log(counts.sum() + alpha * num_classes))
    Ncd = onehot_T @ X                               # (C, d)
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
    X_dev, _ = runtime.shard_rows(X)
    y_dev, _ = runtime.shard_rows(np.asarray(y, np.int32))
    if event_model == "multinomial":
        if X.shape[0] and X.shape[1] and float(X_dev.min()) < 0.0:
            raise ValueError(
                "multinomial naive Bayes requires non-negative features "
                "(counts); use the default gaussian event model for signed "
                "continuous data")
        params = _fit_multinomial(X_dev, y_dev, num_classes=num_classes,
                                  alpha=float(np.float32(max(smoothing,
                                                             1e-9))))
        predict = _predict_multinomial
    elif event_model == "gaussian":
        params = _fit(X_dev, y_dev, num_classes=num_classes,
                      smoothing=float(np.float32(smoothing)))
        predict = _predict_proba
    else:
        raise ValueError(f"unknown nb event_model {event_model!r}")
    return TrainedModel(kind="nb", params=params,
                        predict_proba_fn=predict,
                        num_classes=num_classes,
                        hparams={"smoothing": smoothing,
                                 "event_model": event_model})
