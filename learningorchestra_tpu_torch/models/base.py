"""Trainer interface shared by all classifier families.

The reference's model zoo is the pyspark.ml switcher
``{lr, dt, rf, gb, nb}`` (reference model_builder.py:152-158): each entry
fits on a Spark DataFrame of assembled feature vectors and transforms the
test set into prediction + probability columns. Here a trainer is a function
``fit(runtime, X, y, num_classes, seed, **hparams) -> TrainedModel`` over
tensors on the runtime's device; parameters are a flat dict of tensors, so
a model saves as one npz and predicts on any device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import numpy as np
import torch

from learningorchestra_tpu_torch.parallel.runtime import (
    DeviceRuntime, host_rows)


def as_design(X):
    """Normalize a trainer's X input: lazy designs (ChunkedDesign
    protocol, recognized by ``.rows``) pass through untouched — calling
    ``np.asarray`` on one would materialize the full matrix; anything
    else becomes a float32 ndarray."""
    if hasattr(X, "rows") and not isinstance(X, np.ndarray):
        return X
    return np.asarray(X, np.float32)


# ---------------------------------------------------------------------------
# Row-invariant arithmetic for the predict functions
# ---------------------------------------------------------------------------
# A row's probabilities must be the same bytes whatever batch it arrives
# in: alone, padded into an online bucket, or among 100k rows of a batch
# predict. Reductions do not promise that — cuBLAS and the CPU's GEMM,
# and CUDA's reduction kernels, split the work by the shape — so the
# predict functions reduce with these: a fixed-order chain of elementwise
# operations over the reduced axis, whose arithmetic on one element is the
# same whatever the other dimensions are. Each multiply and add is its own
# operation (no fused multiply-add, which a CPU may use for some elements
# only). Transcendentals are ``torch.exp`` alone (``torch.sigmoid`` is
# not the same on every element on the CPU).

def ordered_sum(parts):
    """Sum of a sequence of same-shaped tensors, in index order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def ordered_matmul(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """X (n, d) @ W (d, C), accumulated over d in index order (one term
    held at a time, so a wide C costs two (n, C) tensors)."""
    acc = X[:, 0:1] * W[0][None, :]
    for j in range(1, W.shape[0]):
        acc = acc + X[:, j:j + 1] * W[j][None, :]
    return acc


def ordered_softmax(L: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of L (n, C): max, exp, sum and divide,
    over the classes in index order."""
    C = L.shape[1]
    m = L[:, 0]
    for c in range(1, C):
        m = torch.maximum(m, L[:, c])
    e = torch.exp(L - m[:, None])
    return e / ordered_sum([e[:, c] for c in range(C)])[:, None]


def ordered_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), element by element."""
    return 1.0 / (1.0 + torch.exp(-x))


@dataclass
class TrainedModel:
    """A fitted classifier: a dict of parameter tensors + its probability
    function ``predict_proba_fn(params, X_dev) -> (n, C)``."""

    kind: str
    params: Dict[str, Any]
    predict_proba_fn: Callable
    num_classes: int
    hparams: Dict[str, Any] = field(default_factory=dict)

    #: Rows per device predict call — bounds transient device memory on
    #: huge test sets.
    PREDICT_CHUNK = 2_000_000

    def predict_proba(self, runtime: DeviceRuntime,
                      X: np.ndarray) -> np.ndarray:
        X = as_design(X)
        params = {k: runtime.replicate(v) for k, v in self.params.items()}
        if len(X) <= self.PREDICT_CHUNK:
            X_dev, n = runtime.shard_rows(X)
            return host_rows(self.predict_proba_fn(params, X_dev))[:n]
        outs = []
        for i in range(0, len(X), self.PREDICT_CHUNK):
            chunk = (X.rows(i, i + self.PREDICT_CHUNK)
                     if hasattr(X, "rows")
                     else np.ascontiguousarray(X[i:i + self.PREDICT_CHUNK]))
            X_dev, n = runtime.shard_rows(chunk)
            outs.append(host_rows(self.predict_proba_fn(params, X_dev))[:n])
        return np.concatenate(outs, axis=0)

    def predict(self, runtime: DeviceRuntime, X: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict_proba(runtime, X), axis=1)


@dataclass
class FitReport:
    """What the reference persists per classifier: the model's metrics +
    wall-clock fit time (model_builder.py:199-225)."""

    kind: str
    fit_time: float
    metrics: Dict[str, float] = field(default_factory=dict)


class Timer:
    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.t0
