"""Logistic regression trainer ("lr" in the classifier registry).

The reference's "lr" is ``pyspark.ml.classification.LogisticRegression``
(reference model_builder.py:152). Multinomial logistic regression with two
solvers, as in the JAX package:

- **Newton/IRLS** (``solver="auto"`` whenever ``C·(d+1)`` ≤ 256): ~20
  second-order steps. Each step runs over row blocks accumulating the
  gradient and the exact multinomial Hessian from bf16-rounded operands
  (f32 parameters and sums), then one dense solve.
- **Adam** (wide-model fallback): full-batch first-order steps on the
  bf16-rounded standardized design matrix.

Operands are rounded to bf16 where the JAX package casts them, so both
packages round the same intermediates. The fit's matrix products are
plain ``torch.matmul`` — the JAX package leaves them to XLA, not to a
kernel; the predict path sums in a fixed order instead, so a row's
probabilities do not depend on its batch (models/base.py).
"""

from __future__ import annotations

import numpy as np
import torch

from learningorchestra_tpu_torch.models.base import (
    TrainedModel, as_design, ordered_matmul, ordered_softmax)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

#: Rows per Newton accumulation block (bounds the (B, C·(d+1)) A tensor
#: of a block).
_NEWTON_BLOCK = 1 << 20
#: Newton applies while the Hessian side C·(d+1) stays this small.
_NEWTON_MAX_CD = 256


def _bf16(x):
    """Round to bf16, held in f32: the JAX package's bf16 operands. Its
    compiled products accumulate and return f32 (XLA folds the cast back
    to f32 into the dot), so the products here take bf16-valued f32
    operands and give f32 sums."""
    return x.to(torch.bfloat16).float()


def _logits(params, X):
    """Predict-time logits, row-invariant (``base.ordered_matmul``): the
    products of bf16 values are exact in f32, so only the order of the
    feature sum rounds, and it is fixed."""
    W, b, mu, sigma = (params["W"], params["b"], params["mu"],
                       params["sigma"])
    return ordered_matmul(_bf16((X - mu) / sigma), _bf16(W)) + b


def _predict_proba(params, X):
    return ordered_softmax(_logits(params, X))


def _device_stats(X):
    """Per-feature mean/std — two-pass (mean first, then Σ(x−μ)²): the
    one-pass E[x²]−E[x]² form cancels catastrophically in f32 for
    features with |mean| ≫ std."""
    nf = max(float(X.shape[0]), 1.0)
    mu = X.sum(dim=0) / nf
    dx = X - mu
    var = (dx * dx).sum(dim=0) / nf
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    return mu, torch.where(sigma < 1e-7, torch.ones_like(sigma), sigma)


def _fit_newton(X, y, mu, sigma, *, num_classes, iters, l2):
    """Exact multinomial-Newton (IRLS) fit, row-blocked.

    Z = [standardized X | 1] in bf16; per step, row blocks accumulate
    g = Z'(P−Y) and the exact Hessian H[(c,i),(c',j)] = Σ_n z_i z_j p_c
    (δ_cc' − p_c'), then a dense solve updates the (d+1, C) augmented
    weights."""
    C = num_classes
    n, d = X.shape
    d1 = d + 1
    dev = X.device
    # l2 penalizes weights, not the intercept row. The ε term regularizes
    # the softmax shift-null direction of H above the bf16 noise floor.
    ridge = torch.cat([torch.full((d,), 2.0 * l2, device=dev),
                       torch.zeros((1,), device=dev)]).repeat(C) + 1e-4
    Z = _bf16(torch.cat([(X - mu) / sigma, torch.ones((n, 1), device=dev)],
                        dim=1))                              # (n, d+1)
    nf = max(float(n), 1.0)
    Wz = torch.zeros((d1, C), dtype=torch.float32, device=dev)
    for _ in range(iters):
        g = torch.zeros((d1, C), dtype=torch.float32, device=dev)
        T1 = torch.zeros((C, d1, d1), dtype=torch.float32, device=dev)
        T2 = torch.zeros((C * d1, C * d1), dtype=torch.float32, device=dev)
        Wb = _bf16(Wz)
        for i in range(0, n, _NEWTON_BLOCK):
            Zb = Z[i:i + _NEWTON_BLOCK]
            yb = y[i:i + _NEWTON_BLOCK].long()
            Pr = torch.softmax(Zb @ Wb, dim=-1)
            Y1 = torch.nn.functional.one_hot(yb, C).float()
            R = _bf16(Pr - Y1)
            g += Zb.T @ R
            Pb = _bf16(Pr)
            A = _bf16(Pb[:, :, None] * Zb[:, None, :]).reshape(-1, C * d1)
            T2 += A.T @ A
            T1 += torch.stack([Zb.T @ _bf16(Zb * Pb[:, c:c + 1])
                               for c in range(C)])
        gflat = g.T.reshape(C * d1) / nf + ridge * Wz.T.reshape(C * d1)
        H = torch.block_diag(*[T1[c] for c in range(C)]) - T2
        H = H / nf + torch.diag(ridge)
        delta = torch.linalg.solve(H, gflat)
        # Trust region: on separable data the saturated Hessian vanishes
        # and an uncapped Newton step overshoots to NaN.
        norm = torch.linalg.norm(delta)
        delta = delta * torch.clamp(5.0 / torch.clamp(norm, min=1e-12),
                                    max=1.0)
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        Wz = Wz - delta.reshape(C, d1).T
    return {"W": Wz[:d].contiguous(), "b": Wz[d].contiguous(), "mu": mu,
            "sigma": sigma}


def _fit(X, y, mu, sigma, *, num_classes, iters, lr, l2, W0):
    """Full-batch Adam (optax.adam's arithmetic: b1=0.9, b2=0.999,
    eps=1e-8, bias-corrected moments) on the bf16 standardized design,
    from the initial weights ``W0`` (d, C)."""
    Xs = _bf16((X - mu) / sigma)
    yl = y.long()
    W = W0.clone().float().requires_grad_(True)
    b = torch.zeros((num_classes,), dtype=torch.float32, device=X.device,
                    requires_grad=True)
    params = [W, b]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, iters + 1):
        logits = Xs @ _bf16(W) + b
        nll = torch.nn.functional.cross_entropy(logits, yl)
        loss = nll + l2 * (W ** 2).sum()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, gr, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(gr, alpha=1 - b1)
                vi.mul_(b2).addcmul_(gr, gr, value=1 - b2)
                mhat = mi / (1 - b1 ** t)
                vhat = vi / (1 - b2 ** t)
                p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
    return {"W": W.detach(), "b": b.detach(), "mu": mu, "sigma": sigma}


def fit(runtime: DeviceRuntime, X: np.ndarray, y: np.ndarray,
        num_classes: int, seed: int = 0, *, iters: int = 300,
        lr: float = 0.1, l2: float = 1e-4, solver: str = "auto",
        W0=None) -> TrainedModel:
    """``W0`` (d, C) sets Adam's initial weights; by default they are
    0.01·N(0, 1) from a ``torch.Generator`` seeded with ``seed``."""
    X = as_design(X)
    X_dev, _ = runtime.shard_rows(X)
    y_dev, _ = runtime.shard_rows(np.asarray(y, np.int32))
    mu, sigma = _device_stats(X_dev)
    if solver == "auto":
        solver = ("newton"
                  if num_classes * (X.shape[1] + 1) <= _NEWTON_MAX_CD
                  else "adam")
    if solver == "newton":
        params = _fit_newton(X_dev, y_dev, mu, sigma,
                             num_classes=num_classes, iters=min(iters, 20),
                             l2=l2)
    elif solver == "adam":
        if W0 is None:
            gen = torch.Generator(device=X_dev.device)
            gen.manual_seed(int(seed))
            W0 = 0.01 * torch.randn((X.shape[1], num_classes),
                                    generator=gen, device=X_dev.device)
        params = _fit(X_dev, y_dev, mu, sigma, num_classes=num_classes,
                      iters=iters, lr=lr, l2=l2,
                      W0=runtime.replicate(W0))
    else:
        raise ValueError(f"unknown lr solver {solver!r}")
    return TrainedModel(kind="lr", params=params,
                        predict_proba_fn=_predict_proba,
                        num_classes=num_classes,
                        hparams={"iters": iters, "lr": lr, "l2": l2,
                                 "solver": solver})
