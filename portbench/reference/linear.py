"""Plain logistic regression and Gaussian naive Bayes, in float64.

- Logistic regression: multinomial softmax on standardized features
  (population mean and standard deviation, a deviation under 1e-7 taken
  as 1), minimizing the mean cross-entropy plus ``l2``·|W|² on the
  weights and 1e-4/2 on every coefficient, by 20 exact Newton steps from
  zero, each step's length capped at 5.
- Gaussian naive Bayes: class priors, per-class means and variances
  (floored at 1e-6, plus 1e-3), the log-likelihood summed over the
  features.

``q`` rounds the standardized operands of logistic regression's
products (the identity for the sound reference; a lower precision for
the control).
"""

from __future__ import annotations

import math

import torch

_BLOCK = 1 << 20


def fit_logistic(X: torch.Tensor, y: torch.Tensor, num_classes: int, *,
                 iters: int = 20, l2: float = 1e-4, eps: float = 1e-4,
                 dtype=torch.float64, q=lambda t: t) -> dict:
    n, d = X.shape
    C, d1 = num_classes, d + 1
    dev = X.device
    mu = X.to(dtype).mean(0)
    sigma = torch.sqrt(((X.to(dtype) - mu) ** 2).mean(0))
    sigma = torch.where(sigma < 1e-7, torch.ones_like(sigma), sigma)
    ridge = (torch.cat([torch.full((d,), 2.0 * l2, dtype=dtype,
                                   device=dev),
                        torch.zeros(1, dtype=dtype, device=dev)]).repeat(C)
             + eps)
    W = torch.zeros((d1, C), dtype=dtype, device=dev)
    for _ in range(iters):
        g = torch.zeros((d1, C), dtype=dtype, device=dev)
        T1 = torch.zeros((C, d1, d1), dtype=dtype, device=dev)
        T2 = torch.zeros((C * d1, C * d1), dtype=dtype, device=dev)
        for a in range(0, n, _BLOCK):
            Z = q(torch.cat([(X[a:a + _BLOCK].to(dtype) - mu) / sigma,
                             torch.ones((len(X[a:a + _BLOCK]), 1),
                                        dtype=dtype, device=dev)], dim=1))
            P = torch.softmax(Z @ W, dim=1)
            Y1 = torch.nn.functional.one_hot(y[a:a + _BLOCK].long(),
                                             C).to(dtype)
            g += Z.T @ (P - Y1)
            A = (P[:, :, None] * Z[:, None, :]).reshape(-1, C * d1)
            T2 += A.T @ A
            T1 += torch.stack([Z.T @ (Z * P[:, c:c + 1]) for c in range(C)])
        gflat = g.T.reshape(-1) / n + ridge * W.T.reshape(-1)
        H = (torch.block_diag(*T1) - T2) / n + torch.diag(ridge)
        delta = torch.linalg.solve(H, gflat)
        delta = delta * torch.clamp(5.0 / torch.clamp(
            torch.linalg.norm(delta), min=1e-12), max=1.0)
        W = W - delta.reshape(C, d1).T
    return {"W": W[:d], "b": W[d], "mu": mu, "sigma": sigma, "q": q}


def logistic_proba(model: dict, X: torch.Tensor) -> torch.Tensor:
    q = model["q"]
    Z = q((X.to(model["W"].dtype) - model["mu"]) / model["sigma"])
    return torch.softmax(Z @ q(model["W"]) + model["b"], dim=1)


def fit_bayes(X: torch.Tensor, y: torch.Tensor, num_classes: int, *,
              smoothing: float = 1e-3, floor: float = 1e-6,
              dtype=torch.float64) -> dict:
    Xd = X.to(dtype)
    onehot = torch.nn.functional.one_hot(y.long(), num_classes).to(dtype)
    counts = onehot.sum(0)
    center = Xd.mean(0)
    Xc = Xd - center
    denom = torch.clamp(counts, min=1.0)[:, None]
    mean = onehot.T @ Xc / denom
    var = torch.clamp(onehot.T @ (Xc * Xc) / denom - mean ** 2,
                      min=floor) + smoothing
    prior = torch.log(torch.clamp(counts, min=1.0)
                      / torch.clamp(counts.sum(), min=1.0))
    return {"mean": mean + center, "var": var, "log_prior": prior}


def bayes_proba(model: dict, X: torch.Tensor) -> torch.Tensor:
    Xd = X.to(model["mean"].dtype)
    mean, var = model["mean"], model["var"]
    ll = -0.5 * ((((Xd[:, None, :] - mean[None]) ** 2) / var[None]).sum(-1)
                 + torch.log(2.0 * math.pi * var).sum(-1)[None])
    return torch.softmax(ll + model["log_prior"][None], dim=1)
