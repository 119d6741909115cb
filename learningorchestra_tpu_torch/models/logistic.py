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
    """Exact multinomial-Newton (IRLS) fit: the population program at
    population one, every row weighted 1."""
    ones = torch.ones((1, X.shape[0]), dtype=torch.float32, device=X.device)
    Wz = _fit_pop_newton(
        X, y, ones, mu, sigma, [l2], [iters], [1.0],
        [torch.zeros((X.shape[1] + 1, num_classes), dtype=torch.float32,
                     device=X.device)], 0,
        num_classes=num_classes, iters=iters)[0]
    d = X.shape[1]
    return {"W": Wz[:d].contiguous(), "b": Wz[d].contiguous(), "mu": mu,
            "sigma": sigma}


def _fit(X, y, mu, sigma, *, num_classes, iters, lr, l2, W0):
    """Full-batch Adam from the initial weights ``W0`` (d, C): the
    population program at population one, every row weighted 1."""
    Xs = _standardized(X, mu, sigma)
    ones = torch.ones((1, X.shape[0]), dtype=torch.float32, device=X.device)
    state = _fit_pop_adam([_adam_init(W0, num_classes)], Xs, y, ones, [lr],
                          [l2], [iters], [1.0], 0, iters=iters)[0]
    return {"W": state["W"], "b": state["b"], "mu": mu, "sigma": sigma}


def _draw_W0(seed, d, num_classes, device):
    """Adam's initial weights: 0.01·N(0, 1) from a ``torch.Generator``
    seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return 0.01 * torch.randn((d, num_classes), generator=gen, device=device)


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
    solver = resolve_solver(solver, num_classes, X.shape[1])
    if solver == "newton":
        params = _fit_newton(X_dev, y_dev, mu, sigma,
                             num_classes=num_classes, iters=min(iters, 20),
                             l2=l2)
    else:
        if W0 is None:
            W0 = _draw_W0(seed, X.shape[1], num_classes, X_dev.device)
        params = _fit(X_dev, y_dev, mu, sigma, num_classes=num_classes,
                      iters=iters, lr=lr, l2=l2,
                      W0=runtime.replicate(W0))
    return TrainedModel(kind="lr", params=params,
                        predict_proba_fn=_predict_proba,
                        num_classes=num_classes,
                        hparams={"iters": iters, "lr": lr, "l2": l2,
                                 "solver": solver})


def resolve_solver(solver: str, num_classes: int, d: int) -> str:
    """The solver a fit runs: ``auto`` is Newton while the Hessian side
    C·(d+1) stays at most ``_NEWTON_MAX_CD``, Adam past it."""
    if solver == "auto":
        return ("newton" if num_classes * (d + 1) <= _NEWTON_MAX_CD
                else "adam")
    if solver not in ("newton", "adam"):
        raise ValueError(f"unknown lr solver {solver!r}")
    return solver


# ---------------------------------------------------------------------------
# Config-population programs (models/tune.py)
#
# A population of lr configs over one resident design: per member its
# own row weights (validity × fold membership), l2, step budget and, for
# Adam, learning rate. Members run one at a time through the one member
# step, so every member's arithmetic is the serial fit's: the serial fit
# is this program at population one. A member whose budget is spent, or
# that successive halving dropped, takes no further steps — its params
# and optimizer state stay as they were, the freeze the JAX package's
# ``where`` over its vmapped members gives.
# ---------------------------------------------------------------------------

#: optax.adam's defaults (scale_by_adam: b1, b2, eps; eps_root 0).
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _standardized(X, mu, sigma):
    """The bf16-rounded standardized design the fits read."""
    return _bf16((X - mu) / sigma)


def adam_bias_corrections(count: int):
    """optax's bias corrections after ``count`` steps, ``1 - b**count``
    in float32: (1 - b1^t, 1 - b2^t) as Python floats holding the float32
    values."""
    t = np.float32(count)
    return (float(np.float32(1) - np.float32(ADAM_B1) ** t),
            float(np.float32(1) - np.float32(ADAM_B2) ** t))


def adam_update(params, grads, state, lr):
    """One Adam step in optax's order: ``scale_by_adam`` (mu = (1-b1)·g +
    b1·mu, nu = (1-b2)·g² + b2·nu, both bias-corrected, then mu_hat /
    (sqrt(nu_hat) + eps)), then a multiply by ``-lr``. Updates ``params``
    and ``state`` (per-key ``mu``/``nu`` dicts and the step ``count``) in
    place of their entries."""
    state["count"] += 1
    bc1, bc2 = adam_bias_corrections(state["count"])
    for k, g in grads.items():
        mu = (1 - ADAM_B1) * g + ADAM_B1 * state["mu"][k]
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state["nu"][k]
        state["mu"][k], state["nu"][k] = mu, nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        params[k] = params[k] + u * (-lr)


def _adam_init(W0, num_classes):
    """A member's Adam state: weights from W0 (d, C), zero intercepts,
    zero moments, step count 0."""
    W = W0.float().clone()
    b = torch.zeros((num_classes,), dtype=torch.float32, device=W.device)
    return {"W": W, "b": b,
            "mu": {"W": torch.zeros_like(W), "b": torch.zeros_like(b)},
            "nu": {"W": torch.zeros_like(W), "b": torch.zeros_like(b)},
            "count": 0}


def _lr_grads(Xs, Y1, mask, msum, W, b, l2):
    """Gradients of the masked mean cross-entropy plus l2·ΣW² at (W, b):
    the logits' cotangent is (softmax − onehot)·mask/Σmask; through the
    bf16 product, the weights' gradient contracts the bf16-rounded
    cotangent with the bf16 design (f32 sums), as the JAX package's
    autodiff of its bf16 product does."""
    logits = Xs @ _bf16(W) + b
    dlog = (torch.softmax(logits, dim=-1) - Y1) * (mask / msum)[:, None]
    return {"W": Xs.T @ _bf16(dlog) + (2.0 * W) * l2, "b": dlog.sum(dim=0)}


def _fit_pop_adam(states, Xs, y, masks, lrs, l2s, iters_vec, alive, t0, *,
                  iters):
    """One segment of ``iters`` Adam steps, global steps t0 … t0+iters-1,
    for a population of lr configs. ``states``: per member, the dict of
    ``_adam_init`` (updated and returned); Xs: ``_standardized`` design;
    masks (G, n) row weights; lrs, l2s, iters_vec, alive: per member."""
    Y1 = torch.nn.functional.one_hot(y.long(), states[0]["b"].shape[0]
                                     ).float()
    for m, st in enumerate(states):
        steps = min(t0 + iters, int(iters_vec[m])) - t0
        if alive[m] <= 0 or steps <= 0:
            continue
        mask = masks[m]
        msum = mask.sum()
        params = {"W": st["W"], "b": st["b"]}
        for _ in range(steps):
            grads = _lr_grads(Xs, Y1, mask, msum, params["W"], params["b"],
                              float(l2s[m]))
            adam_update(params, grads, st, float(lrs[m]))
        st["W"], st["b"] = params["W"], params["b"]
    return states


def _fit_pop_newton(X, y, masks, mu, sigma, l2s, iters_vec, alive, Wz,
                    t0, *, num_classes, iters):
    """One segment of ``iters`` Newton/IRLS steps for a population of lr
    configs: per member its row weights (G, n), l2 (traced into the
    ridge) and step budget. Z = [standardized X | 1] in bf16 is built
    once; per step, row blocks accumulate g = Z'(P−Y) and the exact
    Hessian H[(c,i),(c',j)] = Σ_n z_i z_j p_c (δ_cc' − p_c') over the
    member's weighted rows, then a dense solve updates its (d+1, C)
    augmented weights. ``Wz``: per member, updated and returned."""
    C = num_classes
    n, d = X.shape
    d1 = d + 1
    dev = X.device
    Z = _bf16(torch.cat([(X - mu) / sigma, torch.ones((n, 1), device=dev)],
                        dim=1))                              # (n, d+1)
    Wz = list(Wz)
    for m in range(len(Wz)):
        steps = min(t0 + iters, int(iters_vec[m])) - t0
        if alive[m] <= 0 or steps <= 0:
            continue
        mask = masks[m]
        # l2 penalizes weights, not the intercept row. The ε term
        # regularizes the softmax shift-null direction of H above the bf16
        # noise floor.
        ridge = torch.cat([torch.full((d,), 2.0 * float(l2s[m]), device=dev),
                           torch.zeros((1,), device=dev)]).repeat(C) + 1e-4
        nf = torch.clamp(mask.sum(), min=1.0)
        for _ in range(steps):
            Wz[m] = _newton_step(Z, y, mask, nf, ridge, Wz[m], C)
    return Wz


def _newton_step(Z, y, mask, nf, ridge, Wz, C):
    """One Newton step of one member (see ``_fit_pop_newton``)."""
    n, d1 = Z.shape
    dev = Z.device
    g = torch.zeros((d1, C), dtype=torch.float32, device=dev)
    T1 = torch.zeros((C, d1, d1), dtype=torch.float32, device=dev)
    T2 = torch.zeros((C * d1, C * d1), dtype=torch.float32, device=dev)
    Wb = _bf16(Wz)
    for i in range(0, n, _NEWTON_BLOCK):
        Zb = Z[i:i + _NEWTON_BLOCK]
        mb = mask[i:i + _NEWTON_BLOCK, None]
        Pr = torch.softmax(Zb @ Wb, dim=-1) * mb
        Y1 = torch.nn.functional.one_hot(y[i:i + _NEWTON_BLOCK].long(),
                                         C).float() * mb
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
    # Trust region: on separable data the saturated Hessian vanishes and
    # an uncapped Newton step overshoots to NaN.
    norm = torch.linalg.norm(delta)
    delta = delta * torch.clamp(5.0 / torch.clamp(norm, min=1e-12), max=1.0)
    delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
    return Wz - delta.reshape(C, d1).T


def _pop_lr_scores(params_list, X, y, ew_pop):
    """Per-member lr accuracy on per-member (eval-fold) row weights,
    through the predict function (``_predict_proba``), so a member's
    predictions are its serial fit's. Returns (G,) float64 host values."""
    return pop_scores(_predict_proba, params_list, X, y, ew_pop)


def pop_scores(proba, params_list, X, y, ew_pop):
    """Accuracy of each member's ``proba(params, X)`` predictions on its
    row weights, in row blocks of ``TrainedModel.PREDICT_CHUNK``."""
    chunk = TrainedModel.PREDICT_CHUNK
    out = []
    for m, params in enumerate(params_list):
        hits = torch.zeros((), dtype=torch.float64, device=X.device)
        for a in range(0, X.shape[0], chunk):
            pred = torch.argmax(proba(params, X[a:a + chunk]), dim=1)
            hits += ((pred == y[a:a + chunk]).double()
                     * ew_pop[m, a:a + chunk]).sum()
        out.append(float(hits / max(float(ew_pop[m].double().sum()), 1.0)))
    return np.asarray(out, np.float64)
