"""MLP classifier trainer ("mlp") — the JAX package's two-layer perceptron.

No reference analogue (the reference's zoo stops at the pyspark.ml
families, model_builder.py:152-158). The JAX package shards the hidden
dimension over a mesh's model axis; on one card the model axis is 1, so
the hidden width rounds to itself and the network is one ``nn.Module``.

The arithmetic keeps the JAX package's casts (its ``mlp.forward``):
standardize, round to bf16, ``@ W1`` in bf16, ``+ b1`` and relu in
float32, round to bf16, ``@ W2`` in bf16, ``+ b2``. bf16 values are held
in float32 tensors (``logistic._bf16``): a product of bf16 operands sums
and stays in float32, as in the JAX package's compiled fit, where XLA
folds the cast of each bf16 product's result to float32 into the
product. The loss is its masked mean cross-entropy plus
``l2·(ΣW1² + ΣW2²)``; gradients are written out with the cotangents of
its autodiff (a bf16 product's cotangent and the weights' gradients
rounded to bf16, where the compiled JAX program rounds them), and Adam —
which steps every parameter, the standardization (mu, sigma) included,
as the JAX package's does — is optax's, written by hand in its order
(``logistic.adam_update``) — ``torch.optim.Adam`` folds the bias
corrections into the step in another order and differs in the last
bits. The predict function sums in a fixed order (models/base.py), so a
row's probabilities do not depend on its batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from learningorchestra_tpu_torch import jobs
from learningorchestra_tpu_torch.models.base import (
    TrainedModel, as_design, ordered_matmul, ordered_softmax)
from learningorchestra_tpu_torch.models.logistic import (
    _bf16, _device_stats, adam_update, pop_scores)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import fitckpt

#: The trained parameters: the JAX package's Adam steps every leaf of
#: its params tree, the standardization (mu, sigma) included.
PARAMS = ("W1", "b1", "W2", "b2", "mu", "sigma")


class MLP(torch.nn.Module):
    """The perceptron's parameters (W1 (d, h), b1 (h,), W2 (h, C), b2
    (C,)) and its standardization buffers (mu, sigma (d,)). He-normal
    init from ``generator``: W1 = √(2/d)·N(0, 1), W2 = √(2/h)·N(0, 1),
    zero biases."""

    def __init__(self, d: int, hidden: int, num_classes: int, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = torch.device(device) if device is not None else None
        w1 = torch.randn((d, hidden), generator=generator, device=dev)
        w2 = torch.randn((hidden, num_classes), generator=generator,
                         device=dev)
        self.W1 = torch.nn.Parameter(math.sqrt(2.0 / d) * w1,
                                     requires_grad=False)
        self.b1 = torch.nn.Parameter(torch.zeros((hidden,), device=dev),
                                     requires_grad=False)
        self.W2 = torch.nn.Parameter(math.sqrt(2.0 / hidden) * w2,
                                     requires_grad=False)
        self.b2 = torch.nn.Parameter(torch.zeros((num_classes,), device=dev),
                                     requires_grad=False)
        self.register_buffer("mu", torch.zeros((d,), device=dev))
        self.register_buffer("sigma", torch.ones((d,), device=dev))

    def params(self) -> dict:
        """The parameter dict a ``TrainedModel`` carries."""
        return {k: v.detach() for k, v in
                list(self.named_parameters()) + list(self.named_buffers())}

    def forward(self, X):
        return forward(self.params(), X)


def forward(params, X):
    """Training logits (n, C): the JAX package's casts, products through
    ``torch.matmul``."""
    Xs = _bf16((X - params["mu"]) / params["sigma"])
    h = torch.relu(Xs @ _bf16(params["W1"]) + params["b1"])
    return _bf16(h) @ _bf16(params["W2"]) + params["b2"]


def loss_and_grads(params, X, Y1, mask, l2):
    """The masked mean cross-entropy plus l2·(ΣW1² + ΣW2²) at ``params``,
    and its gradients with respect to every entry of ``PARAMS``. Y1 (n,
    C) one-hot labels, mask (n,) row weights.
    A bf16 product's cotangent is rounded to bf16 before it contracts
    with the product's other bf16 operand (float32 sums); relu's
    derivative at 0 is 0, as ``jax.nn.relu``'s."""
    W1b, W2b = _bf16(params["W1"]), _bf16(params["W2"])
    u = X - params["mu"]
    Xs = _bf16(u / params["sigma"])
    z = Xs @ W1b + params["b1"]
    hb = _bf16(torch.relu(z))
    logits = hb @ W2b + params["b2"]
    logp = torch.log_softmax(logits, dim=-1)
    msum = mask.sum()
    nll = -(logp * Y1).sum(dim=1)
    reg = l2 * ((params["W1"] ** 2).sum() + (params["W2"] ** 2).sum())
    loss = (nll * mask).sum() / msum + reg
    dlog = (torch.exp(logp) - Y1) * (mask / msum)[:, None]
    dlog_b = _bf16(dlog)
    dz = (dlog_b @ W2b.T) * (z > 0)
    dz_b = _bf16(dz)
    # The standardization is a parameter too: its cotangent flows back
    # through the first product (float32, as the compiled JAX program
    # keeps it) and the division.
    dXs = dz_b @ W1b.T
    grads = {"W1": _bf16(Xs.T @ dz_b) + (2.0 * params["W1"]) * l2,
             "b1": dz.sum(dim=0),
             "W2": _bf16(hb.T @ dlog_b) + (2.0 * params["W2"]) * l2,
             "b2": dlog.sum(dim=0),
             "mu": (-(dXs / params["sigma"])).sum(dim=0),
             "sigma": ((-dXs * u)
                       * (1.0 / (params["sigma"] * params["sigma"])))
             .sum(dim=0)}
    return loss, grads


def _adam_state(params) -> dict:
    return {"mu": {k: torch.zeros_like(params[k]) for k in PARAMS},
            "nu": {k: torch.zeros_like(params[k]) for k in PARAMS},
            "count": 0}


def _run(params, state, X, Y1, mask, *, lr, l2, steps):
    """``steps`` Adam steps of one member, in place of ``params`` and
    ``state``: the one step every fit — serial, segmented, population —
    takes."""
    for _ in range(steps):
        _, grads = loss_and_grads(params, X, Y1, mask, l2)
        adam_update(params, grads, state, lr)


def _ckpt_arrays(params, state) -> dict:
    """(params, Adam state) as the flat name → ndarray dict of a fit
    checkpoint; ``_ckpt_restore`` inverts it."""
    out = {f"p.{k}": v.cpu().numpy() for k, v in params.items()}
    for k in PARAMS:
        out[f"o.mu.{k}"] = state["mu"][k].cpu().numpy()
        out[f"o.nu.{k}"] = state["nu"][k].cpu().numpy()
    out["o.count"] = np.asarray(state["count"], np.int64)
    return out


def _ckpt_restore(arrays, device):
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    params = {k[2:]: t(v) for k, v in arrays.items() if k.startswith("p.")}
    state = {"mu": {k: t(arrays[f"o.mu.{k}"]) for k in PARAMS},
             "nu": {k: t(arrays[f"o.nu.{k}"]) for k in PARAMS},
             "count": int(arrays["o.count"])}
    return params, state


def _host_stats(X: np.ndarray):
    """The JAX package's host standardization: mean and std over rows,
    std below 1e-7 taken as 1."""
    mu = X.mean(axis=0).astype(np.float32)
    std = X.std(axis=0)
    return mu, np.where(std < 1e-7, 1.0, std).astype(np.float32)


def design_stats(runtime: DeviceRuntime, X, X_dev):
    """(mu, sigma) on the device: host numpy stats for a resident design,
    the logistic module's two-pass device stats for a lazy one (its full
    matrix never exists on the host)."""
    if isinstance(X, np.ndarray):
        mu, sigma = _host_stats(X)
        return runtime.replicate(mu), runtime.replicate(sigma)
    return _device_stats(X_dev)


def init_params(seed: int, d: int, hidden: int, num_classes: int,
                mu, sigma, device) -> dict:
    """A member's initial parameters: the ``MLP`` init from a
    ``torch.Generator`` seeded with ``seed``, and the design's (mu,
    sigma)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    params = MLP(d, hidden, num_classes, generator=gen,
                 device=device).params()
    params["mu"], params["sigma"] = mu, sigma
    return params


def fit(runtime: DeviceRuntime, X, y, num_classes: int, seed: int = 0, *,
        hidden: int = 256, iters: int = 300, lr: float = 1e-2,
        l2: float = 1e-4, ckpt=None, params0=None) -> TrainedModel:
    """Full-batch Adam over all rows. ``params0`` (W1, b1, W2, b2 as
    arrays) replaces the init draw (the parity tests carry the JAX
    package's across). An enabled ``ckpt`` (utils/fitckpt.py) segments
    the fit every ``ckpt.every`` iterations and checkpoints (params, Adam
    state) between segments; the segmented fit is bit-identical to the
    whole one, and a resume continues from the saved iteration."""
    X = as_design(X)
    X_dev, n = runtime.shard_rows(X)
    dev = X_dev.device
    mu, sigma = design_stats(runtime, X, X_dev)
    d = X.shape[1]
    if params0 is None:
        params = init_params(seed, d, hidden, num_classes, mu, sigma, dev)
    else:
        params = {k: runtime.replicate(np.asarray(params0[k], np.float32))
                  for k in ("W1", "b1", "W2", "b2")}
        params["mu"], params["sigma"] = mu, sigma
        hidden = int(params["W1"].shape[1])
    y_dev, _ = runtime.shard_rows(np.asarray(y, np.int32))
    Y1 = torch.nn.functional.one_hot(y_dev.long(), num_classes).float()
    mask = torch.ones((n,), dtype=torch.float32, device=dev)
    state = _adam_state(params)
    kw = dict(lr=lr, l2=l2)
    if ckpt is not None and ckpt.enabled and iters > ckpt.every:
        done = 0
        loaded = ckpt.load()
        if loaded is not None:
            it_done, arrays, meta = loaded
            if 0 < it_done < iters and "o.count" in arrays:
                done = it_done
                params, state = _ckpt_restore(arrays, dev)
                fitckpt.count_resume()
                jobs.record_job_resume(ckpt.family, {
                    "iters": int(done), "of": int(iters),
                    "mesh_epoch": meta.get("mesh_epoch")})
            else:
                ckpt.clear()
        every = max(1, int(ckpt.every))
        while done < iters:
            k = min(every, iters - done)
            _run(params, state, X_dev, Y1, mask, steps=k, **kw)
            done += k
            jobs.heartbeat()
            if done < iters:
                ckpt.save(done, _ckpt_arrays(params, state))
    else:
        _run(params, state, X_dev, Y1, mask, steps=iters, **kw)
    return TrainedModel(kind="mlp", params=params,
                        predict_proba_fn=_predict_proba,
                        num_classes=num_classes,
                        hparams={"hidden": hidden, "iters": iters, "lr": lr})


def _predict_proba(params, X):
    """Probabilities (n, C), row-invariant: both products accumulate in
    index order (``base.ordered_matmul``; products of bf16 values are
    exact in float32), then an ordered softmax."""
    Xs = _bf16((X - params["mu"]) / params["sigma"])
    h = torch.relu(ordered_matmul(Xs, _bf16(params["W1"])) + params["b1"])
    logits = ordered_matmul(_bf16(h), _bf16(params["W2"])) + params["b2"]
    return ordered_softmax(logits)


# ---------------------------------------------------------------------------
# Config-population programs (models/tune.py)
# ---------------------------------------------------------------------------

def _pop_mlp_init(seeds, hiddens, d, num_classes, mu, sigma, device):
    """Per-member params and Adam states, each member at its own hidden
    width, drawn as its serial fit draws them (one card: the model axis
    is 1, so a width rounds to itself)."""
    params = [init_params(s, d, int(h), num_classes, mu, sigma, device)
              for s, h in zip(seeds, hiddens)]
    return params, [_adam_state(p) for p in params]


def _run_pop(params, states, X, Y1, masks, lrs, l2s, iters_vec, alive, t0,
             *, iters):
    """One segment of ``iters`` Adam steps, global steps t0 … t0+iters-1,
    for a population of mlp configs: each member with its own row
    weights, learning rate, l2 and budget runs through the serial step,
    one member at a time — a batched bf16 product tiles differently from
    the serial fit's and drifts by ulps. A member whose budget is spent,
    or that halving dropped, takes no step: its params and Adam state
    stay as they were (the JAX package's ``where`` freeze)."""
    for m in range(len(params)):
        steps = min(t0 + iters, int(iters_vec[m])) - t0
        if alive[m] > 0 and steps > 0:
            _run(params[m], states[m], X, Y1, masks[m], lr=float(lrs[m]),
                 l2=float(l2s[m]), steps=steps)
    return params, states


def _pop_mlp_scores(params, X, y, ew_pop):
    """Per-member accuracy on per-member (eval-fold) row weights through
    the predict function, so a member's predictions are its serial
    fit's."""
    return pop_scores(_predict_proba, params, X, y, ew_pop)
