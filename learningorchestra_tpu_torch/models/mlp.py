"""MLP classifier trainer ("mlp") — the JAX package's two-layer perceptron.

No reference analogue (the reference's zoo stops at the pyspark.ml
families, model_builder.py:152-158).

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

On a pod, rows shard over the data axis: each rank takes its rows'
gradient sums and the sums are all-reduced before the bf16 rounding and
the l2 term, with the mask total — the all-reduce XLA makes of the JAX
package's row sums over its sharded design.

**The model axis.** The JAX package splits the hidden dimension over
the mesh's model axis (its ``param_specs``: W1 and b1 by column, W2 by
row; b2, mu and sigma whole), and so does ``fit`` here: with M ranks on
the axis, rank k holds ``W1[:, kh:(k+1)h]``, ``b1[kh:(k+1)h]`` and
``W2[kh:(k+1)h, :]`` (h = hidden / M; ``fit`` rounds hidden up to a
multiple of M, as the JAX package does) and Adam moments of the same
shapes. The hidden layer's work is split; the model-axis sums of a step
are exactly two all-reduces (``loss_and_grads``):

- the partial logits ``hb_k @ W2b_k``, (rows, C), summed in float32,
  then rounded to bf16 before ``+ b2``. That is what XLA's SPMD program
  of the JAX train step does on a (1, 2) CPU mesh (read from its
  compiled HLO): the partial dot in f32 feeds an f32 all-reduce (the
  product's bf16 sum, promoted), and the sum is converted to bf16 and
  back before the bias. On one device XLA folds that cast into the
  product, so a model-axis fit rounds its logits where a one-device fit
  does not, in both packages;
- one packed (2d + 2,) vector: each rank's row sums of its part of the
  standardization's gradients (the mu and sigma cotangents take ``dXs =
  dz_b @ W1b.T``, a sum over the hidden columns), and its ΣW1_k² and
  ΣW2_k² for the returned loss. XLA all-reduces the whole (rows, d)
  partial ``dXs`` in f32 with the two squared sums and rounds the sum to
  bf16, element by element, before the division by sigma. The row sums
  are linear in ``dXs``, so here each rank reduces its (d,) sums first
  and only those cross the axis (a (rows, d) all-reduce is 112 MB a step
  at 2^20 rows); the element-wise bf16 rounding of the sum is the one
  cast the port does not reproduce, so the mu and sigma gradients differ
  from the JAX package's in the last bits of bf16.

W1, b1 and W2's gradients are local to the rank (their l2 term too);
every gradient still sums over the data axis as above. The trained
model is whole on every rank: W1 and b1 are gathered along their
columns and W2 along its rows (one all-gather), as ``np.asarray`` of the
JAX package's sharded params gives, so persistence, the AOT cache and
the online tier see one (d, hidden) model at any M. A fit checkpoint
holds whole arrays and a resume slices them, so one file restores at
any M. Predict is the full-width ordered predict of the gathered model
(a deliberate divergence: the JAX package predicts through its sharded
params).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from learningorchestra_tpu_torch import jobs
from learningorchestra_tpu_torch.models.base import (
    TrainedModel, as_design, ordered_matmul, ordered_softmax)
from learningorchestra_tpu_torch.models.logistic import (
    _bf16, _device_stats, _dsum, adam_update, pop_scores)
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, all_gather, all_reduce_)
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


def _model_split(mesh) -> bool:
    """Whether ``mesh`` splits the hidden layer (model axis above 1)."""
    return mesh is not None and mesh.size(MODEL_AXIS) > 1


def loss_and_grads(params, X, Y1, mask, l2, mesh=None):
    """The masked mean cross-entropy plus l2·(ΣW1² + ΣW2²) at ``params``,
    and its gradients with respect to every entry of ``PARAMS``. Y1 (n,
    C) one-hot labels, mask (n,) row weights.
    A bf16 product's cotangent is rounded to bf16 before it contracts
    with the product's other bf16 operand (float32 sums); relu's
    derivative at 0 is 0, as ``jax.nn.relu``'s. ``mesh``: the row sums
    (and the loss) add over its data axis when it is split (a pod's row
    shards), and on a model axis above 1 ``params`` hold this rank's
    hidden slice (``shard_params``) and the partial logits and the packed
    standardization sums add over it (the module docstring)."""
    dmesh = mesh if mesh is not None and mesh.size(DATA_AXIS) > 1 else None
    W1b, W2b = _bf16(params["W1"]), _bf16(params["W2"])
    u = X - params["mu"]
    Xs = _bf16(u / params["sigma"])
    z = Xs @ W1b + params["b1"]
    hb = _bf16(torch.relu(z))
    part = hb @ W2b
    if _model_split(mesh):
        all_reduce_(part, mesh, MODEL_AXIS)
        part = _bf16(part)
    logits = part + params["b2"]
    logp = torch.log_softmax(logits, dim=-1)
    msum = _dsum(mask.sum(), dmesh)
    nll = -(logp * Y1).sum(dim=1)
    dlog = (torch.exp(logp) - Y1) * (mask / msum)[:, None]
    dlog_b = _bf16(dlog)
    dz = (dlog_b @ W2b.T) * (z > 0)
    dz_b = _bf16(dz)
    # The standardization is a parameter too: its cotangent flows back
    # through the first product (float32, as the compiled JAX program
    # keeps it) and the division.
    dXs = dz_b @ W1b.T
    sq1, sq2 = (params["W1"] ** 2).sum(), (params["W2"] ** 2).sum()
    d = X.shape[1]
    packed = torch.cat([
        (-(dXs / params["sigma"])).sum(dim=0),
        ((-dXs * u) * (1.0 / (params["sigma"] * params["sigma"])))
        .sum(dim=0), sq1.reshape(1), sq2.reshape(1)])
    if _model_split(mesh):
        all_reduce_(packed, mesh, MODEL_AXIS)
    loss = (_dsum((nll * mask).sum(), dmesh) / msum
            + l2 * (packed[2 * d] + packed[2 * d + 1]))
    grads = {"W1": _bf16(_dsum(Xs.T @ dz_b, dmesh))
             + (2.0 * params["W1"]) * l2,
             "b1": _dsum(dz.sum(dim=0), dmesh),
             "W2": _bf16(_dsum(hb.T @ dlog_b, dmesh))
             + (2.0 * params["W2"]) * l2,
             "b2": _dsum(dlog.sum(dim=0), dmesh),
             "mu": _dsum(packed[:d].contiguous(), dmesh),
             "sigma": _dsum(packed[d:2 * d].contiguous(), dmesh)}
    return loss, grads


def shard_params(params, mesh) -> dict:
    """This rank's hidden slice of whole (d, hidden) params: W1 and b1's
    columns and W2's rows ``[kh, (k+1)h)`` for model-axis index k, h =
    hidden / M; b2, mu and sigma whole. Whole params on a model axis of
    1. Raises when M does not divide the hidden width."""
    if not _model_split(mesh):
        return dict(params)
    m, k = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    hidden = int(params["W1"].shape[1])
    if hidden % m:
        raise ValueError(f"mlp hidden width {hidden} is not a multiple of "
                         f"the model axis's {m} ranks")
    h = hidden // m
    cols = slice(k * h, (k + 1) * h)
    out = dict(params)
    out["W1"] = params["W1"][:, cols].contiguous()
    out["b1"] = params["b1"][cols].contiguous()
    out["W2"] = params["W2"][cols, :].contiguous()
    return out


def gather_params(params, mesh) -> dict:
    """Whole params from every rank's hidden slice (``shard_params``'s
    inverse): one all-gather over the model axis of W1, b1 and W2ᵀ
    stacked as (d + 1 + C, h) columns."""
    if not _model_split(mesh):
        return dict(params)
    d, C = params["W1"].shape[0], params["W2"].shape[1]
    stacked = torch.cat([params["W1"], params["b1"][None, :],
                         params["W2"].T])
    whole = all_gather(stacked, mesh, MODEL_AXIS, dim=1)
    out = dict(params)
    out["W1"] = whole[:d].contiguous()
    out["b1"] = whole[d].contiguous()
    out["W2"] = whole[d + 1:d + 1 + C].T.contiguous()
    return out


def _adam_state(params) -> dict:
    return {"mu": {k: torch.zeros_like(params[k]) for k in PARAMS},
            "nu": {k: torch.zeros_like(params[k]) for k in PARAMS},
            "count": 0}


def _run(params, state, X, Y1, mask, *, lr, l2, steps, mesh=None):
    """``steps`` Adam steps of one member, in place of ``params`` and
    ``state``: the one step every fit — serial, segmented, population —
    takes."""
    for _ in range(steps):
        _, grads = loss_and_grads(params, X, Y1, mask, l2, mesh)
        adam_update(params, grads, state, lr)


def _ckpt_arrays(params, state, mesh=None) -> dict:
    """(params, Adam state) as the flat name → ndarray dict of a fit
    checkpoint, whole arrays on a model axis (gathered, a collective
    every rank reaches); ``_ckpt_restore`` inverts it."""
    params = gather_params(params, mesh)
    mu, nu = (gather_params(state[k], mesh) for k in ("mu", "nu"))
    out = {f"p.{k}": v.cpu().numpy() for k, v in params.items()}
    for k in PARAMS:
        out[f"o.mu.{k}"] = mu[k].cpu().numpy()
        out[f"o.nu.{k}"] = nu[k].cpu().numpy()
    out["o.count"] = np.asarray(state["count"], np.int64)
    return out


def _ckpt_restore(arrays, device, mesh=None):
    """A checkpoint's whole arrays on ``device``, as this rank's slice on
    a model axis."""
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    params = {k[2:]: t(v) for k, v in arrays.items() if k.startswith("p.")}
    state = {"mu": {k: t(arrays[f"o.mu.{k}"]) for k in PARAMS},
             "nu": {k: t(arrays[f"o.nu.{k}"]) for k in PARAMS},
             "count": int(arrays["o.count"])}
    for k in ("mu", "nu"):
        state[k] = shard_params(state[k], mesh)
    return shard_params(params, mesh), state


def _host_stats(X: np.ndarray):
    """The JAX package's host standardization: mean and std over rows,
    std below 1e-7 taken as 1."""
    mu = X.mean(axis=0).astype(np.float32)
    std = X.std(axis=0)
    return mu, np.where(std < 1e-7, 1.0, std).astype(np.float32)


def design_stats(runtime: DeviceRuntime, X, X_dev):
    """(mu, sigma) on the device: host numpy stats for a resident design
    (every rank of a pod holds the whole host array), the logistic
    module's two-pass device stats for a lazy one (its full matrix never
    exists on the host; on a pod they sum over the data axis)."""
    if isinstance(X, np.ndarray):
        mu, sigma = _host_stats(X)
        return runtime.replicate(mu), runtime.replicate(sigma)
    n = int(X.shape[0])
    valid = runtime.valid_rows(n)
    return _device_stats(X_dev, n, valid,
                         runtime.mesh if valid is not None else None)


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
    whole arrays) replaces the init draw (the parity tests carry the JAX
    package's across); the model axis must divide its width. An enabled
    ``ckpt`` (utils/fitckpt.py) segments the fit every ``ckpt.every``
    iterations and checkpoints (params, Adam state) between segments;
    the segmented fit is bit-identical to the whole one, and a resume
    continues from the saved iteration. On a model axis above 1 each
    rank trains its hidden slice of the whole init draw and the returned
    model is gathered whole (the module docstring)."""
    X = as_design(X)
    X_dev, n = runtime.shard_rows(X)
    dev = X_dev.device
    mu, sigma = design_stats(runtime, X, X_dev)
    d = X.shape[1]
    mesh = runtime.mesh
    if params0 is None:
        # The hidden width must divide the model axis; round up.
        m = mesh.size(MODEL_AXIS)
        hidden = -(-hidden // m) * m
        params = init_params(seed, d, hidden, num_classes, mu, sigma, dev)
    else:
        params = {k: runtime.replicate(np.asarray(params0[k], np.float32))
                  for k in ("W1", "b1", "W2", "b2")}
        params["mu"], params["sigma"] = mu, sigma
        hidden = int(params["W1"].shape[1])
    params = shard_params(params, mesh)
    y_dev, _ = runtime.shard_rows(np.asarray(y, np.int32))
    Y1 = torch.nn.functional.one_hot(y_dev.long(), num_classes).float()
    valid = runtime.valid_rows(n)
    mask = (torch.ones((n,), dtype=torch.float32, device=dev)
            if valid is None else valid)
    state = _adam_state(params)
    split = valid is not None or _model_split(mesh)
    kw = dict(lr=lr, l2=l2, mesh=mesh if split else None)
    if ckpt is not None and ckpt.enabled and iters > ckpt.every:
        done = 0
        loaded = ckpt.load()
        if loaded is not None:
            it_done, arrays, meta = loaded
            if 0 < it_done < iters and "o.count" in arrays:
                done = it_done
                params, state = _ckpt_restore(arrays, dev, kw["mesh"])
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
                ckpt.save(done, _ckpt_arrays(params, state, kw["mesh"]))
    else:
        _run(params, state, X_dev, Y1, mask, steps=iters, **kw)
    return TrainedModel(kind="mlp", params=gather_params(params, kw["mesh"]),
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
