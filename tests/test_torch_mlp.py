"""The PyTorch package's mlp family against the JAX package's, on the CPU.

Same numpy inputs (made from a seed) into both packages; the JAX side on
the 8-device CPU mesh of tests/conftest.py (model axis 1, so the hidden
width is the config's), the PyTorch side on ``device="cpu"``. The
packages draw their initial weights differently, so the port starts
from the JAX package's draw (``params0``, or ``from_jax_params``).
Tolerances:

- the standardized input, logits, loss, gradients and one Adam step,
  against the JAX package's compiled (``jax.jit``) functions, which its
  fit runs: rtol 1e-5, with atol 1e-6·max|·| for the logits and
  gradients and 1e-7 for the parameters. Both packages feed bf16-valued
  operands to the products and round the same cotangents and weight
  gradients to bf16 (where the compiled JAX program rounds them); only
  the order of the float32 sums differs;
- a fit: accuracy within one point, predicted classes agree on ≥ 99% of
  rows, probabilities within atol 2e-2 (lr's tolerance: Adam scales
  every coordinate's step to about lr, so the sums' order on gradient
  coordinates near zero grows into visible differences over the
  iterations);
- within the port, a saved and reloaded model and the online tier's
  buckets give every row the bytes of a one-row batch predict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.models import mlp as jmlp
from learningorchestra_tpu.parallel.mesh import MeshRuntime
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models import aot, logistic, mlp
from learningorchestra_tpu_torch.models.convert import from_jax_params
from learningorchestra_tpu_torch.models.persistence import ModelRegistry
from learningorchestra_tpu_torch.models.registry import (
    ONLINE_KINDS, get_trainer)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import failpoints, fitckpt

D = 6
FIELDS = [f"x{i}" for i in range(D)]
PP = {"steps": [], "state": {}, "feature_fields": FIELDS, "label": "y"}


@pytest.fixture(scope="module")
def jrt():
    return MeshRuntime(JaxSettings())


@pytest.fixture(scope="module")
def trt():
    return DeviceRuntime(Settings(), device="cpu")


def _blobs(n, classes=2, seed=0, sep=1.2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, D)) * sep
    y = rng.integers(0, classes, size=n)
    X = (centers[y] + rng.normal(size=(n, D))).astype(np.float32)
    return X * np.float32(3.0) + np.float32(5.0), y.astype(np.int32)


def _jax_params(X, hidden, classes, seed=1):
    p = jmlp.init_params(jax.random.PRNGKey(seed), D, hidden, classes)
    mu, sigma = mlp._host_stats(X)
    p["mu"], p["sigma"] = jnp.asarray(mu), jnp.asarray(sigma)
    return p


def _torch(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("classes,hidden", [(2, 16), (3, 32)])
def test_forward_loss_and_adam_step_match_jax(classes, hidden):
    X, y = _blobs(400, classes=classes, seed=3)
    p = _jax_params(X, hidden, classes)
    tp = _torch(p)
    Xt = torch.from_numpy(X)
    np.testing.assert_allclose(
        ((Xt - tp["mu"]) / tp["sigma"]).numpy(),
        np.asarray((jnp.asarray(X) - p["mu"]) / p["sigma"]), rtol=1e-5)
    _close(mlp.forward(tp, Xt).numpy(),
           jax.jit(jmlp.forward)(p, jnp.asarray(X)), "logits")

    mask = np.ones(len(X), np.float32)
    l2 = 1e-3
    jloss, jgrads = jax.jit(jax.value_and_grad(jmlp.loss_fn))(
        p, jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask), l2)
    Y1 = torch.nn.functional.one_hot(torch.from_numpy(y).long(),
                                     classes).float()
    tloss, tgrads = mlp.loss_and_grads(tp, Xt, Y1, torch.from_numpy(mask),
                                       l2)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in mlp.PARAMS:
        _close(tgrads[k].numpy(), jgrads[k], f"grad {k}")

    # One Adam step: optax.adam(lr) in the JAX train step against the
    # port's hand-written optax order, each from its own gradients.
    opt = optax.adam(1e-2)
    jp1, _, _ = jax.jit(jmlp.make_train_step(opt))(
        p, opt.init(p), jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
        l2)
    tp1 = dict(tp)
    logistic.adam_update(tp1, tgrads, mlp._adam_state(tp), 1e-2)
    for k in mlp.PARAMS:
        np.testing.assert_allclose(tp1[k].numpy(), np.asarray(jp1[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_adam_update_is_optax_order_bit_for_bit():
    """Fed the same gradients, the port's Adam gives optax.adam's bits
    over several steps (the bias corrections in float32, applied to each
    moment, then ``u · (−lr)``)."""
    rng = np.random.default_rng(4)
    params = {"w": jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))}
    tparams = {"w": torch.from_numpy(np.asarray(params["w"]).copy())}
    opt = optax.adam(3e-2)
    st = opt.init(params)
    tst = {"mu": {"w": torch.zeros((5, 3))}, "nu": {"w": torch.zeros((5, 3))},
           "count": 0}
    for _ in range(7):
        g = rng.normal(size=(5, 3)).astype(np.float32)
        upd, st = opt.update({"w": jnp.asarray(g)}, st)
        params = optax.apply_updates(params, upd)
        logistic.adam_update(tparams, {"w": torch.from_numpy(g)}, tst, 3e-2)
        np.testing.assert_array_equal(tparams["w"].numpy(),
                                      np.asarray(params["w"]))


@pytest.mark.parametrize("classes", [2, 3])
def test_fit_matches_jax(jrt, trt, classes):
    X, y = _blobs(1200, classes=classes, seed=5, sep=0.6)
    jm = jmlp.fit(jrt, X, y, classes, seed=2, hidden=32, iters=60, lr=2e-2)
    p0 = jmlp.init_params(jax.random.PRNGKey(2), D, 32, classes)
    tm = mlp.fit(trt, X, y, classes, hidden=32, iters=60, lr=2e-2,
                 params0={k: np.asarray(v) for k, v in p0.items()})
    assert tm.kind == "mlp" and tm.hparams["hidden"] == 32
    pj = np.asarray(jm.predict_proba(jrt, X))
    pt = tm.predict_proba(trt, X)
    assert pt.shape == pj.shape == (len(X), classes)
    np.testing.assert_allclose(pt, pj, atol=2e-2)
    agree = (np.argmax(pj, 1) == np.argmax(pt, 1)).mean()
    assert agree >= 0.99, agree
    acc = lambda p: float((np.argmax(p, 1) == y).mean())
    assert abs(acc(pj) - acc(pt)) <= 0.01
    assert acc(pt) > 0.6


def test_from_jax_params_predicts_the_same(jrt):
    X, y = _blobs(600, classes=3, seed=6)
    jm = jmlp.fit(jrt, X, y, 3, hidden=16, iters=30)
    tm = from_jax_params("mlp", {k: np.asarray(v) for k, v in
                                 jm.params.items()}, 3, jm.hparams)
    pj = np.asarray(jm.predict_proba(jrt, X))
    pt = tm.predict_proba(DeviceRuntime(Settings(), device="cpu"), X)
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    assert (np.argmax(pt, 1) == np.argmax(pj, 1)).mean() >= 0.99


def test_registry_and_default_init(trt):
    assert "mlp" in ONLINE_KINDS and get_trainer("mlp") is mlp.fit
    X, y = _blobs(300, seed=7)
    a = mlp.fit(trt, X, y, 2, seed=3, hidden=8, iters=5)
    b = mlp.fit(trt, X, y, 2, seed=3, hidden=8, iters=5)
    c = mlp.fit(trt, X, y, 2, seed=4, hidden=8, iters=5)
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
    assert not torch.equal(a.params["W1"], c.params["W1"])
    assert a.params["W1"].shape == (D, 8)


def test_checkpointed_fit_is_bit_identical_and_resumes(trt, tmp_path):
    X, y = _blobs(400, seed=8)
    kw = dict(seed=1, hidden=16, iters=12, lr=2e-2)
    whole = mlp.fit(trt, X, y, 2, **kw)
    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    mk = lambda: fitckpt.context(cfg, dataset="d", family="mlp",
                                 config={"kw": 1}, snapshot="rows=400",
                                 every=4)
    failpoints.reset()
    failpoints.configure("fit.ckpt.pre_rename=raise:2")
    try:
        with pytest.raises(failpoints.FailpointError):
            mlp.fit(trt, X, y, 2, ckpt=mk(), **kw)
    finally:
        failpoints.reset()
    saved = mk().load()
    assert saved is not None and saved[0] == 4
    before = fitckpt.counters_snapshot()["resumes"]
    resumed = mlp.fit(trt, X, y, 2, ckpt=mk(), **kw)
    assert fitckpt.counters_snapshot()["resumes"] == before + 1
    for k, v in whole.params.items():
        assert torch.equal(v, resumed.params[k]), k


def test_save_load_and_online_rows_are_bit_identical(trt, tmp_path):
    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    reg = ModelRegistry(cfg)
    X, y = _blobs(500, classes=3, seed=9)
    model = mlp.fit(trt, X, y, 3, hidden=24, iters=20)
    reg.save("m", model, preprocess=PP)
    man, back = reg.load("m")
    assert man["kind"] == "mlp"
    for k, v in model.params.items():
        assert torch.equal(back.params[k], v), k
    Xq, _ = _blobs(40, classes=3, seed=10)
    entry = aot.AotModel("m", (0, 0), man, back, (1, 8, 64), device="cpu")
    one_bucket = entry.predict(Xq)
    rows = np.concatenate([entry.predict(Xq[i:i + 1]) for i in range(40)])
    threes = np.concatenate([entry.predict(Xq[i:i + 3])
                             for i in range(0, 40, 3)])
    batch_one_row = np.concatenate([back.predict_proba(trt, Xq[i:i + 1])
                                    for i in range(40)])
    big = back.predict_proba(trt, np.concatenate([X, Xq]))[len(X):]
    for other in (rows, threes, batch_one_row, big):
        np.testing.assert_array_equal(one_bucket, other)
    np.testing.assert_allclose(one_bucket.sum(1), 1.0, atol=1e-5)
