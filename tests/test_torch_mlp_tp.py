"""The PyTorch package's mlp on a (data, model) mesh against the JAX
package's ``mlp`` on the same mesh, at (1, 2) and (2, 2).

The JAX package splits the hidden dimension over the mesh's model axis
(``learningorchestra_tpu/models/mlp.py`` ``param_specs``); the port's
``mlp`` does too (``shard_params``, ``loss_and_grads`` with its two
model-axis all-reduces a step, ``gather_params``). The port's ranks are
spawned with ``torch.multiprocessing`` (start method spawn), joined over
gloo through a ``FileStore`` under the test's temporary directory, one
thread a rank, with ``LO_TPU_MESH_SHAPE`` set; one process group per
mesh shape runs every case, and its results travel in npz files (one a
rank). The JAX side runs in the test process on the first 2 or 4 of
tests/conftest.py's 8 CPU devices, its params placed on their declared
shardings and its rows on the data axis, as its ``fit`` places them. The
port starts from the JAX package's initial draw (``params0``).

Tolerances:

- one Adam step from the same params (loss and every parameter, the
  gathered model against the JAX package's): rtol 1e-5, atol 1e-7, as
  ``test_torch_mlp.py::test_forward_loss_and_adam_step_match_jax``;
- 20 steps against the JAX package's fit: rtol 1e-5, atol 2e-4 on every
  parameter (measured: 8.7e-5 at most, on sigma, at both shapes). The
  JAX program rounds the model-axis sum of ``dz_b @ W1b.T`` to bf16 row
  by row; the port sums its (d,) row sums instead (models/mlp.py), so
  the standardization's gradients differ in the last bits of bf16 and
  Adam carries that into every parameter;
- the port's mesh fit against its own one-rank fit. On a model axis the
  JAX program rounds the summed logits to bf16, which its one-device
  program does not, so in neither package is the mesh fit within these
  tolerances of the one-device fit (the JAX package's own: b1 2.0e-2
  apart after one step, a coordinate whose gradient changes sign).
  Checked instead: the port's mesh fit moves from its one-rank fit by
  what the JAX package's mesh fit moves from its one-device fit (one
  step: rtol 1e-5, atol 1e-7, and the loss within 1e-6; 20 steps: the
  20-step tolerance, measured 8.7e-5), and the two predict within
  ``test_torch_mlp.py::test_fit_matches_jax``'s tolerances
  (probabilities within atol 2e-2, measured 7.1e-3; argmax agreement
  ≥ 0.99; accuracy within 0.01);
- a checkpoint written on the mesh: resumed on the mesh, the
  uninterrupted fit bit for bit; resumed on one rank, a fit that
  predicts as the uninterrupted one within the fit tolerances above.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

D, CLASSES, N, HIDDEN = 5, 3, 120, 8
STEPS, EVERY, LR, L2, SEED = 20, 5, 1e-2, 1e-3, 2
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
SPAWN_TIMEOUT_S = 150.0
PARAMS = ("W1", "b1", "W2", "b2", "mu", "sigma")
#: The 20-step tolerance's atol (the module docstring).
FIT_ATOL = 2e-4
CKPT_KEYS = dict(dataset="d", family="mlp", config={"tp": 1},
                 snapshot=f"rows={N}")


def _rank(rank: int, world: int, shape: str, tmp: str) -> None:
    os.environ["LO_TPU_MESH_SHAPE"] = shape
    torch.set_num_threads(1)
    from learningorchestra_tpu_torch.config import Settings
    from learningorchestra_tpu_torch.models import logistic, mlp
    from learningorchestra_tpu_torch.parallel import spmd
    from learningorchestra_tpu_torch.parallel.mesh import (
        DATA_AXIS, MODEL_AXIS, collective_counts, reset_collective_counts)
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
    from learningorchestra_tpu_torch.utils import failpoints, fitckpt

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        with np.load(os.path.join(tmp, "in.npz")) as f:
            inp = dict(f)
        X, y = inp["X"], inp["y"]
        p0 = {k: inp[f"p0.{k}"] for k in ("W1", "b1", "W2", "b2")}
        cfg = Settings()
        cfg.store_root = os.path.join(tmp, f"ck{rank}")
        rt = DeviceRuntime(cfg, device="cpu")
        mesh = rt.mesh
        out = {"model_index": mesh.index(MODEL_AXIS),
               "data_index": mesh.index(DATA_AXIS)}
        with spmd.mesh_scope():
            # One step from the JAX package's params.
            X_dev, n = rt.shard_rows(X)
            y_dev, _ = rt.shard_rows(y)
            valid = rt.valid_rows(n)
            mask = torch.ones((n,)) if valid is None else valid
            Y1 = torch.nn.functional.one_hot(y_dev.long(), CLASSES).float()
            full = {k: torch.from_numpy(v) for k, v in p0.items()}
            full["mu"], full["sigma"] = mlp.design_stats(rt, X, X_dev)
            params = mlp.shard_params(full, mesh)
            for k in ("W1", "b1", "W2"):
                out[f"slice.{k}"] = params[k].numpy()
            reset_collective_counts()
            loss, grads = mlp.loss_and_grads(params, X_dev, Y1, mask, L2,
                                             mesh)
            out["step_collectives"] = json.dumps(collective_counts())
            logistic.adam_update(params, grads, mlp._adam_state(params), LR)
            out["step.loss"] = float(loss)
            for k, v in mlp.gather_params(params, mesh).items():
                out[f"step.{k}"] = v.numpy()

            # A 20-step fit.
            reset_collective_counts()
            model = mlp.fit(rt, X, y, CLASSES, hidden=HIDDEN, iters=STEPS,
                            lr=LR, l2=L2, params0=p0)
            out["fit_collectives"] = json.dumps(collective_counts())
            out["fit_hidden"] = model.hparams["hidden"]
            for k, v in model.params.items():
                out[f"fit.{k}"] = v.numpy()

            # A width the model axis does not divide.
            narrow = dict(p0, W1=p0["W1"][:, :-1], b1=p0["b1"][:-1],
                          W2=p0["W2"][:-1])
            try:
                mlp.fit(rt, X, y, CLASSES, iters=2, params0=narrow)
                out["refused"] = ""
            except ValueError as exc:
                out["refused"] = str(exc)

            # Crashed at its second checkpoint: the first stays on disk.
            ctx = fitckpt.context(cfg, every=EVERY, **CKPT_KEYS)
            failpoints.configure("fit.ckpt.pre_rename=raise:2")
            try:
                mlp.fit(rt, X, y, CLASSES, hidden=HIDDEN, iters=STEPS,
                        lr=LR, l2=L2, params0=p0, ckpt=ctx)
                out["crashed"] = False
            except failpoints.FailpointError:
                out["crashed"] = True
            finally:
                failpoints.reset()
            for k, v in ctx.load()[1].items():
                out[f"ckpt.{k}"] = v
            # The one-rank resume reads this copy: the resume below
            # checkpoints again.
            shutil.copytree(cfg.store_root, f"{cfg.store_root}_at{EVERY}")
            model = mlp.fit(rt, X, y, CLASSES, hidden=HIDDEN, iters=EVERY,
                            lr=LR, l2=L2, params0=p0)
            for k, v in model.params.items():
                out[f"fit{EVERY}.{k}"] = v.numpy()
            model = mlp.fit(rt, X, y, CLASSES, hidden=HIDDEN, iters=STEPS,
                            lr=LR, l2=L2, params0=p0, ckpt=ctx)
            for k, v in model.params.items():
                out[f"resumed.{k}"] = v.numpy()
        np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(shape, tmp, inputs: dict) -> list:
    dims = MESHES[shape]
    world = dims[0] * dims[1]
    np.savez(os.path.join(tmp, "in.npz"), **inputs)
    ctx = mp.start_processes(
        _rank, args=(world, f"{dims[0]},{dims[1]},1", str(tmp)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"the ranks of the {shape} mesh did not finish "
                            f"within {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    outs = []
    for r in range(world):
        with np.load(os.path.join(tmp, f"out{r}.npz")) as f:
            outs.append(dict(f))
    return outs


def _data():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(CLASSES, D)) * 1.2
    y = rng.integers(0, CLASSES, size=N).astype(np.int32)
    X = (centers[y] + rng.normal(size=(N, D))).astype(np.float32)
    return X * np.float32(3.0) + np.float32(5.0), y


def _jax_runtime(dims):
    import jax

    from learningorchestra_tpu.config import Settings as JaxSettings
    from learningorchestra_tpu.parallel.mesh import MeshRuntime, local_mesh

    cfg = JaxSettings()
    cfg.mesh_shape = f"{dims[0]},{dims[1]}"
    rt = MeshRuntime(cfg)
    rt._mesh = local_mesh(cfg, jax.devices()[:dims[0] * dims[1]])
    return rt


def _jax_side(dims, X, y):
    """The JAX package on the mesh: one train step from its initial draw
    (params on their declared shardings, rows on the data axis) and its
    ``fit`` of ``STEPS`` iterations from the same draw."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from learningorchestra_tpu.models import mlp as jmlp
    from learningorchestra_tpu.parallel.mesh import DATA_AXIS

    rt = _jax_runtime(dims)
    mesh = rt.mesh
    p = jmlp.init_params(jax.random.PRNGKey(SEED), D, HIDDEN, CLASSES)
    p0 = {k: np.asarray(v) for k, v in p.items()
          if k in ("W1", "b1", "W2", "b2")}
    std = X.std(axis=0)
    p["mu"] = jnp.asarray(X.mean(axis=0).astype(np.float32))
    p["sigma"] = jnp.asarray(np.where(std < 1e-7, 1.0, std)
                             .astype(np.float32))
    specs = jmlp.param_specs()
    p = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
         for k, v in p.items()}
    rows = lambda a: jax.device_put(a, NamedSharding(mesh, P(DATA_AXIS)))
    opt = optax.adam(LR)
    p1, _, loss = jax.jit(jmlp.make_train_step(opt))(
        p, opt.init(p), rows(X), rows(y), rows(np.ones(N, np.float32)),
        jnp.float32(L2))
    model = jmlp.fit(rt, X, y, CLASSES, seed=SEED, hidden=HIDDEN,
                     iters=STEPS, lr=LR, l2=L2)
    return {"p0": p0, "step.loss": float(loss),
            **{f"step.{k}": np.asarray(v) for k, v in p1.items()},
            **{f"fit.{k}": np.asarray(v) for k, v in model.params.items()}}


def _one_rank_fit(X, y, p0, iters, ckpt=None):
    from learningorchestra_tpu_torch.config import Settings
    from learningorchestra_tpu_torch.models import mlp
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

    model = mlp.fit(DeviceRuntime(Settings(), device="cpu"), X, y, CLASSES,
                    hidden=HIDDEN, iters=iters, lr=LR, l2=L2, params0=p0,
                    ckpt=ckpt)
    return {k: v.numpy() for k, v in model.params.items()}


def _one_rank_step(X, y, p0):
    from learningorchestra_tpu_torch.models import logistic, mlp

    params = {k: torch.from_numpy(np.array(v)) for k, v in p0.items()}
    mu, sigma = mlp._host_stats(X)
    params["mu"], params["sigma"] = (torch.from_numpy(mu),
                                     torch.from_numpy(sigma))
    Y1 = torch.nn.functional.one_hot(torch.from_numpy(np.array(y)).long(),
                                     CLASSES).float()
    loss, grads = mlp.loss_and_grads(params, torch.from_numpy(np.array(X)),
                                     Y1, torch.ones(N), L2)
    logistic.adam_update(params, grads, mlp._adam_state(params), LR)
    return float(loss), {k: v.numpy() for k, v in params.items()}


def _proba(params, X):
    from learningorchestra_tpu_torch.models import mlp

    return mlp._predict_proba(
        {k: torch.from_numpy(np.array(v)) for k, v in params.items()},
        torch.from_numpy(np.array(X))).numpy()


@pytest.fixture(scope="module", params=sorted(MESHES))
def world(request, tmp_path_factory):
    """Everything the cases compare, for one mesh shape: the JAX side on
    the mesh and on one device, the port's ranks, and the port's
    one-rank step and fit."""
    shape = request.param
    tmp = tmp_path_factory.mktemp(f"mlp_tp_{shape}")
    X, y = _data()
    jx = _jax_side(MESHES[shape], X, y)
    ranks = _spawn(shape, tmp, {
        "X": X, "y": y, **{f"p0.{k}": v for k, v in jx["p0"].items()}})
    loss1, step1 = _one_rank_step(X, y, jx["p0"])
    return {"shape": shape, "dims": MESHES[shape], "X": X, "y": y,
            "tmp": tmp, "jax": jx, "jax1": _jax_side((1, 1), X, y),
            "ranks": ranks,
            "one": {"step.loss": loss1,
                    **{f"step.{k}": v for k, v in step1.items()},
                    **{f"fit.{k}": v for k, v in
                       _one_rank_fit(X, y, jx["p0"], STEPS).items()}}}


def _step_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                               err_msg=what)


def _fit_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=FIT_ATOL,
                               err_msg=what)


def _predicts_alike(got, want, X, y):
    """``test_torch_mlp.py::test_fit_matches_jax``'s fit tolerances on
    the trained models' probabilities."""
    pg, pw = _proba(got, X), _proba(want, X)
    np.testing.assert_allclose(pg, pw, atol=2e-2)
    assert (np.argmax(pg, 1) == np.argmax(pw, 1)).mean() >= 0.99
    acc = lambda p: float((np.argmax(p, 1) == y).mean())
    assert abs(acc(pg) - acc(pw)) <= 0.01


def test_each_rank_holds_its_hidden_slice(world):
    _, m = world["dims"]
    h = HIDDEN // m
    for out in world["ranks"]:
        k = int(out["model_index"])
        cols = slice(k * h, (k + 1) * h)
        np.testing.assert_array_equal(out["slice.W1"],
                                      world["jax"]["p0"]["W1"][:, cols])
        np.testing.assert_array_equal(out["slice.b1"],
                                      world["jax"]["p0"]["b1"][cols])
        np.testing.assert_array_equal(out["slice.W2"],
                                      world["jax"]["p0"]["W2"][cols])
        assert out["slice.W1"].shape == (D, h)
        assert out["slice.W2"].shape == (h, CLASSES)


def test_one_step_matches_jax(world):
    for r, out in enumerate(world["ranks"]):
        np.testing.assert_allclose(float(out["step.loss"]),
                                   world["jax"]["step.loss"], rtol=1e-5)
        for k in PARAMS:
            _step_close(out[f"step.{k}"], world["jax"][f"step.{k}"],
                        f"rank {r} {k}")


def test_twenty_steps_match_jax(world):
    for r, out in enumerate(world["ranks"]):
        for k in PARAMS:
            _fit_close(out[f"fit.{k}"], world["jax"][f"fit.{k}"],
                       f"rank {r} {k}")


def test_mesh_fit_moves_from_the_one_rank_fit_as_jax_does(world):
    """The summed logits' bf16 rounding moves a model-axis fit away from
    the one-device fit in the JAX package; the port's moves by the same
    amounts, and its models predict alike."""
    one, jx, jx1 = world["one"], world["jax"], world["jax1"]
    out = world["ranks"][0]
    np.testing.assert_allclose(
        float(out["step.loss"]) - one["step.loss"],
        jx["step.loss"] - jx1["step.loss"], atol=1e-6)
    for k in PARAMS:
        _step_close(out[f"step.{k}"] - one[f"step.{k}"],
                    jx[f"step.{k}"] - jx1[f"step.{k}"], k)
        _fit_close(out[f"fit.{k}"] - one[f"fit.{k}"],
                   jx[f"fit.{k}"] - jx1[f"fit.{k}"], k)
    _predicts_alike({k: out[f"fit.{k}"] for k in PARAMS},
                    {k: one[f"fit.{k}"] for k in PARAMS}, world["X"],
                    world["y"])


def test_trained_model_is_whole_and_the_same_on_every_rank(world):
    want = {"W1": (D, HIDDEN), "b1": (HIDDEN,), "W2": (HIDDEN, CLASSES),
            "b2": (CLASSES,), "mu": (D,), "sigma": (D,)}
    first = world["ranks"][0]
    for out in world["ranks"]:
        assert int(out["fit_hidden"]) == HIDDEN
        for k, shape in want.items():
            assert out[f"fit.{k}"].shape == shape, k
            np.testing.assert_array_equal(out[f"fit.{k}"],
                                          first[f"fit.{k}"])


def test_two_model_axis_all_reduces_a_step(world):
    """The partial logits and the packed standardization sums: two
    model-axis all-reduces a step, one model-axis all-gather of the
    trained model, and the data axis's sums only where it is split."""
    d, _ = world["dims"]
    for out in world["ranks"]:
        step = json.loads(str(out["step_collectives"]))
        fit = json.loads(str(out["fit_collectives"]))
        assert step.get("all_reduce.model") == 2, step
        assert fit.get("all_reduce.model") == 2 * STEPS, fit
        assert fit.get("all_gather.model") == 1, fit
        assert ("all_reduce.data" in step) == (d > 1), step


def test_checkpoint_is_whole_and_resumes_on_the_mesh_and_on_one_rank(world):
    """The checkpoint at iteration ``EVERY`` holds whole arrays, the
    gathered state of an ``EVERY``-iteration fit; resumed on the mesh it
    gives the uninterrupted fit bit for bit, and resumed on one rank
    (sliced back to whole width) a fit that predicts as it does."""
    from learningorchestra_tpu_torch.config import Settings
    from learningorchestra_tpu_torch.utils import fitckpt

    for out in world["ranks"]:
        assert bool(out["crashed"])
        assert out["ckpt.p.W1"].shape == (D, HIDDEN)
        assert out["ckpt.o.nu.W2"].shape == (HIDDEN, CLASSES)
        assert int(out["ckpt.o.count"]) == EVERY
        for k in PARAMS:
            np.testing.assert_array_equal(out[f"ckpt.p.{k}"],
                                          out[f"fit{EVERY}.{k}"])
            np.testing.assert_array_equal(out[f"resumed.{k}"],
                                          out[f"fit.{k}"])
    cfg = Settings()
    cfg.store_root = str(world["tmp"] / f"ck0_at{EVERY}")
    ctx = fitckpt.context(cfg, every=EVERY, **CKPT_KEYS)
    assert ctx.load()[0] == EVERY
    resumed = _one_rank_fit(world["X"], world["y"], world["jax"]["p0"],
                            STEPS, ckpt=ctx)
    _predicts_alike(resumed, {k: world["ranks"][0][f"fit.{k}"]
                              for k in PARAMS}, world["X"], world["y"])


def test_params0_width_the_model_axis_does_not_divide_is_refused(world):
    _, m = world["dims"]
    for out in world["ranks"]:
        msg = str(out["refused"])
        assert f"hidden width {HIDDEN - 1}" in msg and f"{m} ranks" in msg
