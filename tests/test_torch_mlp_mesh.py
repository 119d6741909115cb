"""The PyTorch package's mlp on a model axis of 2, against the JAX
package's on a (1, 2) mesh.

The JAX package rounds ``hidden`` up to a multiple of the mesh's model
axis before it draws the weights (``learningorchestra_tpu/models/mlp.py``
``fit``), so a width the axis does not divide gives a wider model. The
port's ``mlp.fit`` rounds the same way. Its two ranks are spawned with
``torch.multiprocessing`` (start method spawn), joined over gloo through
a ``FileStore`` under the test's temporary directory, one thread a rank,
with ``LO_TPU_MESH_SHAPE=1,2,1``, and fit inside an SPMD mesh scope as a
dispatched job does; inputs and results travel in npz files. The JAX
side runs on the first two of tests/conftest.py's 8 CPU devices, with
``mesh_shape`` "1,2". Checked: the saved ``hidden``, the shapes of W1
and W2, and that the saved model, loaded back, predicts a probability
row for every input row. The ranks import this module, so JAX is
imported inside the test only.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

D, CLASSES, N, HIDDEN, ITERS = 5, 3, 120, 3, 5
MESH_SHAPE = "1,2,1"
SPAWN_TIMEOUT_S = 120.0


def _rank(rank: int, tmp: str) -> None:
    os.environ["LO_TPU_MESH_SHAPE"] = MESH_SHAPE
    torch.set_num_threads(1)
    from learningorchestra_tpu_torch.config import Settings
    from learningorchestra_tpu_torch.models import mlp
    from learningorchestra_tpu_torch.models.persistence import (
        ModelRegistry)
    from learningorchestra_tpu_torch.parallel import spmd
    from learningorchestra_tpu_torch.parallel.mesh import MODEL_AXIS
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 2),
        rank=rank, world_size=2)
    try:
        with np.load(os.path.join(tmp, "in.npz")) as f:
            X, y = f["X"], f["y"]
        cfg = Settings()
        cfg.store_root = os.path.join(tmp, f"store{rank}")
        rt = DeviceRuntime(cfg, device="cpu")
        with spmd.mesh_scope():
            model = mlp.fit(rt, X, y, CLASSES, hidden=HIDDEN, iters=ITERS)
            reg = ModelRegistry(cfg)
            reg.save("m", model)
            man, back = reg.load("m")
            proba = back.predict_proba(rt, X)
        if rank == 0:
            np.savez(os.path.join(tmp, "out.npz"),
                     model_axis=np.asarray(rt.mesh.size(MODEL_AXIS)),
                     hparams=np.asarray(json.dumps(model.hparams)),
                     saved_hparams=np.asarray(json.dumps(man["hparams"])),
                     W1=back.params["W1"].numpy(),
                     W2=back.params["W2"].numpy(), proba=proba)
    finally:
        dist.destroy_process_group()


def _spawn(inputs: dict, tmp) -> dict:
    np.savez(os.path.join(tmp, "in.npz"), **inputs)
    ctx = mp.start_processes(_rank, args=(str(tmp),), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"the ranks of the {MESH_SHAPE} mesh did not "
                            f"finish within {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    with np.load(os.path.join(tmp, "out.npz")) as f:
        return dict(f)


def _jax_fit(X, y):
    import jax

    from learningorchestra_tpu.config import Settings as JaxSettings
    from learningorchestra_tpu.models import mlp as jmlp
    from learningorchestra_tpu.parallel.mesh import MeshRuntime, local_mesh

    cfg = JaxSettings()
    cfg.mesh_shape = "1,2"
    rt = MeshRuntime(cfg)
    rt._mesh = local_mesh(cfg, jax.devices()[:2])
    model = jmlp.fit(rt, X, y, CLASSES, hidden=HIDDEN, iters=ITERS)
    return model, model.predict_proba(rt, X)


def test_hidden_rounds_to_the_model_axis_as_jax_does(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = rng.integers(0, CLASSES, N).astype(np.int32)
    jmodel, jproba = _jax_fit(X, y)
    got = _spawn({"X": X, "y": y}, tmp_path)

    want_hidden = int(jmodel.hparams["hidden"])
    assert want_hidden == 4
    assert int(got["model_axis"]) == 2
    for key in ("hparams", "saved_hparams"):
        assert json.loads(str(got[key]))["hidden"] == want_hidden, key
    assert got["W1"].shape == np.asarray(jmodel.params["W1"]).shape \
        == (D, want_hidden)
    assert got["W2"].shape == np.asarray(jmodel.params["W2"]).shape \
        == (want_hidden, CLASSES)
    proba = got["proba"]
    assert proba.shape == np.asarray(jproba).shape == (N, CLASSES)
    assert np.isfinite(proba).all()
    np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-5)
