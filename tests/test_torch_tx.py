"""The tx sequence classifier and its process mesh in the PyTorch package,
against the JAX package on the same numpy inputs.

- attention: ``reference_attention`` and blockwise ``ring_attention`` on
  one rank at tests/test_ring_attention.py's ``(T, kv_block)`` cases, and
  the ring over gloo at seq = 2 and seq = 4;
- the transformer: ``forward_reference``, and ``forward_shard``, the loss
  and every leaf's gradient (gathered) on the 1×2×2, 2×1×2 and 2×2×2
  meshes, against JAX's unsharded ``forward_reference`` and
  ``jax.value_and_grad``; 30 training steps of the dominance task beside
  the JAX package's on its 2×2×2 device mesh;
- ``sequence.fit``'s rounding to the mesh, conversion and persistence,
  the validation messages, the bootstrap, and the REST round trip of
  tests/test_sequence.py on the port's ``App``.

Multi-rank cases run in ranks started with ``torch.multiprocessing``
(spawn), joined through a ``FileStore`` under the test's temporary
directory (no TCP port), one thread a rank, each world under its own
timeout. The ranks import this module, so JAX is imported inside the
tests and fixtures only: a rank loads torch and the port.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models import sequence
from learningorchestra_tpu_torch.models import transformer as ttx
from learningorchestra_tpu_torch.models.convert import (
    _flatten_tx, from_jax_params)
from learningorchestra_tpu_torch.parallel import distributed
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, all_gather, local_mesh,
    parse_mesh_shape)
from learningorchestra_tpu_torch.parallel.ring_attention import (
    KV_BLOCK, reference_attention, ring_attention)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

#: The transformer of test_ring_attention.py's forward test.
TXC = dict(vocab=16, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           n_classes=3, max_len=64)
#: Its training test's model (the dominance task).
TRAIN = dict(vocab=8, d_model=32, n_heads=4, n_layers=1, d_ff=64,
             n_classes=2, max_len=32)
TRAIN_STEPS, TRAIN_LR = 30, 3e-3
#: Ring cases over gloo: (T, kv_block) — one chunk a block, and ragged
#: chunks (120 / 4 ranks = 30 keys a block in chunks of 8).
RING_CASES = ((32, KV_BLOCK), (120, 8))
#: Widths that sequence.fit must round to a 2×2×2 mesh.
FIT_KW = dict(d_model=30, n_heads=3, n_layers=1, d_ff=63, train_steps=2,
              batch=7, lr=1e-3)
LAYOUTS = ("1,2,2", "2,1,2", "2,2,2")
SPAWN_TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _block(a, mesh, seq_dim=True):
    """This rank's (data, seq) block of a global (B, T, ...) array."""
    D, S = mesh.size(DATA_AXIS), mesh.size(SEQ_AXIS)
    b = a.shape[0] // D
    out = a[mesh.index(DATA_AXIS) * b:(mesh.index(DATA_AXIS) + 1) * b]
    if seq_dim:
        t = a.shape[1] // S
        out = out[:, mesh.index(SEQ_AXIS) * t:(mesh.index(SEQ_AXIS) + 1) * t]
    return torch.tensor(out)


def _gather_rows(t, mesh, seq_dim=True):
    if seq_dim:
        t = all_gather(t, mesh, SEQ_AXIS, 1)
    return all_gather(t, mesh, DATA_AXIS, 0)


def _rank_work(shape: str, inp: dict) -> dict:
    cfg = Settings()
    cfg.mesh_shape = shape
    mesh = local_mesh(cfg)
    out = {}
    rings = [mesh]
    if shape == "2,2,2":
        rings.append(local_mesh(cfg.replace(mesh_shape="2,1,4")))
    for rm in rings:
        for T, kvb in RING_CASES:
            q, k, v = (_block(inp[f"ring_{n}_{T}"], rm) for n in "qkv")
            for causal in (False, True):
                o = ring_attention(q, k, v, mesh=rm, causal=causal,
                                   kv_block=kvb)
                key = f"ring_s{rm.size(SEQ_AXIS)}_{T}_{causal}"
                out[key] = _gather_rows(o, rm).numpy()

    params = {k[2:]: torch.tensor(v) for k, v in inp.items()
              if k.startswith("p.")}
    tok, lab = _block(inp["tokens"], mesh), _block(inp["labels"], mesh,
                                                    seq_dim=False)
    for causal in (False, True):
        c = ttx.TxConfig(**TXC, causal=causal)
        local = ttx.shard_params(params, c, mesh)
        with torch.no_grad():
            logits = ttx.forward_shard(local, tok, cfg=c, mesh=mesh)
        out[f"fwd_{causal}"] = _gather_rows(logits, mesh, False).numpy()
        for remat in (False, True):
            cr = dataclasses.replace(c, remat=remat)
            names = list(local)
            leaves = [local[n].detach().requires_grad_(True) for n in names]
            loss = ttx.loss_shard(dict(zip(names, leaves)), tok, lab,
                                  cfg=cr, mesh=mesh)
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
            ttx.reduce_grads(grads, mesh)
            out[f"loss_{causal}_{remat}"] = loss.detach().numpy()
            for n, g in ttx.gather_params(grads, cr, mesh).items():
                out[f"grad_{causal}_{remat}.{n}"] = g.numpy()

    if shape == "2,2,2":
        tp = {k[3:]: torch.tensor(v) for k, v in inp.items()
              if k.startswith("tp.")}
        ttok, tlab = _block(inp["train_tokens"], mesh), _block(
            inp["train_labels"], mesh, seq_dim=False)
        for remat in (False, True):
            c = ttx.TxConfig(**TRAIN, remat=remat)
            local = ttx.shard_params(tp, c, mesh)
            state = ttx.adam_init(local)
            losses = []
            for _ in range(TRAIN_STEPS):
                local, state, loss = ttx.train_step(
                    local, state, ttok, tlab, cfg=c, mesh=mesh, lr=TRAIN_LR)
                losses.append(float(loss))
            out[f"train_{remat}"] = np.asarray(losses)
        model = sequence.fit(DeviceRuntime(cfg, device="cpu"),
                             inp["fit_X"], inp["fit_y"], 2, **FIT_KW)
        out["fit_hparams"] = np.asarray(json.dumps(model.hparams))
        for n, v in model.params.items():
            out[f"fit_shape.{n}"] = np.asarray(v.shape)
    return out


def _rank(rank: int, world: int, shape: str, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        with np.load(os.path.join(tmp, "in.npz")) as f:
            inp = dict(f)
        out = _rank_work(shape, inp)
        if rank == 0:
            np.savez(os.path.join(tmp, "out.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(shape: str, inputs: dict, tmp) -> dict:
    """Run ``_rank_work`` on every rank of a ``shape`` mesh; rank 0's
    results. Inputs travel in a file: a large argument would make each
    start wait for the child to read its pipe."""
    world = int(np.prod([int(x) for x in shape.split(",")]))
    np.savez(os.path.join(tmp, "in.npz"), **inputs)
    ctx = mp.start_processes(_rank, args=(world, shape, str(tmp)),
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
    with np.load(os.path.join(tmp, "out.npz")) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# The JAX side and the inputs
# ---------------------------------------------------------------------------

def _jax():
    import jax
    import jax.numpy as jnp

    from learningorchestra_tpu.models import transformer as jtx

    return jax, jnp, jtx


def _dominance(n, T, seed):
    """tests/test_sequence.py's task: label 1 when token 0 dominates."""
    rng = np.random.default_rng(seed)
    X = np.empty((n, T), np.float32)
    y = np.empty(n, np.int32)
    for i in range(n):
        if rng.random() < 0.5:
            X[i], y[i] = rng.integers(1, 8, T), 0
        else:
            X[i] = np.where(rng.random(T) < 0.6, 0, rng.integers(1, 8, T))
            y[i] = 1
    return X, y


@pytest.fixture(scope="module")
def inputs():
    jax, _, jtx = _jax()
    rng = np.random.default_rng(0)
    nested = jax.tree.map(np.asarray, jtx.init_params(
        jax.random.PRNGKey(0), jtx.TxConfig(**TXC)))
    out = {"nested": nested, "ranks": {}}
    ranks = out["ranks"]
    ranks.update({f"p.{k}": v for k, v in _flatten_tx(nested).items()})
    ranks["tokens"] = rng.integers(0, TXC["vocab"], (8, 16)).astype(np.int32)
    ranks["labels"] = rng.integers(0, TXC["n_classes"], 8).astype(np.int32)
    for T, _ in RING_CASES:
        for n in "qkv":
            ranks[f"ring_{n}_{T}"] = rng.normal(
                size=(4, T, 2, 8)).astype(np.float32)
    # test_ring_attention.py's training task and init.
    r1 = np.random.default_rng(1)
    B, T = 32, 16
    labels = r1.integers(0, 2, B).astype(np.int32)
    tokens = np.where(r1.random((B, T)) < 0.7,
                      np.where(labels[:, None] == 1, 2, 5),
                      r1.integers(0, 8, (B, T))).astype(np.int32)
    ranks["train_tokens"], ranks["train_labels"] = tokens, labels
    out["train_nested"] = jax.tree.map(np.asarray, jtx.init_params(
        jax.random.PRNGKey(2), jtx.TxConfig(**TRAIN)))
    ranks.update({f"tp.{k}": v
                  for k, v in _flatten_tx(out["train_nested"]).items()})
    ranks["fit_X"], ranks["fit_y"] = _dominance(40, 15, 3)
    return out


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """Rank 0's results per mesh layout, each world run once: 1×1×1 in
    this process with no process group, the others in spawned ranks."""
    cache = {}

    def get(shape):
        if shape not in cache:
            if shape == "1,1,1":
                cache[shape] = _rank_work(shape, inputs["ranks"])
            else:
                cache[shape] = _spawn(shape, inputs["ranks"],
                                      tmp_path_factory.mktemp("mesh"))
        return cache[shape]

    return get


@pytest.fixture(scope="module")
def jax_ref(inputs):
    """JAX's unsharded logits, loss and gradients, causal both ways."""
    jax, jnp, jtx = _jax()
    tokens = jnp.asarray(inputs["ranks"]["tokens"])
    labels = jnp.asarray(inputs["ranks"]["labels"])
    params = jax.tree.map(jnp.asarray, inputs["nested"])
    out = {}
    for causal in (False, True):
        c = jtx.TxConfig(**TXC, causal=causal)

        def loss_fn(p, c=c):
            logp = jax.nn.log_softmax(jtx.forward_reference(p, tokens, cfg=c))
            return -jnp.take_along_axis(logp, labels[:, None], axis=1).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        out[causal] = {
            "logits": np.asarray(jtx.forward_reference(params, tokens,
                                                       cfg=c)),
            "loss": float(loss),
            "grads": {k: np.asarray(v)
                      for k, v in _flatten_tx(grads).items()}}
    return out


def _tx_hparams(**kw):
    hp = dict(TXC, causal=False)
    hp.update(kw)
    return hp


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

ONE_RANK_CASES = [(128, 8), (120, 8), (104, 12)]


def _qkv(T, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, T, 2, 8)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,kv_block", ONE_RANK_CASES)
def test_reference_attention_matches_jax(causal, T, kv_block):
    _, jnp, _ = _jax()
    from learningorchestra_tpu.parallel.ring_attention import (
        reference_attention as jax_reference)

    q, k, v = _qkv(T)
    want = np.asarray(jax_reference(*map(jnp.asarray, (q, k, v)),
                                    causal=causal))
    got = reference_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,kv_block", ONE_RANK_CASES)
def test_blockwise_ring_on_one_rank_matches_jax(causal, T, kv_block):
    """Blockwise attention on a size-1 seq axis (kv_block < T, ragged
    tails padded and masked) against the JAX package's ring_attention on
    a one-device mesh, at 2e-5."""
    jax, jnp, _ = _jax()
    from jax.sharding import Mesh, PartitionSpec as P

    from learningorchestra_tpu.parallel.ring_attention import (
        ring_attention as jax_ring)

    q, k, v = _qkv(T)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                (DATA_AXIS, MODEL_AXIS, SEQ_AXIS))
    spec = P(DATA_AXIS, SEQ_AXIS)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda q, k, v: jax_ring(q, k, v, axis_name=SEQ_AXIS,
                                 causal=causal, kv_block=kv_block),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))(q, k, v))
    got = ring_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                         kv_block=kv_block)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,kv_block", RING_CASES)
@pytest.mark.parametrize("seq", [2, 4])
def test_ring_over_gloo_matches_reference(runs, inputs, seq, T, kv_block,
                                          causal):
    """The ring over seq ranks (2×2×2 and 2×1×4 meshes of gloo ranks),
    every hop a point-to-point send, against full attention at 2e-5."""
    got = runs("2,2,2")[f"ring_s{seq}_{T}_{causal}"]
    q, k, v = (torch.from_numpy(inputs["ranks"][f"ring_{n}_{T}"])
               for n in "qkv")
    want = reference_attention(q, k, v, causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_forward_reference_matches_jax(inputs, jax_ref, causal):
    model = from_jax_params("tx", inputs["nested"], TXC["n_classes"],
                            _tx_hparams(causal=causal))
    got = ttx.forward_reference(
        model.params, torch.from_numpy(inputs["ranks"]["tokens"]),
        cfg=ttx.TxConfig(**TXC, causal=causal))
    np.testing.assert_allclose(got.numpy(), jax_ref[causal]["logits"],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ("1,1,1",) + LAYOUTS)
def test_forward_shard_matches_jax(runs, jax_ref, layout, causal):
    np.testing.assert_allclose(runs(layout)[f"fwd_{causal}"],
                               jax_ref[causal]["logits"],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ("1,1,1",) + LAYOUTS)
def test_loss_and_every_gradient_match_jax(runs, jax_ref, layout, causal,
                                           remat):
    """The sharded loss and every leaf's gradient, summed over the mesh
    and gathered over the model axis, against ``jax.value_and_grad`` of
    the unsharded loss (rtol 1e-4, atol 1e-5): a leaf summed over an axis
    it was already whole on comes out 2× too large here."""
    res, ref = runs(layout), jax_ref[causal]
    np.testing.assert_allclose(res[f"loss_{causal}_{remat}"], ref["loss"],
                               rtol=1e-4, atol=1e-5)
    names = ttx.param_names(ttx.TxConfig(**TXC))
    assert sorted(ref["grads"]) == sorted(names)
    for n in names:
        np.testing.assert_allclose(
            res[f"grad_{causal}_{remat}.{n}"], ref["grads"][n],
            rtol=1e-4, atol=1e-5, err_msg=n)


@pytest.fixture(scope="module")
def jax_train(inputs):
    """test_ring_attention.py's 30 steps on the JAX 2×2×2 mesh."""
    jax, jnp, jtx = _jax()
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from learningorchestra_tpu.config import Settings as JaxSettings
    from learningorchestra_tpu.parallel.mesh import local_mesh as jax_mesh

    jcfg = JaxSettings()
    jcfg.mesh_shape = "2,2,2"
    mesh = jax_mesh(jcfg)
    tok = jax.device_put(inputs["ranks"]["train_tokens"],
                         NamedSharding(mesh, P(DATA_AXIS, SEQ_AXIS)))
    lab = jax.device_put(inputs["ranks"]["train_labels"],
                         NamedSharding(mesh, P(DATA_AXIS)))
    out = {}
    for remat in (False, True):
        c = jtx.TxConfig(**TRAIN, remat=remat)
        params = jtx.shard_params(
            jax.tree.map(jnp.asarray, inputs["train_nested"]), c, mesh)
        opt = optax.adam(TRAIN_LR)
        state = opt.init(params)
        step = jtx.make_train_step(c, mesh, opt)
        losses = []
        for _ in range(TRAIN_STEPS):
            params, state, loss = step(params, state, tok, lab)
            losses.append(float(loss))
        out[remat] = np.asarray(losses)
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_training_on_the_mesh_tracks_jax(runs, jax_train, remat):
    """The dominance task, 30 Adam steps on 2×2×2 gloo ranks from the JAX
    init: the first 5 losses within 1e-3 relative of the JAX package's on
    its 2×2×2 device mesh, and both below half their first loss."""
    got, want = runs("2,2,2")[f"train_{remat}"], jax_train[remat]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:5], want[:5], rtol=1e-3)
    assert got[-1] < got[0] * 0.5, got[::10]
    assert want[-1] < want[0] * 0.5, want[::10]


def test_fit_rounds_to_the_mesh_like_jax(runs, inputs):
    """T to the seq axis, heads and d_ff to the model axis, d_model to the
    heads, batch to the data axis: the hparams and the gathered params'
    shapes of a 2×2×2 fit are the JAX package's on its 2×2×2 mesh."""
    import jax

    from learningorchestra_tpu.config import Settings as JaxSettings
    from learningorchestra_tpu.models import sequence as jax_sequence
    from learningorchestra_tpu.parallel.mesh import MeshRuntime

    jcfg = JaxSettings()
    jcfg.mesh_shape = "2,2,2"
    jm = jax_sequence.fit(MeshRuntime(jcfg), inputs["ranks"]["fit_X"],
                          inputs["ranks"]["fit_y"], 2, **FIT_KW)
    res = runs("2,2,2")
    hp = json.loads(str(res["fit_hparams"]))
    assert hp == jm.hparams
    assert hp["max_len"] == 16 and hp["n_heads"] == 4 and hp["d_ff"] == 64
    jshapes = {k: tuple(np.shape(v)) for k, v in
               _flatten_tx(jax.tree.map(np.asarray, jm.params)).items()}
    assert {k[len("fit_shape."):]: tuple(int(d) for d in v)
            for k, v in res.items() if k.startswith("fit_shape.")} == jshapes


# ---------------------------------------------------------------------------
# Conversion, persistence, validation, bootstrap
# ---------------------------------------------------------------------------

def test_from_jax_params_predicts_like_jax(inputs):
    """A JAX pytree through ``from_jax_params`` predicts the JAX
    predictor's probabilities (12 of 64 token columns: the padded path)."""
    jax, jnp, _ = _jax()
    from learningorchestra_tpu.models import sequence as jax_sequence

    hp = _tx_hparams(train_steps=1, lr=1e-3)
    X = np.random.default_rng(5).integers(-2, 20, (6, 12)).astype(
        np.float32)
    want = np.asarray(jax_sequence.predictor(hp)(
        jax.tree.map(jnp.asarray, inputs["nested"]), jnp.asarray(X)))
    model = from_jax_params("tx", inputs["nested"], TXC["n_classes"], hp)
    got = model.predict_proba(DeviceRuntime(device="cpu"), X)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unexpected tx params"):
        from_jax_params("tx", dict(inputs["nested"], extra=np.zeros(1)),
                        TXC["n_classes"], hp)


def test_saved_tx_model_loads_bit_identical(inputs, tmp_path):
    from learningorchestra_tpu_torch.models.persistence import ModelRegistry

    cfg = Settings()
    cfg.store_root = str(tmp_path)
    hp = _tx_hparams(train_steps=1, lr=1e-3)
    model = from_jax_params("tx", inputs["nested"], TXC["n_classes"], hp)
    reg = ModelRegistry(cfg)
    reg.save("tx_model", model, metrics={"accuracy": 1.0})
    man, again = reg.load("tx_model")
    assert man["kind"] == "tx" and man["hparams"] == hp
    assert list(again.params) == list(model.params)
    for k, v in model.params.items():
        assert again.params[k].dtype == v.dtype
        assert torch.equal(again.params[k], v), k
    X = inputs["ranks"]["tokens"].astype(np.float32)
    rt = DeviceRuntime(device="cpu")
    np.testing.assert_array_equal(again.predict_proba(rt, X),
                                  model.predict_proba(rt, X))


@pytest.mark.parametrize("hparams", [
    {"d_model": 4}, {"n_heads": 0}, {"causal": 1}, {"batch": True},
    {"vocab": -1}, {"dropout": 0.1}])
def test_out_of_range_tx_hparams_give_jax_messages(hparams):
    from learningorchestra_tpu.models.registry import (
        validate_hparams as jax_validate)
    from learningorchestra_tpu_torch.models.registry import validate_hparams

    with pytest.raises(ValueError) as want:
        jax_validate("tx", hparams)
    with pytest.raises(ValueError) as got:
        validate_hparams("tx", hparams)
    assert str(got.value) == str(want.value)


def test_sequence_longer_than_max_len_gives_jax_messages(inputs):
    jax, jnp, jtx = _jax()
    from learningorchestra_tpu.models import sequence as jax_sequence

    c = ttx.TxConfig(**dict(TXC, max_len=8))
    tokens = inputs["ranks"]["tokens"]            # 16 columns
    with pytest.raises(ValueError) as want:
        jtx.forward_reference(inputs["nested"], jnp.asarray(tokens),
                              cfg=jtx.TxConfig(**dict(TXC, max_len=8)))
    params = from_jax_params("tx", inputs["nested"], 3, _tx_hparams()).params
    with pytest.raises(ValueError) as got:
        ttx.forward_reference(params, torch.from_numpy(tokens), cfg=c)
    assert str(got.value) == str(want.value)
    hp = _tx_hparams(max_len=8)
    with pytest.raises(ValueError) as want:
        jax_sequence.predictor(hp)(inputs["nested"],
                                   jnp.asarray(tokens, jnp.float32))
    with pytest.raises(ValueError) as got:
        sequence.predictor(hp)(params, torch.from_numpy(tokens).float())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape,n", [
    ("", 8), ("2,2,2", 8), ("2,4", 8), ("1,2,4", 8), ("3,3", 8),
    ("1,2,2,2", 8), ("2,2,1", 8)])
def test_mesh_shape_parsing_and_layout_match_jax(shape, n):
    """``parse_mesh_shape`` gives the JAX ``local_mesh``'s axis sizes or
    its message, and rank r sits where device r sits in the JAX mesh."""
    import jax

    from learningorchestra_tpu.config import Settings as JaxSettings
    from learningorchestra_tpu.parallel.mesh import local_mesh as jax_mesh
    from learningorchestra_tpu_torch.parallel.mesh import ProcessMesh

    jcfg = JaxSettings()
    jcfg.mesh_shape = shape
    devices = jax.devices()[:n]
    try:
        jm = jax_mesh(jcfg, devices)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            parse_mesh_shape(shape, n)
        assert str(got.value) == str(exc)
        return
    dims = parse_mesh_shape(shape, n)
    assert dict(jm.shape) == dict(zip((DATA_AXIS, MODEL_AXIS, SEQ_AXIS),
                                      dims))
    where = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    for r, d in enumerate(devices):
        assert tuple(ProcessMesh(dims, r).coords.values()) == where[d.id]
        # Each axis line through rank r is the JAX mesh's line.
        for ax, axis in enumerate((DATA_AXIS, MODEL_AXIS, SEQ_AXIS)):
            sl = list(where[d.id])
            sl[ax] = slice(None)
            line = [dev.id for dev in jm.devices[tuple(sl)]]
            assert [devices[i].id for i in
                    ProcessMesh(dims, r).axis_ranks(axis)] == line


def test_bootstrap_with_nothing_set_is_a_no_op(monkeypatch):
    for var in ("LO_TPU_COORDINATOR", "LO_TPU_NUM_PROCESSES",
                "LO_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert not dist.is_initialized()
    mesh = DeviceRuntime(device="cpu").mesh
    assert dict(mesh.shape) == {"data": 1, "model": 1, "seq": 1}
    assert all(g is None for g in mesh.groups.values())


def test_process_info_has_the_jax_keys():
    from learningorchestra_tpu.parallel import distributed as jax_dist

    info = distributed.process_info()
    assert set(info) == set(jax_dist.process_info())
    assert info["process_count"] == 1 and info["process_index"] == 0


def test_unreachable_coordinator_raises():
    """Rank 1 of 2 with nothing listening at the coordinator: the join
    fails after its timeout instead of running as one process."""
    with pytest.raises(RuntimeError):
        distributed.initialize("127.0.0.1:1", 2, 1, device="cpu",
                               timeout_s=1.0)
    assert not dist.is_initialized()


def test_nccl_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="coordinator address"):
        distributed.initialize("127.0.0.1:1", 2, device="cpu")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# REST
# ---------------------------------------------------------------------------

def _token_csv(path, n, seed, T=16):
    X, y = _dominance(n, T, seed)
    rows = [",".join([f"t{j}" for j in range(T)] + ["label"])]
    rows += [",".join(str(int(t)) for t in x) + f",{int(label)}"
             for x, label in zip(X, y)]
    path.write_text("\n".join(rows) + "\n")
    return f"file://{path}"


def test_tx_rest_end_to_end(tmp_path):
    """tests/test_sequence.py's round trip on the port's App (one rank,
    no process group): tx trains through POST /models, writes its
    prediction dataset, is saved, and re-serves through
    /trained-models; the online tier and /tune refuse it, as the JAX
    package's do."""
    from learningorchestra_tpu_torch.client import Context, DatabaseApi, Model
    from learningorchestra_tpu_torch.serving.app import App

    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    cfg.image_root = str(tmp_path / "images")
    cfg.port = 0
    cfg.persist = True
    app = App(cfg, recover=False, device="cpu")
    assert dict(app.runtime.mesh.shape) == {"data": 1, "model": 1, "seq": 1}
    server = app.serve(background=True)
    try:
        ctx = Context(f"http://127.0.0.1:{server.port}", poll_seconds=0.1,
                      timeout=300)
        db = DatabaseApi(ctx)
        db.create_file("seq_train", _token_csv(tmp_path / "tr.csv", 600, 0),
                       wait=True)
        test_url = _token_csv(tmp_path / "te.csv", 200, 1)
        db.create_file("seq_test", test_url, wait=True)
        model = Model(ctx)
        out = model.create_model(
            "seq_train", "seq_test", "seqpred", ["tx"], "label",
            hparams={"tx": {"train_steps": 150, "batch": 128, "d_model": 32,
                            "d_ff": 64, "n_heads": 2, "lr": 3e-3}})
        rep = out["result"][0]
        assert rep["classifier"] == "tx"
        assert rep["accuracy"] > 0.9, rep
        assert rep["fit_time"] > 0
        docs = db.read_file("seqpred_tx", limit=3)
        assert docs[0]["finished"] is True
        assert set(docs[1]) >= {"_id", "prediction", "probability"}
        names = [m["name"] for m in model.list_trained_models()]
        assert "seqpred_tx" in names
        db.create_file("seq_new", test_url, wait=True)
        model.predict("seqpred_tx", "seq_new", "seq_new_pred", wait=True)
        meta = db.read_file("seq_new_pred", limit=1)[0]
        assert meta["finished"] is True and not meta.get("error")
        rows = db.read_file("seq_new_pred", skip=1, limit=5)
        assert all(r["prediction"] in (0, 1) for r in rows)

        base = f"http://127.0.0.1:{server.port}"
        import requests

        r = requests.post(f"{base}/trained-models/seqpred_tx/predict",
                          json={"rows": [{f"t{j}": 0 for j in range(16)}]},
                          timeout=30)
        assert r.status_code >= 400 and "not servable online" in r.text
        r = requests.post(f"{base}/tune", json={
            "training_filename": "seq_train", "tune_filename": "seq_tune",
            "classificator": "tx", "configs": [{}], "label": "label"},
            timeout=30)
        assert r.status_code == 406 and "no population tune path" in r.text
    finally:
        server.stop()
