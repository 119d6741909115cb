"""The ``tx`` family's ``mla_moe`` block (Moonlight-16B-A3B's: latent
attention, a dense SwiGLU layer, sigmoid-routed experts) against the
plain reference ``tests/ref_moonlight.py`` (a copy of
``portbench/reference/moonlight.py``) at a small size on the CPU.

- the initial draws, ``forward_reference``'s logits, and on the 1×1×1,
  1×2×2 and 2×1×2 meshes ``forward_shard``'s logits, the loss and every
  leaf's gradient, three training steps, the balance loss, the expert
  loads and the correction-bias update;
- the routing: distinct experts a token, the dispatch against a dense
  sum, no token dropped when every token is forced to one expert;
- the ring with a value width other than the scores', on one rank and
  over the seq axis;
- the blockwise predictor against full attention (today's block) and
  against one chunk, persistence, conversion, validation and REST;
- every block of ``transformer.BLOCKS`` (this one and the encoder)
  against the contract the trainer, registry and predictor rely on.

Every tolerance below is two float32 programs that sum in different
orders: the program folds attention online and sums a batch at once,
the reference takes the softmax in two passes a sequence at a time.
Their differences were measured at 1e-8–1e-7 here; each bound leaves
room above that and stays far below what a wrong formula gives.

Multi-rank cases run in ranks started with ``torch.multiprocessing``
(spawn), joined through a ``FileStore`` under the test's temporary
directory, one thread a rank, as ``tests/test_torch_tx.py`` does.
"""

import dataclasses
import filecmp
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import ref_moonlight as ref
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models import moe, sequence
from learningorchestra_tpu_torch.models import transformer as ttx
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, ProcessMesh, all_gather, local_mesh,
    psum)
from learningorchestra_tpu_torch.parallel.ring_attention import (
    reference_attention, ring_attention)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import regions

REPO = Path(__file__).resolve().parents[1]
#: The small block: 4 heads, rope 8, nope 16, v 16, latent 32, 8 experts,
#: 2 a token, 1 shared, one dense layer and two expert layers.
MLA = dict(ttx.BLOCKS["mla_moe"].fields, kv_lora_rank=32,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
           moe_intermediate_size=24, first_k_dense_replace=1)
SMALL = dict(vocab=40, d_model=64, n_heads=4, n_layers=3, d_ff=96,
             n_classes=3, max_len=16, causal=True, block="mla_moe", **MLA)
B, T, SEED, STEPS, LR = 4, 16, 5, 3, 1e-3
CPU = torch.device("cpu")
LAYOUTS = ("1,2,2", "2,1,2")
SPAWN_TIMEOUT_S = 120
#: Logits and losses: measured ≤ 5e-8 apart.
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
#: A gradient leaf, against the largest entry of the reference's.
GRAD_TOL = 1e-5
#: Parameters after Adam steps, ||P − P_ref|| / ||P_ref − P_0|| a leaf:
#: Adam moves a weight by about lr whatever its gradient's size, so an
#: entry whose gradient is within rounding of zero may go either way;
#: measured ≤ 2e-5.
STEP_TOL = 1e-3


def _cfg(**kw):
    return ttx.TxConfig(**dict(SMALL, **kw))


def _rcfg(cfg=None):
    return ref.config(**dataclasses.asdict(cfg or _cfg()))


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, SMALL["vocab"], (B, T), generator=g)
    labels = torch.randint(0, SMALL["n_classes"], (B,), generator=g)
    return tokens, labels


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _block(a, mesh, seq_dim=True):
    D, S = mesh.size(DATA_AXIS), mesh.size(SEQ_AXIS)
    b = a.shape[0] // D
    out = a[mesh.index(DATA_AXIS) * b:(mesh.index(DATA_AXIS) + 1) * b]
    if seq_dim:
        t = a.shape[1] // S
        out = out[:, mesh.index(SEQ_AXIS) * t:(mesh.index(SEQ_AXIS) + 1) * t]
    return torch.as_tensor(np.ascontiguousarray(out))


def _gather_rows(t, mesh, seq_dim=True):
    if seq_dim:
        t = all_gather(t, mesh, SEQ_AXIS, 1)
    return all_gather(t, mesh, DATA_AXIS, 0)


def _rank_work(shape: str, inp: dict) -> dict:
    cfg = Settings()
    cfg.mesh_shape = shape
    mesh = local_mesh(cfg)
    c = _cfg()
    out = {}
    # The ring with v narrower than q and k.
    q, k, v = (_block(inp[f"ring_{n}"], mesh) for n in "qkv")
    for causal in (False, True):
        o = ring_attention(q, k, v, mesh=mesh, causal=causal, kv_block=4)
        out[f"ring_{causal}"] = _gather_rows(o, mesh).numpy()

    whole = {kk[2:]: torch.tensor(vv) for kk, vv in inp.items()
             if kk.startswith("p.")}
    tok = _block(inp["tokens"], mesh)
    lab = _block(inp["labels"], mesh, seq_dim=False)
    local = ttx.shard_params(whole, c, mesh)
    with torch.no_grad():
        logits = ttx.forward_shard(local, tok, cfg=c, mesh=mesh)
    out["fwd"] = _gather_rows(logits, mesh, False).numpy()
    for remat in (False, True):
        cr = dataclasses.replace(c, remat=remat)
        names = [n for n in local if ttx.trainable(n)]
        leaves = [local[n].detach().requires_grad_(True) for n in names]
        full = dict(local, **dict(zip(names, leaves)))
        aux = {}
        loss = ttx.loss_shard(full, tok, lab, cfg=cr, mesh=mesh, aux=aux)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        ttx.reduce_grads(grads, mesh)
        out[f"loss_{remat}"] = loss.detach().numpy()
        specs = ttx.param_specs(cr)
        for n, g in grads.items():
            if specs[n] is not None:
                g = all_gather(g, mesh, MODEL_AXIS, specs[n])
            out[f"grad_{remat}.{n}"] = g.numpy()
        with torch.no_grad():
            bal = psum(sum(aux["balance"]).detach(), mesh, DATA_AXIS) / B
            out[f"balance_{remat}"] = bal.numpy()
            for i, load in zip(range(cr.first_k_dense_replace, cr.n_layers),
                               aux["loads"]):
                load = load.to(torch.float32)
                load = psum(psum(load, mesh, DATA_AXIS), mesh, SEQ_AXIS)
                out[f"load_{remat}.{i}"] = load.numpy()
    state = ttx.adam_init(local)
    losses = []
    for _ in range(STEPS):
        local, state, loss = ttx.train_step(local, state, tok, lab, cfg=c,
                                            mesh=mesh, lr=LR)
        losses.append(float(loss))
        if "bias_after_1" not in out:
            out["bias_after_1"] = np.stack([
                local[f"layers.{i}.e_bias"].numpy()
                for i in range(c.first_k_dense_replace, c.n_layers)])
    out["train_losses"] = np.asarray(losses)
    for n, v in ttx.gather_params(local, c, mesh).items():
        out[f"trained.{n}"] = v.numpy()
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
# Inputs and the reference's side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    params = ref.init_params(_rcfg(), SEED, "cpu")
    tokens, labels = _inputs()
    rng = np.random.default_rng(1)
    out = {f"p.{k}": v.numpy() for k, v in params.items()}
    out["tokens"], out["labels"] = tokens.numpy(), labels.numpy()
    out["ring_q"] = rng.normal(size=(B, T, 2, 12)).astype(np.float32)
    out["ring_k"] = rng.normal(size=(B, T, 2, 12)).astype(np.float32)
    out["ring_v"] = rng.normal(size=(B, T, 2, 8)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            if shape == "1,1,1":
                cache[shape] = _rank_work(shape, inputs)
            else:
                cache[shape] = _spawn(shape, inputs,
                                      tmp_path_factory.mktemp("mesh"))
        return cache[shape]

    return get


@pytest.fixture(scope="module")
def want(inputs):
    """The reference's logits, loss, gradients, balance loss, loads, bias
    after one step, and three steps' losses and parameters."""
    cfg = _rcfg()
    params = ref.init_params(cfg, SEED, "cpu")
    tokens, labels = _inputs()
    out = {"logits": ref.forward(params, tokens, cfg, key_block=4).numpy()}
    names = [k for k in params if ref.trainable(k)]
    leaves = {k: params[k].detach().requires_grad_(True) for k in names}
    full = dict(params, **leaves)
    total, bal, loads = 0.0, 0.0, {}
    for b in range(B):
        loss, _, recs = ref.sequence_loss(full, tokens[b], labels[b], cfg,
                                          key_block=4)
        (loss / B).backward()
        total += float(loss.detach())
        for i, _, bb, load in recs:
            bal += float(bb.detach())
            loads[i] = loads.get(i, 0) + load
    out["loss"], out["balance"] = total / B, bal / B
    out["grads"] = {k: leaves[k].grad.numpy() for k in names}
    out["loads"] = {i: v.numpy() for i, v in loads.items()}
    p3 = ref.init_params(cfg, SEED, "cpu")
    state = ref.adam_init(p3)
    out["train_losses"] = []
    for s in range(STEPS):
        out["train_losses"].append(ref.step(p3, state, tokens, labels, cfg,
                                            LR, key_block=4))
        if s == 0:
            out["bias_after_1"] = np.stack([
                p3[f"layers.{i}.e_bias"].numpy() for i in loads])
    out["init"] = {k: v.numpy() for k, v in params.items()}
    out["trained"] = {k: v.numpy() for k, v in p3.items()}
    return out


# ---------------------------------------------------------------------------
# The reference itself
# ---------------------------------------------------------------------------

def test_reference_copies_are_identical():
    """The benchmark's reference and the tests' copy are the same file."""
    assert filecmp.cmp(REPO / "tests" / "ref_moonlight.py",
                       REPO / "portbench" / "reference" / "moonlight.py",
                       shallow=False)


def test_reference_imports_nothing_of_the_program():
    import ast

    tree = ast.parse((REPO / "tests" / "ref_moonlight.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in names if m.startswith(("learningorchestra",
                                                  "jax", "portbench"))}


def test_initial_draws_are_the_references():
    """Drawn leaf by leaf in one order from one seeded generator, the
    program's parameters are the reference's, bit for bit."""
    mine = ttx.BLOCKS["mla_moe"].init(SEED, _cfg(), ttx.ONE_RANK, CPU)
    theirs = ref.init_params(_rcfg(), SEED, "cpu")
    assert list(mine) == list(theirs) == ttx.param_names(_cfg())
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k


# ---------------------------------------------------------------------------
# The block against the reference
# ---------------------------------------------------------------------------

def test_forward_reference_matches_reference(inputs, want):
    params = {k[2:]: torch.tensor(v) for k, v in inputs.items()
              if k.startswith("p.")}
    got = ttx.forward_reference(params, torch.tensor(inputs["tokens"]),
                                cfg=_cfg())
    np.testing.assert_allclose(got.numpy(), want["logits"], **LOGIT_TOL)


@pytest.mark.parametrize("layout", ("1,1,1",) + LAYOUTS)
def test_forward_shard_matches_reference(runs, want, layout):
    np.testing.assert_allclose(runs(layout)["fwd"], want["logits"],
                               **LOGIT_TOL)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("layout", ("1,1,1",) + LAYOUTS)
def test_loss_and_every_gradient_match_reference(runs, want, layout, remat):
    """The loss (cross-entropy plus α times the balance loss) and every
    trained leaf's gradient, summed over the mesh and gathered over the
    model axis: a leaf summed over an axis it was already whole on, or a
    replicated value entering a split region without ``pvary``, comes out
    off by a factor of the axis size."""
    res = runs(layout)
    np.testing.assert_allclose(res[f"loss_{remat}"], want["loss"],
                               **LOGIT_TOL)
    names = [k for k in ttx.param_names(_cfg()) if ttx.trainable(k)]
    assert sorted(want["grads"]) == sorted(names)
    for n in names:
        ref_g = want["grads"][n]
        scale = max(float(np.abs(ref_g).max()), 1e-12)
        np.testing.assert_allclose(res[f"grad_{remat}.{n}"], ref_g, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=n)


@pytest.mark.parametrize("layout", ("1,1,1",) + LAYOUTS)
def test_balance_loss_and_loads_match_reference(runs, want, layout):
    """The sequence-wise balance loss (each sequence's f and P over its
    whole length, across the seq ranks) and the expert loads (summed
    over data and seq)."""
    res = runs(layout)
    for remat in (False, True):
        np.testing.assert_allclose(res[f"balance_{remat}"], want["balance"],
                                   **LOGIT_TOL)
        for i, load in want["loads"].items():
            np.testing.assert_array_equal(res[f"load_{remat}.{i}"], load)


@pytest.mark.parametrize("layout", ("1,1,1",) + LAYOUTS)
def test_bias_update_matches_reference(runs, want, layout):
    """After one step every rank's correction biases are the reference's
    ±γ steps, exactly."""
    np.testing.assert_array_equal(runs(layout)["bias_after_1"],
                                  want["bias_after_1"])


@pytest.mark.parametrize("layout", ("1,1,1",) + LAYOUTS)
def test_three_training_steps_match_reference(runs, want, layout):
    res = runs(layout)
    np.testing.assert_allclose(res["train_losses"], want["train_losses"],
                               rtol=1e-5)
    for n, p_ref in want["trained"].items():
        moved = np.linalg.norm(p_ref - want["init"][n])
        off = np.linalg.norm(res[f"trained.{n}"] - p_ref)
        assert off <= STEP_TOL * max(moved, 1e-30), (n, off, moved)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _layer_inputs(seed, N=40, d=16, E=8, I=12):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, d), generator=g)
    w = {"router": torch.randn((d, E), generator=g) * 0.5,
         "e_bias": torch.zeros(E),
         "experts_w1": torch.randn((E, d, I), generator=g) * 0.2,
         "experts_w3": torch.randn((E, d, I), generator=g) * 0.2,
         "experts_w2": torch.randn((E, I, d), generator=g) * 0.2}
    return x, w


def _dense(x, w, idx, g):
    """Σ_j g[t, j] E_{idx[t, j]}(x[t]), one token at a time."""
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            out[t] += g[t, j] * moe.swiglu(
                x[t:t + 1], w["experts_w1"][e], w["experts_w3"][e],
                w["experts_w2"][e])[0]
    return out


@pytest.mark.parametrize("k", [1, 2, 6])
def test_every_token_gets_k_distinct_experts(k):
    x, w = _layer_inputs(0)
    _, idx, g = moe.route(x, w["router"], w["e_bias"], k, 2.446)
    assert idx.shape == (x.shape[0], k)
    assert all(len(set(row.tolist())) == k for row in idx)
    np.testing.assert_allclose(g.sum(-1).numpy(), 2.446, rtol=1e-6)


def test_bias_steers_selection_not_gates():
    x, w = _layer_inputs(1)
    s, idx, g = moe.route(x, w["router"], w["e_bias"], 2, 1.0)
    bias = torch.zeros(8)
    bias[3] = 10.0
    s2, idx2, g2 = moe.route(x, w["router"], bias, 2, 1.0)
    assert torch.equal(s, s2)
    assert (idx2 == 3).any(-1).all()
    # The gates are the chosen scores, normalised: the bias is not in them.
    chosen = s2.gather(1, idx2)
    torch.testing.assert_close(g2, chosen / chosen.sum(-1, keepdim=True))


@pytest.mark.parametrize("short", [0, 1])
@pytest.mark.parametrize("k", [1, 2])
def test_dispatch_equals_the_dense_sum(k, short):
    """With the router's row counts every pair is taken and no row is
    short. With counts one short (as a capacity limit would give) the
    last pair in expert order is not taken: its row misses that
    expert's term, and dispatch counts one row short."""
    x, w = _layer_inputs(2)
    _, idx, g = moe.route(x, w["router"], w["e_bias"], k, 2.446)
    loads = torch.bincount(idx.reshape(-1), minlength=8).tolist()
    loads[max(e for e, c in enumerate(loads) if c)] -= short
    got, n_short = moe.dispatch(x, idx, g, loads, w["experts_w1"],
                                w["experts_w3"], w["experts_w2"])
    assert n_short == short
    taken = g.clone()
    if short:
        order = torch.argsort(idx.reshape(-1), stable=True)
        taken.view(-1)[order[-1]] = 0.0
    torch.testing.assert_close(got, _dense(x, w, idx, taken), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_no_token_dropped_when_all_go_to_one_expert(k):
    """A correction bias of 100 on expert 5 sends every token there: with
    no capacity limit expert 5 takes all N rows, every token keeps its k
    experts, the counter of dropped tokens stays 0 and the output is the
    dense sum."""
    x, w = _layer_inputs(3)
    w["e_bias"][5] = 100.0
    c = _cfg(n_routed_experts=8, num_experts_per_tok=k, n_shared_experts=0,
             d_model=16)
    moe.reset_counts()
    out, _, load = moe.moe_layer(x[None], w, cfg=c, mesh=ttx.ONE_RANK,
                                 layer=1)
    assert int(load[5]) == x.shape[0] and int(load.sum()) == k * x.shape[0]
    counts = moe.counts()
    assert counts["tokens_dropped"] == 0
    assert counts["tokens_routed"] == x.shape[0]
    assert counts["loads"][1] == (x.shape[0], k * x.shape[0] / 8)
    _, idx, g = moe.route(x, w["router"], w["e_bias"], k,
                          c.routed_scaling_factor)
    torch.testing.assert_close(out[0], _dense(x, w, idx, g), rtol=1e-5,
                               atol=1e-6)


def test_route_observer_sees_each_forward():
    x, w = _layer_inputs(4)
    seen = []
    moe.set_route_observer(lambda layer, idx: seen.append((layer, idx)))
    try:
        moe.moe_layer(x[None], w, cfg=_cfg(n_shared_experts=0, d_model=16),
                      mesh=ttx.ONE_RANK, layer=2)
    finally:
        moe.set_route_observer(None)
    assert len(seen) == 1 and seen[0][0] == 2
    assert seen[0][1].shape == (x.shape[0], 2)


# ---------------------------------------------------------------------------
# Attention with a value width of its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_block", [4, 5, 16])
def test_blockwise_ring_with_narrower_values_on_one_rank(inputs, causal,
                                                         kv_block):
    q, k, v = (torch.tensor(inputs[f"ring_{n}"]) for n in "qkv")
    got = ring_attention(q, k, v, causal=causal, kv_block=kv_block)
    assert got.shape == v.shape
    want = reference_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_ring_with_narrower_values_over_gloo(runs, inputs, layout, causal):
    """The ring over 2 seq ranks, keys carrying their global positions,
    values 8 wide against scores 12 wide."""
    q, k, v = (torch.tensor(inputs[f"ring_{n}"]) for n in "qkv")
    want = reference_attention(q, k, v, causal=causal).numpy()
    np.testing.assert_allclose(runs(layout)[f"ring_{causal}"], want,
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The predictor, persistence, conversion
# ---------------------------------------------------------------------------

#: The blockwise predictor against full attention on today's block: PR 9
#: measured 6.1e-7 on the card between the two.
BLOCKWISE_TOL = 6.1e-7


def test_blockwise_predictor_matches_full_attention_on_the_encoder():
    c = ttx.TxConfig(vocab=30, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                     n_classes=3, max_len=40)
    params = ttx.init_params(torch.Generator().manual_seed(0), c)
    hp = {"vocab": 30, "d_model": 32, "n_heads": 4, "n_layers": 2,
          "d_ff": 64, "n_classes": 3, "max_len": 40, "causal": False}
    X = torch.randint(0, 30, (5, 40)).float()
    with torch.no_grad():
        full = torch.softmax(ttx.forward_reference(params, X.long(), cfg=c),
                             -1)
    got = sequence.predictor(hp)(params, X)
    assert float((got - full).abs().max()) <= BLOCKWISE_TOL


def test_predictor_chunks_give_one_chunks_probabilities(monkeypatch):
    """Row chunks bounded by ``PREDICT_BYTES``: one row a chunk gives the
    probabilities of all rows in one chunk (within rounding: the experts'
    products see other row counts)."""
    c = _cfg()
    params = ref.init_params(_rcfg(c), SEED, "cpu")
    hp = dict(SMALL, block="mla_moe", train_steps=1, lr=LR)
    X = _inputs(3)[0].float()
    one = sequence.predictor(hp)(params, X)
    spans = []
    monkeypatch.setattr(sequence, "PREDICT_BYTES",
                        sequence.row_bytes(sequence.config_from_hparams(hp)))
    from learningorchestra_tpu_torch.utils import tracing

    with tracing.trace("t", sampled=True) as ctx:
        rowwise = sequence.predictor(hp)(params, X)
    spans = [s for s in tracing.spans_for(ctx.trace_id)
             if s["name"] == "tx.predict"]
    assert [s["attrs"]["rows"] for s in spans] == [1] * B
    torch.testing.assert_close(rowwise, one, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        one.numpy(), torch.softmax(ref.forward(params, X.long(), _rcfg(c)),
                                   -1).numpy(), rtol=1e-5, atol=1e-6)


def _fit_small(**kw):
    X = np.random.default_rng(0).integers(0, 40, (24, 16)).astype(np.float32)
    y = np.random.default_rng(1).integers(0, 3, 24)
    hp = dict(SMALL, train_steps=2, batch=4)
    for k in ("n_classes", "max_len"):
        hp.pop(k)
    hp.update(kw)
    return X, y, sequence.fit(DeviceRuntime(device="cpu"), X, y, 3, **hp)


def test_fit_records_losses_spans_and_counters():
    from learningorchestra_tpu_torch.utils import tracing

    moe.reset_counts()
    with tracing.trace("t", sampled=True) as ctx:
        _, _, model = _fit_small()
    spans = tracing.spans_for(ctx.trace_id)
    steps = [s for s in spans if s["name"] == "tx.step"]
    init = [s for s in spans if s["name"] == "tx.init"]
    assert len(steps) == 2 and len(init) == 1
    assert init[0]["attrs"]["params"] == sum(
        v.numel() for v in model.params.values())
    assert init[0]["attrs"]["bytes"] == 4 * init[0]["attrs"]["params"]
    losses = sequence.fit_losses()
    assert [s["attrs"]["loss"] for s in steps] == losses
    assert all(s["attrs"]["tokens"] == 4 * 16 for s in steps)
    assert all(s["attrs"]["load_ratio"] >= 1.0 for s in steps)
    counts = moe.counts()
    # Two steps of 64 tokens through two expert layers (a recomputed
    # forward adds nothing); two bias updates a step.
    assert counts["tokens_routed"] == 2 * 2 * 64
    assert counts["tokens_dropped"] == 0
    assert counts["bias_updates"] == 2 * 2
    assert model.hparams["block"] == "mla_moe"
    assert model.hparams["kv_lora_rank"] == MLA["kv_lora_rank"]


def test_saved_mla_model_reloads_bit_identical(tmp_path):
    from learningorchestra_tpu_torch.models.persistence import ModelRegistry

    X, _, model = _fit_small()
    cfg = Settings()
    cfg.store_root = str(tmp_path)
    reg = ModelRegistry(cfg)
    reg.save("mla_model", model, metrics={"accuracy": 1.0})
    man, again = reg.load("mla_model")
    assert man["kind"] == "tx" and man["hparams"] == model.hparams
    assert list(again.params) == list(model.params)
    for k, v in model.params.items():
        assert torch.equal(again.params[k], v), k
    rt = DeviceRuntime(device="cpu")
    np.testing.assert_array_equal(again.predict_proba(rt, X),
                                  model.predict_proba(rt, X))


def test_from_jax_params_refuses_the_mla_block():
    from learningorchestra_tpu_torch.models.convert import from_jax_params

    with pytest.raises(ValueError, match="no tx block 'mla_moe'"):
        from_jax_params("tx", {}, 3, dict(SMALL, block="mla_moe"))


def test_region_timer_attributes_time_to_the_innermost_region():
    """Going forward mla then moe; backward (with a recomputed mla inside
    moe's backward) moe, then mla: each gap between two events goes to the
    innermost region open across it."""

    class Ev:
        clock = [0.0]

        def record(self):
            self.t = Ev.clock[0]

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    timer = regions.RegionTimer(make_event=Ev)

    def at(t, region, edge):
        Ev.clock[0] = t
        timer.record(region, edge)

    O, C = regions.OPEN, regions.CLOSE
    at(0.0, "mla", O), at(1.0, "mla", C), at(1.5, "moe", O), at(3.5, "moe", C)
    at(4.0, "moe", O), at(4.5, "mla", O), at(5.0, "mla", C)
    at(7.0, "moe", C), at(7.2, "mla", O), at(8.2, "mla", C)
    got = timer.seconds()
    assert got == pytest.approx({"mla": 1.0 + 0.5 + 1.0,
                                 "moe": 2.0 + 0.5 + 2.0})


def test_region_marks_pair_up_in_a_remat_step():
    """A traced step's marks, counted: every region opened is closed, in
    the forward pass, the recomputation and the backward pass."""
    events = []

    class Ev:
        def record(self):
            pass

        def elapsed_time(self, other):
            return 0.0

    timer = regions.RegionTimer(make_event=Ev)
    real = timer.record

    def record(region, edge):
        events.append((region, edge))
        real(region, edge)

    timer.record = record
    c = _cfg(remat=True)
    params = ttx.BLOCKS["mla_moe"].init(1, c, ttx.ONE_RANK, CPU)
    tokens, labels = _inputs()
    ttx.train_step(params, ttx.adam_init(params), tokens, labels, cfg=c,
                   mesh=ttx.ONE_RANK, lr=LR, aux={"timer": timer})
    for region, layers in (("mla", 3), ("moe", 2)):
        opens = sum(1 for r, e in events if r == region and e > 0)
        closes = sum(1 for r, e in events if r == region and e < 0)
        # Forward, the recomputation and the backward pass.
        assert opens == closes == 3 * layers, (region, events)


# ---------------------------------------------------------------------------
# Every block's contract
# ---------------------------------------------------------------------------

#: A small config of each block of ``transformer.BLOCKS``: a new block
#: adds its entry here, and the contract test runs on it.
BLOCK_CFGS = {
    "encoder": dict(vocab=30, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                    n_classes=3, max_len=16),
    "mla_moe": SMALL,
    "kda_mla_moe": dict({k: v for k, v in SMALL.items()
                         if k != "rope_theta"},
                        block="kda_mla_moe", n_layers=4,
                        linear_num_heads=4, linear_head_dim=8,
                        experts_held=4, expert_share=1),
}


@pytest.mark.parametrize("block", list(ttx.BLOCKS))
def test_every_block_keeps_the_contract(block, tmp_path):
    """Leaf names, shapes and model-axis splits agree with the drawn
    params; two model ranks draw (or cut) their slices of the whole and
    one rank gathers it back; the sharded forward on one rank is the
    oracle's; a saved model's hparams give the config back; the
    predictor's row estimate is positive; and a block's fields are
    refused under any other block, and with its name under another
    family."""
    from learningorchestra_tpu_torch.models.persistence import ModelRegistry
    from learningorchestra_tpu_torch.models.registry import validate_hparams

    hp = dict(BLOCK_CFGS[block], block=block)
    c, blk = ttx.TxConfig(**hp), ttx.BLOCKS[block]
    names, shapes = ttx.param_names(c), ttx.param_shapes(c)
    specs = ttx.param_specs(c)
    assert list(shapes) == list(specs) == names
    whole = blk.init(SEED, c, ttx.ONE_RANK, CPU)
    assert {k: tuple(v.shape) for k, v in whole.items()} == shapes
    assert list(whole) == names
    ranks = [ProcessMesh((1, 2, 1), rank=r) for r in range(2)]
    shards = [ttx.shard_params(whole, c, m) for m in ranks]
    for m, shard in zip(ranks, shards):
        drawn = blk.init(SEED, c, m, CPU)
        assert all(torch.equal(drawn[k], shard[k]) for k in names)
    for k in names:
        got = (shards[0][k] if specs[k] is None
               else torch.cat([sh[k] for sh in shards], dim=specs[k]))
        assert torch.equal(got, whole[k]), k
    back = ttx.gather_params(ttx.shard_params(whole, c, ttx.ONE_RANK), c,
                             ttx.ONE_RANK)
    assert all(torch.equal(back[k], whole[k]) for k in names)

    tokens = torch.randint(0, c.vocab, (B, c.max_len),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = ttx.forward_shard(whole, tokens, cfg=c, mesh=ttx.ONE_RANK)
        want = ttx.forward_reference(whole, tokens, cfg=c)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)

    X = np.random.default_rng(0).integers(0, c.vocab, (12, c.max_len))
    y = np.random.default_rng(1).integers(0, c.n_classes, 12)
    kw = {k: v for k, v in hp.items() if k not in ("n_classes", "max_len")}
    model = sequence.fit(DeviceRuntime(device="cpu"), X.astype(np.float32),
                         y, c.n_classes, train_steps=1, batch=4, **kw)
    assert ("block" in model.hparams) == (block != ttx.TxConfig.block)
    cfg = Settings()
    cfg.store_root = str(tmp_path)
    ModelRegistry(cfg).save("m", model, metrics={"accuracy": 1.0})
    man, again = ModelRegistry(cfg).load("m")
    assert man["hparams"] == model.hparams
    assert sequence.config_from_hparams(again.hparams) == c
    assert sequence.row_bytes(c) > 0

    validate_hparams("tx", dict(blk.fields, block=block))
    for f, v in dict(blk.fields, block=block).items():
        with pytest.raises(ValueError, match=f"unknown hparam '{f}' for "
                                             "classifier 'lr'"):
            validate_hparams("lr", {f: v})
    for other, o in ttx.BLOCKS.items():
        if other == block:
            continue
        # A field two blocks share is refused only under a block without it.
        for f, v in o.fields.items():
            if f not in blk.fields:
                with pytest.raises(ValueError, match=f"need block [^\n]*"
                                                     f"'{other}'"):
                    validate_hparams("tx", {"block": block, f: v})
        for f, v in blk.fields.items():
            if f not in o.fields:
                with pytest.raises(ValueError, match=f"need block [^\n]*"
                                                     f"'{block}'"):
                    validate_hparams("tx", {"block": other, f: v})


# ---------------------------------------------------------------------------
# Validation and REST
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hparams,message", [
    ({"block": "moe"}, "hparam 'block' for classifier 'tx' is out of "
                       "range: expected one of ['encoder', 'kda_mla_moe', "
                       "'mla_moe'], got 'moe'"),
    ({"block": "mla_moe", "kv_lora_rank": 0},
     "hparam 'kv_lora_rank' for classifier 'tx' is out of range: "
     "expected an integer in [1, 8192], got 0"),
    ({"block": "mla_moe", "qk_rope_head_dim": 7},
     "hparam 'qk_rope_head_dim' for classifier 'tx' must be even (RoPE "
     "rotates pairs), got 7"),
    ({"block": "mla_moe", "n_routed_experts": 4, "num_experts_per_tok": 6},
     "hparam 'num_experts_per_tok' for classifier 'tx' must be at most "
     "n_routed_experts (4), got 6"),
    ({"block": "mla_moe", "routed_scaling_factor": 0},
     "hparam 'routed_scaling_factor' for classifier 'tx' is out of range: "
     "expected a number > 0, got 0"),
    ({"block": "mla_moe", "n_shared_experts": 65},
     "hparam 'n_shared_experts' for classifier 'tx' is out of range: "
     "expected an integer in [0, 64], got 65"),
    ({"block": "mla_moe", "rms_norm_eps": -1.0},
     "hparam 'rms_norm_eps' for classifier 'tx' is out of range: "
     "expected a number > 0, got -1.0"),
    ({"kv_lora_rank": 64},
     "hparams ['kv_lora_rank'] for classifier 'tx' need block 'mla_moe' or "
     "'kda_mla_moe'"),
])
def test_mla_hparams_are_validated(hparams, message):
    from learningorchestra_tpu_torch.models.registry import validate_hparams

    with pytest.raises(ValueError) as got:
        validate_hparams("tx", hparams)
    assert str(got.value) == message


def _token_csv(path, n, seed, T=16):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    X = np.where(rng.random((n, T)) < 0.7, np.where(y[:, None] == 1, 2, 5),
                 rng.integers(0, 8, (n, T)))
    rows = [",".join([f"t{j}" for j in range(T)] + ["label"])]
    rows += [",".join(str(int(t)) for t in x) + f",{int(lab)}"
             for x, lab in zip(X, y)]
    path.write_text("\n".join(rows) + "\n")
    return f"file://{path}"


def test_mla_block_rest_end_to_end(tmp_path):
    """``POST /models`` with the mla_moe block trains, writes its
    prediction dataset, saves the model and re-serves it through
    /trained-models; a bad width answers 406 with the validation's
    message."""
    import requests

    from learningorchestra_tpu_torch.client import Context, DatabaseApi, Model
    from learningorchestra_tpu_torch.serving.app import App

    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    cfg.image_root = str(tmp_path / "images")
    cfg.port = 0
    cfg.persist = True
    app = App(cfg, recover=False, device="cpu")
    server = app.serve(background=True)
    try:
        base = f"http://127.0.0.1:{server.port}"
        ctx = Context(base, poll_seconds=0.1, timeout=300)
        db = DatabaseApi(ctx)
        db.create_file("mla_train", _token_csv(tmp_path / "tr.csv", 200, 0),
                       wait=True)
        test_url = _token_csv(tmp_path / "te.csv", 40, 1)
        db.create_file("mla_test", test_url, wait=True)
        hp = {k: v for k, v in SMALL.items()
              if k not in ("n_classes", "max_len", "vocab")}
        hp.update(train_steps=30, batch=16, lr=3e-3)
        r = requests.post(f"{base}/models", json={
            "training_filename": "mla_train", "test_filename": "mla_test",
            "prediction_filename": "bad", "classificators_list": ["tx"],
            "label": "label", "sync": True,
            "hparams": {"tx": dict(hp, qk_rope_head_dim=7)}}, timeout=30)
        assert r.status_code == 406 and "must be even" in r.text
        model = Model(ctx)
        out = model.create_model("mla_train", "mla_test", "mlapred", ["tx"],
                                 "label", hparams={"tx": hp})
        rep = out["result"][0]
        assert rep["classifier"] == "tx" and rep["accuracy"] > 0.8, rep
        docs = db.read_file("mlapred_tx", limit=3)
        assert docs[0]["finished"] is True
        assert set(docs[1]) >= {"_id", "prediction", "probability"}
        assert "mlapred_tx" in [m["name"] for m in
                                model.list_trained_models()]
        db.create_file("mla_new", test_url, wait=True)
        model.predict("mlapred_tx", "mla_new", "mla_new_pred", wait=True)
        meta = db.read_file("mla_new_pred", limit=1)[0]
        assert meta["finished"] is True and not meta.get("error")
        again = db.read_file("mla_new_pred", skip=1, limit=40)
        first = db.read_file("mlapred_tx", skip=1, limit=40)
        assert [r["prediction"] for r in again] == [
            r["prediction"] for r in first]
    finally:
        server.stop()
