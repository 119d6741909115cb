"""The ``tx`` family's ``kda_mla_moe`` block (Kimi-Linear-48B-A3B's: Kimi
Delta Attention in three layers of four, latent attention without
positions in the fourth, a dense SwiGLU layer, sigmoid-routed experts of
which the layer holds a share) against the plain reference
``tests/ref_kimi_linear.py`` (a copy of
``portbench/reference/kimi_linear.py``) at a small size on the CPU.

- the chunked delta rule (``kda.delta_rule``) against the reference's
  token recurrence, forward and every gradient, at a length no chunk
  divides and at decays whose chunk sums overflow ``exp(−G)``;
- the initial draws, and on the 1×1×1 and 1×2×1 meshes (the model axis
  splitting the heads and the experts' widths) ``forward_shard``'s
  logits, the loss and every leaf's gradient, and three training steps;
- the expert share: the shares' outputs, with the shared expert counted
  once, add up to the uncut layer; every (token, expert) pair is counted
  held or elsewhere, and none as dropped;
- the ``kda`` region's marks, the ``tx.step`` span's ``pairs_held``,
  persistence, a seq axis refused, and the new fields' validation.

Tolerances as in ``tests/test_torch_moonlight.py``: two float32 programs
that sum in different orders (here also the chunk form's triangular
solve against the token recurrence), measured at 1e-8–1e-6 apart.
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

import ref_kimi_linear as ref
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models import kda, moe, sequence
from learningorchestra_tpu_torch.models import transformer as ttx
from learningorchestra_tpu_torch.parallel.mesh import (
    MODEL_AXIS, ProcessMesh, all_gather, local_mesh)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import regions

REPO = Path(__file__).resolve().parents[1]
#: The small block: 4 KDA heads of width 8, 4 MLA heads (nope 16, rope 8,
#: v 16, latent 32), 16 experts of which 4 are held (share 1), 4 a token,
#: 1 shared; layers 0–2 KDA (0 dense), layer 3 MLA.
KIMI = dict(ttx.BLOCKS["kda_mla_moe"].fields, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=1,
            moe_intermediate_size=24, first_k_dense_replace=1,
            linear_num_heads=4, linear_head_dim=8, experts_held=4,
            expert_share=1)
SMALL = dict(vocab=40, d_model=64, n_heads=4, n_layers=4, d_ff=96,
             n_classes=3, max_len=24, causal=True, block="kda_mla_moe",
             **KIMI)
B, T, SEED, STEPS, LR = 3, 24, 5, 3, 1e-3
#: The reference's recurrence in segments of 5 tokens (each recomputed in
#: the backward pass), its attention in key chunks of 4.
REF_KW = dict(key_block=4, segment=5)
CPU = torch.device("cpu")
LAYOUTS = ("1,2,1",)
SPAWN_TIMEOUT_S = 120
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-5
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
# The chunked delta rule
# ---------------------------------------------------------------------------

def _kda_inputs(seed, T_, H=3, e=8, ev=5, strength=6.0):
    g = torch.Generator().manual_seed(seed)
    q = kda.l2norm(torch.randn(1, T_, H, e, generator=g)) * e ** -0.5
    k = kda.l2norm(torch.randn(1, T_, H, e, generator=g))
    v = torch.randn(1, T_, H, ev, generator=g)
    gl = -torch.rand(1, T_, H, e, generator=g) * strength
    beta = torch.rand(1, T_, H, generator=g)
    return [t.requires_grad_(True) for t in (q, k, v, gl, beta)]


@pytest.mark.parametrize("chunk,sub", [(64, 16), (16, 4), (8, 8)])
def test_chunked_kda_matches_the_recurrence(chunk, sub):
    """T = 150 (no chunk divides it), log-decays down to −6 a token: a
    64-token chunk's summed decay reaches about −190, whose ``exp(−G)``
    is infinite in float32, so only differences can be taken. Outputs
    and the gradients of q, k, v, g and β against the reference's token
    recurrence."""
    T_ = 150
    mine = _kda_inputs(1, T_)
    theirs = [t.detach().clone().requires_grad_(True) for t in mine]
    G = mine[3].detach()[0, :64].sum(0)
    assert torch.isinf(torch.exp(-G)).any()
    got = kda.delta_rule(*mine, chunk=chunk, sub=sub)
    want = ref.delta_recurrence(*theirs, segment=40)
    # Measured ≤ 1.0e-5 of the largest output: 150 tokens of float32
    # recurrence against chunks through a triangular solve.
    scale = float(want.detach().abs().max())
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=3e-5 * scale)
    w = torch.randn(got.shape, generator=torch.Generator().manual_seed(2))
    (got * w).sum().backward()
    (want * w).sum().backward()
    for name, a, b in zip("q k v g beta".split(), mine, theirs):
        scale = float(b.grad.abs().max())
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


def test_diagonal_blocks_gradients():
    """``_Diag``'s own backward pass, cut into pieces of a few blocks,
    against finite differences in float64."""
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn(5, 4, 3, generator=g, dtype=torch.float64)
            .requires_grad_(True) for _ in range(2))
    G = (-torch.rand(5, 4, 3, generator=g, dtype=torch.float64) * 3).cumsum(1)
    old = kda.PIECE
    kda.PIECE = 2 * 4 * 4 * 3
    try:
        assert torch.autograd.gradcheck(kda._Diag.apply,
                                        (q, k, G.requires_grad_(True)))
    finally:
        kda.PIECE = old


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _rank_work(shape: str, inp: dict) -> dict:
    cfg = Settings()
    cfg.mesh_shape = shape
    mesh = local_mesh(cfg)
    c = _cfg()
    out = {}
    whole = {kk[2:]: torch.tensor(vv) for kk, vv in inp.items()
             if kk.startswith("p.")}
    tok, lab = torch.tensor(inp["tokens"]), torch.tensor(inp["labels"])
    local = ttx.shard_params(whole, c, mesh)
    with torch.no_grad():
        out["fwd"] = ttx.forward_shard(local, tok, cfg=c, mesh=mesh).numpy()
    specs = ttx.param_specs(c)
    for remat in (False, True):
        cr = dataclasses.replace(c, remat=remat)
        names = [n for n in local if ttx.trainable(n)]
        leaves = [local[n].detach().requires_grad_(True) for n in names]
        full = dict(local, **dict(zip(names, leaves)))
        loss = ttx.loss_shard(full, tok, lab, cfg=cr, mesh=mesh)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        ttx.reduce_grads(grads, mesh)
        out[f"loss_{remat}"] = loss.detach().numpy()
        for n, g in grads.items():
            if specs[n] is not None:
                g = all_gather(g, mesh, MODEL_AXIS, specs[n])
            out[f"grad_{remat}.{n}"] = g.numpy()
    state = ttx.adam_init(local)
    losses = []
    for _ in range(STEPS):
        local, state, loss = ttx.train_step(local, state, tok, lab, cfg=c,
                                            mesh=mesh, lr=LR)
        losses.append(float(loss))
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


@pytest.fixture(scope="module")
def inputs():
    params = ref.init_params(_rcfg(), SEED, "cpu")
    tokens, labels = _inputs()
    out = {f"p.{k}": v.numpy() for k, v in params.items()}
    out["tokens"], out["labels"] = tokens.numpy(), labels.numpy()
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
def want():
    """The reference's logits, loss, gradients, and three steps' losses
    and parameters."""
    cfg = _rcfg()
    params = ref.init_params(cfg, SEED, "cpu")
    tokens, labels = _inputs()
    out = {"logits": ref.forward(params, tokens, cfg, **REF_KW).numpy()}
    names = [k for k in params if ref.trainable(k)]
    leaves = {k: params[k].detach().requires_grad_(True) for k in names}
    full = dict(params, **leaves)
    loss, _, _ = ref.batch_loss(full, tokens, labels, cfg, **REF_KW)
    loss.backward()
    out["loss"] = float(loss.detach())
    out["grads"] = {k: leaves[k].grad.numpy() for k in names}
    p3 = ref.init_params(cfg, SEED, "cpu")
    state = ref.adam_init(p3)
    out["train_losses"] = [ref.step(p3, state, tokens, labels, cfg, LR,
                                    **REF_KW) for _ in range(STEPS)]
    out["init"] = {k: v.numpy() for k, v in params.items()}
    out["trained"] = {k: v.numpy() for k, v in p3.items()}
    return out


# ---------------------------------------------------------------------------
# The reference itself, and the block against it
# ---------------------------------------------------------------------------

def test_reference_copies_are_identical():
    """The benchmark's reference and the tests' copy are the same file."""
    assert filecmp.cmp(REPO / "tests" / "ref_kimi_linear.py",
                       REPO / "portbench" / "reference" / "kimi_linear.py",
                       shallow=False)


def test_reference_imports_nothing_of_the_program():
    import ast

    tree = ast.parse((REPO / "tests" / "ref_kimi_linear.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in names if m.startswith(("learningorchestra",
                                                  "jax", "portbench"))}


def test_initial_draws_are_the_references():
    """Drawn leaf by leaf in one order from one seeded generator (A_log
    and dt_bias by their own rules), the program's parameters are the
    reference's, bit for bit; the expert stacks hold the share's 4."""
    mine = ttx.BLOCKS["kda_mla_moe"].init(SEED, _cfg(), ttx.ONE_RANK, CPU)
    theirs = ref.init_params(_rcfg(), SEED, "cpu")
    assert list(mine) == list(theirs) == ttx.param_names(_cfg())
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k
    assert mine["layers.1.experts_w1"].shape[0] == 4
    assert mine["layers.1.router"].shape[1] == 16
    assert "layers.3.wkv_a" in mine and "layers.2.q_conv" in mine
    a = torch.exp(mine["layers.0.a_log"])
    dt = torch.nn.functional.softplus(mine["layers.0.dt_bias"])
    assert float(a.min()) >= 0.0 and float(a.max()) <= 16.0
    assert float(dt.min()) >= 1e-4 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)


@pytest.mark.parametrize("layout", ("1,1,1",) + LAYOUTS)
def test_forward_shard_matches_reference(runs, want, layout):
    np.testing.assert_allclose(runs(layout)["fwd"], want["logits"],
                               **LOGIT_TOL)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("layout", ("1,1,1",) + LAYOUTS)
def test_loss_and_every_gradient_match_reference(runs, want, layout, remat):
    """The loss and every trained leaf's gradient, gathered over the
    model axis: a replicated leaf the heads share (``f_a``, ``g_a``,
    ``o_norm``) that skipped ``pvary`` comes out off by the axis size."""
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
def test_three_training_steps_match_reference(runs, want, layout):
    res = runs(layout)
    np.testing.assert_allclose(res["train_losses"], want["train_losses"],
                               rtol=1e-5)
    for n, p_ref in want["trained"].items():
        moved = np.linalg.norm(p_ref - want["init"][n])
        off = np.linalg.norm(res[f"trained.{n}"] - p_ref)
        assert off <= STEP_TOL * max(moved, 1e-30), (n, off, moved)


# ---------------------------------------------------------------------------
# The expert share
# ---------------------------------------------------------------------------

def _layer_inputs(seed, N=40, d=16, E=16, I=12):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, d), generator=g)
    w = {"router": torch.randn((d, E), generator=g) * 0.5,
         "e_bias": torch.randn(E, generator=g) * 0.1,
         "experts_w1": torch.randn((E, d, I), generator=g) * 0.2,
         "experts_w3": torch.randn((E, d, I), generator=g) * 0.2,
         "experts_w2": torch.randn((E, I, d), generator=g) * 0.2,
         "shared_w1": torch.randn((d, I), generator=g) * 0.2,
         "shared_w3": torch.randn((d, I), generator=g) * 0.2,
         "shared_w2": torch.randn((I, d), generator=g) * 0.2}
    return x, w


def _share(w, held, share):
    out = dict(w)
    for n in moe.EXPERT_LEAVES:
        out[n] = w[n][share * held:(share + 1) * held]
    return out


@pytest.mark.parametrize("held", [2, 4, 8])
def test_expert_shares_add_up_to_the_uncut_layer(held):
    """Every share's output, the shared expert (which every share
    computes alike) counted once, adds up to the layer holding all 16
    experts; each share's balance loss and loads are the whole layer's."""
    x, w = _layer_inputs(0)
    c = _cfg(d_model=16, n_routed_experts=16, num_experts_per_tok=4,
             experts_held=0, expert_share=0)
    whole, bal, load = moe.moe_layer(x[None], w, cfg=c, mesh=ttx.ONE_RANK,
                                     layer=1, balance=True)
    shared = moe.swiglu(x, w["shared_w1"], w["shared_w3"], w["shared_w2"])
    total = -(16 // held - 1) * shared
    for s in range(16 // held):
        cs = dataclasses.replace(c, experts_held=held, expert_share=s)
        out, b, ld = moe.moe_layer(x[None], _share(w, held, s), cfg=cs,
                                   mesh=ttx.ONE_RANK, layer=1, balance=True)
        total = total + out[0]
        assert torch.equal(b, bal) and torch.equal(ld, load)
    torch.testing.assert_close(total, whole[0], rtol=1e-5, atol=1e-6)


def test_pairs_held_and_elsewhere_count_every_pair():
    """Over the 4 shares of 4 experts every (token, expert) pair is held
    once and elsewhere three times; no token counts as dropped."""
    x, w = _layer_inputs(1)
    c = _cfg(d_model=16, n_routed_experts=16, num_experts_per_tok=4)
    moe.reset_counts()
    held_by_share = []
    for s in range(4):
        before = moe.counts()["pairs_held"]
        cs = dataclasses.replace(c, experts_held=4, expert_share=s)
        _, _, load = moe.moe_layer(x[None], _share(w, 4, s), cfg=cs,
                                   mesh=ttx.ONE_RANK, layer=1)
        held_by_share.append(moe.counts()["pairs_held"] - before)
        assert held_by_share[-1] == int(load[4 * s:4 * s + 4].sum())
    counts = moe.counts()
    N, k = x.shape[0], 4
    assert sum(held_by_share) == N * k
    assert counts["pairs_held"] + counts["pairs_elsewhere"] == 4 * N * k
    assert counts["pairs_elsewhere"] == 3 * N * k
    assert counts["tokens_dropped"] == 0
    assert counts["tokens_routed"] == 4 * N


def test_a_share_no_token_chose_gives_the_shared_expert_alone():
    x, w = _layer_inputs(2)
    w["e_bias"] = torch.zeros(16)
    w["e_bias"][:4] = 100.0          # every token picks experts 0–3
    cs = _cfg(d_model=16, n_routed_experts=16, num_experts_per_tok=4,
              experts_held=4, expert_share=2)
    out, _, _ = moe.moe_layer(x[None], _share(w, 4, 2), cfg=cs,
                              mesh=ttx.ONE_RANK, layer=1)
    shared = moe.swiglu(x, w["shared_w1"], w["shared_w3"], w["shared_w2"])
    torch.testing.assert_close(out[0], shared)


# ---------------------------------------------------------------------------
# The block on the family's path
# ---------------------------------------------------------------------------

def test_kda_region_marks_pair_up_in_a_remat_step():
    """A traced remat step's marks: every ``kda`` (3 layers), ``mla`` (1)
    and ``moe`` (3) region opened is closed, in the forward pass, the
    recomputation and the backward pass."""
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
    params = ttx.BLOCKS["kda_mla_moe"].init(1, c, ttx.ONE_RANK, CPU)
    tokens, labels = _inputs()
    ttx.train_step(params, ttx.adam_init(params), tokens, labels, cfg=c,
                   mesh=ttx.ONE_RANK, lr=LR, aux={"timer": timer})
    for region, layers in (("kda", 3), ("mla", 1), ("moe", 3)):
        opens = sum(1 for r, e in events if r == region and e > 0)
        closes = sum(1 for r, e in events if r == region and e < 0)
        assert opens == closes == 3 * layers, (region, events)
    assert set(timer.seconds()) == {"kda", "mla", "moe"}


def _fit_small(**kw):
    X = np.random.default_rng(0).integers(0, 40, (24, T)).astype(np.float32)
    y = np.random.default_rng(1).integers(0, 3, 24)
    hp = dict(SMALL, train_steps=2, batch=4)
    for k in ("n_classes", "max_len"):
        hp.pop(k)
    hp.update(kw)
    return X, y, sequence.fit(DeviceRuntime(device="cpu"), X, y, 3, **hp)


def test_fit_records_pairs_held_on_each_step():
    from learningorchestra_tpu_torch.utils import tracing

    moe.reset_counts()
    with tracing.trace("t", sampled=True) as ctx:
        _, _, model = _fit_small()
    steps = [s for s in tracing.spans_for(ctx.trace_id)
             if s["name"] == "tx.step"]
    assert len(steps) == 2
    counts = moe.counts()
    # Two steps of 4 × 24 tokens through three expert layers, 4 a token.
    assert counts["pairs_held"] + counts["pairs_elsewhere"] == 2 * 3 * 96 * 4
    assert sum(s["attrs"]["pairs_held"] for s in steps) == \
        counts["pairs_held"] > 0
    assert counts["tokens_dropped"] == 0
    assert model.hparams["block"] == "kda_mla_moe"
    assert model.hparams["experts_held"] == 4


def test_saved_kda_model_reloads_bit_identical(tmp_path):
    from learningorchestra_tpu_torch.models.persistence import ModelRegistry

    X, _, model = _fit_small()
    cfg = Settings()
    cfg.store_root = str(tmp_path)
    reg = ModelRegistry(cfg)
    reg.save("kda_model", model, metrics={"accuracy": 1.0})
    man, again = reg.load("kda_model")
    assert man["kind"] == "tx" and man["hparams"] == model.hparams
    assert list(again.params) == list(model.params)
    for k, v in model.params.items():
        assert torch.equal(again.params[k], v), k
    rt = DeviceRuntime(device="cpu")
    np.testing.assert_array_equal(again.predict_proba(rt, X),
                                  model.predict_proba(rt, X))


def test_a_seq_axis_is_refused_with_the_blocks_name():
    c = _cfg()
    with pytest.raises(ValueError, match="tx block 'kda_mla_moe' needs a "
                                         "seq axis of 1"):
        ttx.BLOCKS["kda_mla_moe"].init(0, c, ProcessMesh((1, 1, 2)), CPU)
    params = ttx.BLOCKS["kda_mla_moe"].init(0, c, ttx.ONE_RANK, CPU)
    with pytest.raises(ValueError, match="'kda_mla_moe'.*seq axis"):
        ttx.forward_shard(params, _inputs()[0][:, :12], cfg=c,
                          mesh=ProcessMesh((1, 1, 2)))


@pytest.mark.parametrize("hparams,message", [
    ({"block": "kda_mla_moe", "linear_num_heads": 0},
     "hparam 'linear_num_heads' for classifier 'tx' is out of range: "
     "expected an integer in [1, 256], got 0"),
    ({"block": "kda_mla_moe", "short_conv_kernel_size": 65},
     "hparam 'short_conv_kernel_size' for classifier 'tx' is out of range: "
     "expected an integer in [1, 64], got 65"),
    ({"block": "kda_mla_moe", "rope_theta": 10000.0},
     "hparams ['block', 'rope_theta'] for classifier 'tx' need block "
     "'mla_moe'"),
    ({"block": "kda_mla_moe", "experts_held": 48},
     "hparam 'experts_held' for classifier 'tx' must divide "
     "n_routed_experts (256), got 48"),
    ({"block": "kda_mla_moe", "experts_held": 32, "expert_share": 8},
     "hparam 'expert_share' for classifier 'tx' must be below the number "
     "of shares (8), got 8"),
    ({"block": "kda_mla_moe", "expert_share": 1},
     "hparam 'expert_share' for classifier 'tx' must be below the number "
     "of shares (1), got 1"),
    ({"block": "kda_mla_moe", "n_routed_experts": 4},
     "hparam 'num_experts_per_tok' for classifier 'tx' must be at most "
     "n_routed_experts (4), got 8"),
    ({"block": "mla_moe", "full_attn_every": 4},
     "hparams ['block', 'full_attn_every'] for classifier 'tx' need block "
     "'kda_mla_moe'"),
])
def test_kda_hparams_are_validated(hparams, message):
    from learningorchestra_tpu_torch.models.registry import validate_hparams

    with pytest.raises(ValueError) as got:
        validate_hparams("tx", hparams)
    assert str(got.value) == message


def test_odd_rope_width_is_allowed_without_rotation():
    from learningorchestra_tpu_torch.models.registry import validate_hparams

    validate_hparams("tx", {"block": "kda_mla_moe", "qk_rope_head_dim": 7})
    with pytest.raises(ValueError, match="must be even"):
        validate_hparams("tx", {"block": "mla_moe", "qk_rope_head_dim": 7})
    # No switch brings the rotation back: the block decides.
    with pytest.raises(ValueError, match="unknown hparam 'mla_use_nope'"):
        validate_hparams("tx", {"block": "kda_mla_moe",
                                "mla_use_nope": False})
