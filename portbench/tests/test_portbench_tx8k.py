"""The benchmark's pieces for ``kimilinear48b.tx_build_8k``, on the CPU:
the kind at a toy size (a sound run is correct; the bfloat16 control is
not; a nudged parameter and a faulty bias update are caught), the new
readers on a synthetic window, ``counts_kda`` against a hand count, the
configuration against its published widths, a program without the block
stopping in set-up, and the new modules' imports."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import counts, counts_kda, harness

ROOT = harness.BENCH_DIR.parent
TX = "kimilinear48b.tx_build_8k"
CONFIG = ROOT / "portbench" / "configs" / "kimilinear48b.json"
#: Kimi Linear's widths cut to a toy: 4 layers (KDA, KDA, KDA, MLA), 16
#: experts of which 4 are held, 40-token documents (no whole chunk).
TOY = dict(d_model=64, n_heads=4, d_ff=96, vocab=500, kv_lora_rank=32,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=1,
           moe_intermediate_size=24, n_layers=4, linear_num_heads=4,
           linear_head_dim=8, experts_held=4, expert_share=1)


def spec():
    s = harness.cell_spec(harness.load_benchmark(ROOT), ROOT, TX)
    s = json.loads(json.dumps(s))
    s["config"]["data"].update(train_docs=32, test_docs=4, tokens=40)
    s["config"]["program"]["hparams"].update(TOY)
    return s


def test_sound_run_is_correct_and_reads_its_metrics():
    doc = harness.run_cell(spec(), 2 ** 31 + 77, 0.0, True, device="cpu")
    assert doc["correct"], doc["checks"]
    assert doc["attempted"] >= 1 and doc["failed"] == 0
    # The CUDA-event metrics need a card; the rest read spans and shapes.
    assert {"step_s.txbuild", "expert_load.txbuild",
            "mfu.txbuild8k"} <= set(doc["metrics"])
    assert doc["checks"]["tokens_dropped"]["value"] == 0.0
    assert doc["checks"]["pairs_held_gap"]["value"] == 0.0
    assert doc["checks"]["bias_gap"]["value"] == 0.0
    assert set(doc["checks"]) == {"tokens_dropped", "loss_gap", "param_gap",
                                  "prob_gap", "route_flips",
                                  "pairs_held_gap", "bias_gap"}


def test_bfloat16_control_fails():
    from portbench import control_tx8k

    out = control_tx8k.control(spec(), 5, "bfloat16", "cpu")
    assert out["fails"], out["checks"]


def test_judge_sees_a_changed_parameter():
    """The same toy run with one KDA leaf nudged after the window:
    ``param_gap`` leaves its limit."""
    from portbench.kinds import txbuild_hybrid as kind

    real = kind.release

    def nudged(run):
        real(run)
        leaf = run.state["kept"]["layers.1.q_proj"]
        run.state["kept"]["layers.1.q_proj"] = leaf + 1e-3 * torch.sign(leaf)

    kind.release = nudged
    try:
        doc = harness.run_cell(spec(), 9, 0.0, False, device="cpu")
    finally:
        kind.release = real
    assert not doc["correct"]
    assert doc["checks"]["param_gap"]["value"] > \
        doc["checks"]["param_gap"]["limit"]


@pytest.mark.parametrize("fault", ["skipped", "turned"])
def test_judge_sees_a_faulty_bias_update(fault, monkeypatch):
    """The toy run with the program's correction-bias update skipped, or
    taken the wrong way: ``bias_gap`` leaves its limit (``param_gap``
    leaves the bias out: no gradient reaches it)."""
    from learningorchestra_tpu_torch.models import transformer as ttx

    blk = ttx.BLOCKS["kda_mla_moe"]
    real = blk.after_step

    def faulty(params, cfg, aux, mesh):
        keys = [k for k in params if k.endswith(".e_bias")]
        before = {k: params[k] for k in keys}
        real(params, cfg, aux, mesh)
        for k in keys:
            params[k] = (before[k] if fault == "skipped"
                         else 2 * before[k] - params[k])

    monkeypatch.setattr(blk, "after_step", faulty)
    doc = harness.run_cell(spec(), 2 ** 31 + 77, 0.0, False, device="cpu")
    assert not doc["correct"]
    gap = doc["checks"]["bias_gap"]
    assert gap["value"] > 2 * gap["limit"], doc["checks"]


def test_parent_without_the_block_stops_at_setup(monkeypatch):
    """A program with no KDA layer cannot run the cell: set-up raises
    before it makes any data."""
    import builtins

    from portbench.kinds import txbuild

    real = builtins.__import__

    def no_kda(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "learningorchestra_tpu_torch.models" and "kda" in (
                fromlist or ()):
            raise ImportError("no KDA layer")
        return real(name, globals, locals, fromlist, level)

    made = []
    monkeypatch.setattr(txbuild, "make_data", lambda run: made.append(1))
    monkeypatch.setattr(builtins, "__import__", no_kda)
    with pytest.raises(ImportError):
        harness.run_cell(spec(), 1, 0.0, False, device="cpu")
    assert made == []


class WindowRun:
    def __init__(self, spans, steps=2, config=None):
        self.spans = spans
        self.steps = [(float(i), float(i) + 10.0, None)
                      for i in range(steps)]
        self.config = config

    def step_seconds(self):
        return [b - a for a, b, _ in self.steps]


def test_new_readers_on_a_synthetic_window():
    def step(ms, **attrs):
        return {"name": "tx.step", "start": 0.0, "duration_ms": ms,
                "attrs": attrs}

    cfg = json.loads(CONFIG.read_text())
    spans = [step(3000.0, kda_ms=1200.0, mla_ms=700.0, moe_ms=500.0,
                  load_ratio=2.0, pairs_held=16384),
             step(3200.0, kda_ms=1300.0, mla_ms=800.0, moe_ms=600.0,
                  load_ratio=2.5, pairs_held=16000)]
    run = WindowRun(spans, config=cfg)
    assert harness.reader("kda_s.txbuild8k")(run) == pytest.approx(1.25)
    assert harness.reader("mla_s.txbuild")(run) == pytest.approx(0.75)
    hp = dict(cfg["program"]["hparams"], n_classes=4)
    bound = counts_kda.build_bound_s(hp, 8192, 3 * 2, 8)
    assert harness.reader("mfu.txbuild8k")(run) == pytest.approx(
        100.0 * bound / 10.0)
    assert harness.reader("kda_s.txbuild8k")(WindowRun([step(1.0)])) is None


def test_counts_kda_by_hand():
    """Kimi Linear at T = 8,192: a KDA layer's attention 2 × 39,460,864
    weights + 3 × 2 × 4,096 × 4 conv + 7 × 32 × 128² = 82.7 MFLOP a
    token; MLA's 2 × 29,114,368 + 2 × 32 × 4,096.5 × 320 = 142.1; an
    expert layer (one held routed expert a token on average and the
    shared one) 29.5; the dense layer 127.4: 1,114.2 MFLOP a token, and
    a build of 6 training and 8 predicted documents 237.3 TFLOP."""
    cfg = json.loads(CONFIG.read_text())
    hp = dict(cfg["program"]["hparams"], n_classes=4)
    d, He, e = 2304, 4096, 128
    kda_w = 3 * d * He + d * e + e * He + d * 32 + d * e + e * He + He * d
    assert kda_w == 39_460_864
    assert counts_kda.kda_flops(hp) == pytest.approx(
        2 * kda_w + 3 * 2 * He * 4 + 7 * 32 * e * e)
    mla_w = d * 32 * 192 + d * 576 + 512 * 32 * 256 + 32 * 128 * d
    assert mla_w == 29_114_368
    assert counts_kda.mla_flops(hp, 8192) == pytest.approx(
        2 * mla_w + 2 * 32 * 8193 / 2 * 320)
    moe = 2 * (d * 256 + 3 * d * 1024 * (8 * 32 / 256 + 1))
    assert counts_kda.ffn_flops(hp, True) == pytest.approx(moe)
    assert counts_kda.forward_flops(hp, 8192) / 8192 / 1e6 == \
        pytest.approx(1114.23, rel=1e-5)
    assert counts_kda.build_flops(hp, 8192, 6, 8) / 1e12 == pytest.approx(
        237.32, rel=1e-4)
    assert counts_kda.build_bound_s(hp, 8192, 6, 8) == pytest.approx(
        counts_kda.build_flops(hp, 8192, 6, 8) / counts.PEAK_FP32_OPS)


def test_configuration_keeps_the_published_widths():
    """Every top-level number of the catalog's config and its nested
    ``linear_attn_config`` are the file's, but the keys it lists under
    ``reduced``; the program's hparams take them."""
    published = {
        "first_k_dense_replace": 1, "head_dim": 72, "hidden_size": 2304,
        "intermediate_size": 9216, "kv_lora_rank": 512,
        "mla_use_nope": True, "model_max_length": 1048576,
        "moe_intermediate_size": 1024, "moe_layer_freq": 1,
        "moe_renormalize": True, "num_attention_heads": 32,
        "num_expert_group": 1, "num_experts": 256,
        "num_experts_per_token": 8, "num_hidden_layers": 27,
        "num_key_value_heads": 32, "num_nextn_predict_layers": 0,
        "num_shared_experts": 1, "qk_nope_head_dim": 128,
        "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05, "rope_theta": 10000,
        "routed_scaling_factor": 2.446, "topk_group": 1,
        "v_head_dim": 128, "vocab_size": 163840}
    cfg = json.loads(CONFIG.read_text())
    bench = harness.load_benchmark(ROOT)
    entry = {c["name"]: c for c in bench["configs"]}["kimilinear48b"]
    for k, v in published.items():
        if k not in entry["reduced"]:
            assert cfg[k] == v, k
    assert (cfg["num_hidden_layers"], cfg["num_experts"]) == (8, 32)
    lin = cfg["linear_attn_config"]
    assert (lin["num_heads"], lin["head_dim"],
            lin["short_conv_kernel_size"]) == (32, 128, 4)
    from learningorchestra_tpu_torch.models import transformer as ttx

    hp = cfg["program"]["hparams"]
    assert (hp["d_model"], hp["n_heads"], hp["d_ff"], hp["vocab"],
            hp["n_layers"]) == (2304, 32, 9216, 163840, 8)
    assert (hp["n_routed_experts"], hp["experts_held"],
            hp["num_experts_per_tok"], hp["n_shared_experts"],
            hp["moe_intermediate_size"]) == (256, 32, 8, 1, 1024)
    assert (hp["linear_num_heads"], hp["linear_head_dim"],
            hp["short_conv_kernel_size"], hp["block"]) == (
                32, 128, 4, "kda_mla_moe")
    # The block's latent attention has no positions, as published.
    assert cfg["mla_use_nope"] and not ttx.BLOCKS[hp["block"]].rope
    # Layers 4 and 8 (from 1) are the full-attention ones, as published.
    full = [i + 1 for i in range(8) if (i + 1) % hp["full_attn_every"] == 0]
    assert full == [x for x in lin["full_attn_layers"] if x <= 8]
    c = ttx.TxConfig(n_classes=4, max_len=8192,
                     **{k: v for k, v in hp.items()
                        if k not in ("train_steps", "batch", "lr", "seed")})
    n = sum(int(torch.Size(s).numel()) for s in ttx.param_shapes(c).values())
    assert n == cfg["parameters"]["total"] == 2_375_699_396


def test_new_modules_load_nothing_forbidden():
    code = ("import json, sys\n"
            "from portbench import control_tx8k, counts_kda\n"
            "from portbench.kinds import txbuild_hybrid\n"
            "from portbench.reference import kimi_linear\n"
            "from learningorchestra_tpu_torch.models import kda\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert harness.forbidden_loaded(mods) == []
