"""The benchmark's pieces for ``moonlight16b.tx_build`` and
``higgs11m.build_warm``, on the CPU: both kinds at a toy size (a sound
run is correct; the bfloat16 control is not), the new readers on a
synthetic window, ``counts_tx`` against a hand count, the token
generator, the configuration against its published widths, and the
reference's two copies."""

import filecmp
import json
import subprocess
import sys

import pytest
import torch

from portbench import counts, counts_tx, harness

ROOT = harness.BENCH_DIR.parent
TX = "moonlight16b.tx_build"
WARM = "higgs11m.build_warm"
CONFIG = ROOT / "portbench" / "configs" / "moonlight16b.json"
#: Moonlight's widths cut to a toy: what the CPU run holds.
TOY = dict(d_model=64, n_heads=4, d_ff=96, vocab=500, kv_lora_rank=32,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
           moe_intermediate_size=24, n_layers=3)


def spec(workload):
    s = harness.cell_spec(harness.load_benchmark(ROOT), ROOT, workload)
    s = json.loads(json.dumps(s))
    if workload == TX:
        s["config"]["data"].update(train_docs=64, test_docs=4, tokens=32)
        s["config"]["program"]["hparams"].update(TOY)
    else:
        s["config"]["data"].update(train_rows=20000, test_rows=4000)
    return s


@pytest.mark.parametrize("workload,seconds", [(TX, 0.0), (WARM, 1.0)])
def test_sound_run_is_correct(workload, seconds):
    doc = harness.run_cell(spec(workload), 2 ** 31 + 77, seconds, False,
                           device="cpu")
    assert doc["correct"], doc["checks"]
    assert doc["attempted"] >= 1 and doc["failed"] == 0
    assert set(doc["metrics"]) == {"build_s", "setup_s"}


def test_tx_traced_run_reads_its_span_metrics():
    doc = harness.run_cell(spec(TX), 31, 0.0, True, device="cpu")
    assert doc["correct"], doc["checks"]
    # The CUDA-event metrics need a card; the rest read spans and shapes.
    assert {"step_s.txbuild", "expert_load.txbuild",
            "mfu.txbuild"} <= set(doc["metrics"])
    assert doc["checks"]["tokens_dropped"]["value"] == 0.0


def test_bfloat16_control_fails():
    from portbench import control_tx

    out = control_tx.control(spec(TX), 5, "bfloat16", "cpu")
    assert out["fails"], out["checks"]


def test_tokens_are_zipf_over_a_seeded_permutation():
    from portbench.kinds import txbuild

    gen = torch.Generator().manual_seed(3)
    perm = torch.randperm(1000, generator=gen)
    X = txbuild.tokens(200, 64, perm, 1.1, gen, "cpu")
    assert X.dtype == torch.int32 and X.shape == (200, 64)
    counts_by_id = torch.bincount(X.reshape(-1).long(), minlength=1000)
    # Rank 1 is the most frequent id, near its Zipf share 1/H(1000, 1.1).
    share = float(counts_by_id[perm[0]]) / X.numel()
    h = float((torch.arange(1, 1001, dtype=torch.float64) ** -1.1).sum())
    assert share == pytest.approx(1.0 / h, rel=0.1)
    assert int(counts_by_id.argmax()) == int(perm[0])
    gen2 = torch.Generator().manual_seed(3)
    again = txbuild.tokens(200, 64, torch.randperm(1000, generator=gen2),
                           1.1, gen2, "cpu")
    assert torch.equal(X, again)


def test_counts_tx_one_expert_layer_by_hand():
    """Moonlight's expert layer at T = 4,096: 2 × (attention projections
    13,762,560 + router 131,072 + 8 SwiGLUs of 8,650,752) = 166.1 MFLOP
    of weight products, plus 2 × 16 × 2,048.5 keys × 320 = 21.0 MFLOP of
    causal attention: 187.2 MFLOP a token."""
    cfg = json.loads(CONFIG.read_text())
    hp = dict(cfg["program"]["hparams"], n_classes=4)
    proj = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    assert proj == 13_762_560
    weights = proj + 2048 * 64 + 8 * 3 * 2048 * 1408
    attention = 2 * 16 * (4096 + 1) / 2 * (192 + 128)
    assert counts_tx.layer_flops(hp, 4096, moe=True) == pytest.approx(
        2 * weights + attention)
    assert 2 * weights == pytest.approx(166.1e6, rel=1e-3)
    dense = 2 * (proj + 3 * 2048 * 11264) + attention
    assert counts_tx.layer_flops(hp, 4096, moe=False) == pytest.approx(dense)
    fwd = counts_tx.forward_flops(hp, 4096)
    assert fwd == pytest.approx(4096 * (dense + 4 * (2 * weights
                                                     + attention))
                                + 2 * 2048 * 4)
    assert counts_tx.build_bound_s(hp, 4096, 16, 16) == pytest.approx(
        (3 * 16 + 16) * fwd / counts.PEAK_FP32_OPS)


class WindowRun:
    span_seconds = harness.Run.span_seconds

    def __init__(self, spans, steps=2, config=None):
        self.spans = spans
        self.steps = [(float(i), float(i) + 10.0, None)
                      for i in range(steps)]
        self.config = config

    def step_seconds(self):
        return [b - a for a, b, _ in self.steps]


def _step(ms, **attrs):
    return {"name": "tx.step", "start": 0.0, "duration_ms": ms,
            "attrs": attrs}


def test_tx_readers_on_a_synthetic_window():
    spans = [_step(2000.0, moe_ms=900.0, mla_ms=700.0, load_ratio=3.0),
             _step(2500.0, moe_ms=1100.0, mla_ms=900.0, load_ratio=5.0),
             _step(3000.0, moe_ms=1000.0, mla_ms=800.0, load_ratio=9.0),
             {"name": "tx.predict", "start": 0.0, "duration_ms": 500.0,
              "attrs": {"rows": 3}}]
    run = WindowRun(spans)
    assert harness.reader("step_s.txbuild")(run) == pytest.approx(2.5)
    assert harness.reader("moe_s.txbuild")(run) == pytest.approx(1.5)
    assert harness.reader("mla_s.txbuild")(run) == pytest.approx(1.2)
    assert harness.reader("expert_load.txbuild")(run) == pytest.approx(5.0)
    # Spans without the CUDA-event attributes (a CPU run): no reading.
    empty = WindowRun([_step(1.0)])
    for name in ("moe_s.txbuild", "mla_s.txbuild", "expert_load.txbuild"):
        assert harness.reader(name)(empty) is None
    assert harness.reader("step_s.txbuild")(WindowRun([])) is None


def test_mfu_and_warm_fits_readers():
    cfg = json.loads(CONFIG.read_text())
    run = WindowRun([], steps=2, config=cfg)
    hp = dict(cfg["program"]["hparams"], n_classes=4)
    bound = counts_tx.build_bound_s(hp, 4096, 16, 16)
    assert harness.reader("mfu.txbuild")(run) == pytest.approx(
        100.0 * bound / 10.0)
    warm = WindowRun([{"name": "design.build", "start": 0.0,
                       "duration_ms": 4.0}])
    assert harness.reader("fits_s.build")(warm) == pytest.approx(
        (20.0 - 0.004) / 2)
    assert harness.reader("fits_s.build")(WindowRun([])) is None


def test_configuration_keeps_the_published_widths():
    """Every number of the catalog's config is the file's, but the depth
    it lists under ``reduced``."""
    published = {
        "first_k_dense_replace": 1, "hidden_size": 2048,
        "intermediate_size": 11264, "kv_lora_rank": 512,
        "max_position_embeddings": 8192, "moe_intermediate_size": 1408,
        "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
        "n_shared_experts": 2, "num_attention_heads": 16,
        "num_experts_per_tok": 6, "num_hidden_layers": 27,
        "num_key_value_heads": 16, "num_nextn_predict_layers": 0,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
        "rms_norm_eps": 1e-05, "rope_theta": 50000,
        "routed_scaling_factor": 2.446, "topk_group": 1,
        "v_head_dim": 128, "vocab_size": 163840, "ep_size": 1}
    cfg = json.loads(CONFIG.read_text())
    bench = harness.load_benchmark(ROOT)
    entry = {c["name"]: c for c in bench["configs"]}["moonlight16b"]
    for k, v in published.items():
        if k not in entry["reduced"]:
            assert cfg[k] == v, k
    assert cfg["num_hidden_layers"] == 5
    hp = cfg["program"]["hparams"]
    assert (hp["d_model"], hp["n_heads"], hp["d_ff"], hp["vocab"],
            hp["n_layers"]) == (2048, 16, 11264, 163840, 5)
    for k in ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
              "v_head_dim", "n_routed_experts", "n_shared_experts",
              "num_experts_per_tok", "moe_intermediate_size",
              "first_k_dense_replace", "routed_scaling_factor",
              "rms_norm_eps", "rope_theta"):
        assert hp[k] == published[k], k


def test_reference_copies_are_identical():
    assert filecmp.cmp(ROOT / "tests" / "ref_moonlight.py",
                       ROOT / "portbench" / "reference" / "moonlight.py",
                       shallow=False)


def test_new_modules_load_nothing_forbidden():
    code = ("import json, sys\n"
            "from portbench import control_tx, counts_tx\n"
            "from portbench.kinds import buildwarm, txbuild\n"
            "from portbench.reference import moonlight\n"
            "from learningorchestra_tpu_torch.models import moe, sequence\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert harness.forbidden_loaded(mods) == []


def test_parent_without_the_block_stops_at_setup(monkeypatch):
    """A program with no expert layer cannot run the cell: set-up raises
    before any window, so the run ends with an error at once."""
    import builtins

    real = builtins.__import__

    def no_moe(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "learningorchestra_tpu_torch.models" and "moe" in (
                fromlist or ()):
            raise ImportError("no expert layer")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_moe)
    with pytest.raises(ImportError):
        harness.run_cell(spec(TX), 1, 0.0, False, device="cpu")


def test_judge_sees_a_changed_parameter():
    """The same toy run with one trained leaf nudged after the window:
    ``param_gap`` leaves its limit."""
    from portbench.kinds import txbuild

    real = txbuild.release

    def nudged(run):
        real(run)
        leaf = run.state["kept"]["layers.1.experts_w1"]
        run.state["kept"]["layers.1.experts_w1"] = (
            leaf + 1e-3 * torch.sign(leaf))

    txbuild.release = nudged
    try:
        doc = harness.run_cell(spec(TX), 9, 0.0, False, device="cpu")
    finally:
        txbuild.release = real
    assert not doc["correct"]
    assert doc["checks"]["param_gap"]["value"] > \
        doc["checks"]["param_gap"]["limit"]
