"""Classifier registry — the reference's switcher.

The reference maps ``{"lr", "dt", "rf", "gb", "nb"}`` to pyspark.ml
classifiers (reference model_builder.py:152-158) and returns 409 for unknown
names (ModelBuilderRequestValidator, model_builder.py:284-292). Same five
names here, plus the JAX package's extensions "mlp" (a two-layer
perceptron) and "tx" (the dp×tp×sp transformer with ring attention,
models/sequence.py).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Tuple

from learningorchestra_tpu_torch.models import (
    logistic, mlp, naive_bayes, sequence, trees)
from learningorchestra_tpu_torch.models.transformer import BLOCKS

CLASSIFIERS: Dict[str, Callable] = {
    "lr": logistic.fit,
    "dt": trees.fit_dt,
    "rf": trees.fit_rf,
    "gb": trees.fit_gb,
    "nb": naive_bayes.fit,
    "mlp": mlp.fit,
    "tx": sequence.fit,
}

#: Families the online predict tier serves (models/aot.py): every
#: continuous-feature family, the JAX package's list. "tx" is excluded —
#: it consumes token sequences, so inline JSON feature rows are
#: out-of-domain for it (its serving story is the batch predictions
#: route).
ONLINE_KINDS = ("lr", "nb", "dt", "rf", "gb", "mlp")


def _int_range(lo: int, hi: int) -> Tuple[Callable, str]:
    return (lambda v: isinstance(v, int) and not isinstance(v, bool)
            and lo <= v <= hi, f"an integer in [{lo}, {hi}]")


def _positive() -> Tuple[Callable, str]:
    return (lambda v: isinstance(v, (int, float))
            and not isinstance(v, bool) and v > 0, "a number > 0")


def _nonneg() -> Tuple[Callable, str]:
    return (lambda v: isinstance(v, (int, float))
            and not isinstance(v, bool) and v >= 0, "a number >= 0")


def _choice(*opts: str) -> Tuple[Callable, str]:
    return (lambda v: v in opts, f"one of {sorted(opts)}")


def _boolean() -> Tuple[Callable, str]:
    return (lambda v: isinstance(v, bool), "a boolean")


#: Per-family user-settable hyperparameters with their legal ranges —
#: the single validation table behind the 406s on ``POST /models`` and
#: ``POST /tune``. Keys the builder injects itself (``edges``, ``ckpt``)
#: are deliberately absent: a request naming them is rejected as
#: unknown instead of silently colliding with the injected values. The
#: tree-depth/bin caps mirror the builders' structural limits (uint8
#: bin codes; 2^(depth+1)-1 node arrays).
_SEED = _int_range(0, 2 ** 31 - 1)
HPARAM_SPECS: Dict[str, Dict[str, Tuple[Callable, str]]] = {
    "lr": {"seed": _SEED, "iters": _int_range(1, 1_000_000),
           "lr": _positive(), "l2": _nonneg(),
           "solver": _choice("auto", "newton", "adam")},
    "dt": {"seed": _SEED, "max_depth": _int_range(1, 12),
           "n_bins": _int_range(2, 256)},
    "rf": {"seed": _SEED, "max_depth": _int_range(1, 12),
           "n_bins": _int_range(2, 256), "n_trees": _int_range(1, 1024),
           "mtry": _int_range(1, 65536)},
    "gb": {"seed": _SEED, "max_depth": _int_range(1, 12),
           "n_bins": _int_range(2, 256), "n_rounds": _int_range(1, 4096),
           "step_size": _positive()},
    "nb": {"seed": _SEED, "smoothing": _positive(),
           "event_model": _choice("gaussian", "multinomial")},
    "mlp": {"seed": _SEED, "hidden": _int_range(1, 65536),
            "iters": _int_range(1, 1_000_000), "lr": _positive(),
            "l2": _nonneg()},
    "tx": {"seed": _SEED, "d_model": _int_range(8, 4096),
           "n_heads": _int_range(1, 64), "n_layers": _int_range(1, 64),
           "d_ff": _int_range(8, 16384), "vocab": _int_range(0, 2 ** 22),
           "train_steps": _int_range(1, 1_000_000),
           "batch": _int_range(1, 1 << 22), "lr": _positive(),
           "causal": _boolean(), "remat": _boolean()},
}
#: ``tx``'s block (a key of ``transformer.BLOCKS``) and the ``mla_moe``
#: block's widths (models/transformer.py, models/moe.py), named after
#: DeepSeek-V3's config keys, then the ``kda_mla_moe`` block's own
#: (models/kda.py; Kimi Linear's keys) and its expert share
#: (``experts_held`` 0: every expert). Kept apart from ``HPARAM_SPECS["tx"]``, the
#: JAX package's table, so a request for the encoder block is told the
#: keys the encoder takes; one naming a block with fields, its fields too.
TX_BLOCK_SPECS: Dict[str, Tuple[Callable, str]] = {
    "block": _choice(*BLOCKS),
    "kv_lora_rank": _int_range(1, 8192),
    "qk_nope_head_dim": _int_range(1, 1024),
    "qk_rope_head_dim": _int_range(2, 1024),
    "v_head_dim": _int_range(1, 1024),
    "rope_theta": _positive(),
    "n_routed_experts": _int_range(1, 1024),
    "n_shared_experts": _int_range(0, 64),
    "num_experts_per_tok": _int_range(1, 1024),
    "moe_intermediate_size": _int_range(1, 65536),
    "first_k_dense_replace": _int_range(0, 64),
    "routed_scaling_factor": _positive(),
    "rms_norm_eps": _positive(),
    "linear_num_heads": _int_range(1, 256),
    "linear_head_dim": _int_range(1, 1024),
    "short_conv_kernel_size": _int_range(1, 64),
    "full_attn_every": _int_range(1, 64),
    "experts_held": _int_range(0, 1024),
    "expert_share": _int_range(0, 1023),
}


def validate_hparams(classifier: str, hparams: Any) -> None:
    """Reject unknown hyperparameter names and out-of-range values with a
    ValueError NAMING the offending key (the serving tier maps it to a
    406) — instead of the TypeError-500 a bad ``**kwargs`` splat would
    raise from deep inside a trainer."""
    get_trainer(classifier)  # unknown classifier: its own ValueError
    if hparams in (None, {}):
        return
    if not isinstance(hparams, dict):
        raise ValueError(
            f"hparams for classifier {classifier!r} must be an object of "
            f"name->value, got {type(hparams).__name__}")
    spec = known = HPARAM_SPECS[classifier]
    blk = None
    if classifier == "tx":
        spec = dict(spec, block=TX_BLOCK_SPECS["block"])
        blk = next((b for name, b in BLOCKS.items()
                    if name == hparams.get("block")), None)
        if blk is not None and blk.fields:
            spec = known = dict(spec, **{k: TX_BLOCK_SPECS[k]
                                         for k in blk.fields})
    for key, value in hparams.items():
        owners = [n for n, b in BLOCKS.items() if key in b.fields]
        if key not in spec and owners and classifier == "tx":
            raise ValueError(
                f"hparams {sorted(set(hparams) & set(TX_BLOCK_SPECS))} for "
                "classifier 'tx' need block "
                + " or ".join(repr(o) for o in owners))
        if key not in spec:
            raise ValueError(
                f"unknown hparam {key!r} for classifier {classifier!r}; "
                f"known: {sorted(known)}")
        check, expect = spec[key]
        if not check(value):
            raise ValueError(
                f"hparam {key!r} for classifier {classifier!r} is out of "
                f"range: expected {expect}, got {value!r}")
    if blk is not None:
        # The block's cross-field limits, its defaults filling the rest.
        blk.check(dict(blk.fields, **hparams))


def get_trainer(name: str) -> Callable:
    try:
        return CLASSIFIERS[name]
    except KeyError:
        raise ValueError(
            f"invalid classifier {name!r}; choose from "
            f"{sorted(CLASSIFIERS)}") from None


def predictor_for(kind: str, hparams: Dict) -> Callable:
    """Rebuild the (params, X) -> probs function for a persisted model.

    Every family's predictor is a module function parameterized only by
    static hparams, so a checkpoint of (kind, hparams, params) fully
    reconstructs a servable model (models/persistence.py)."""
    if kind in ("dt", "rf"):
        return partial(trees._forest_proba_static,
                       max_depth=int(hparams["max_depth"]))
    if kind == "gb":
        # ovr_classes marks a one-vs-rest multiclass booster stack
        # (leading class axis on the tree params); absent = binary.
        fn = (trees._gbt_ovr_proba_static if hparams.get("ovr_classes")
              else trees._gbt_proba_static)
        return partial(fn, max_depth=int(hparams["max_depth"]))
    if kind == "lr":
        return logistic._predict_proba
    if kind == "mlp":
        return mlp._predict_proba
    if kind == "nb":
        return (naive_bayes._predict_multinomial
                if hparams.get("event_model") == "multinomial"
                else naive_bayes._predict_proba)
    if kind == "tx":
        return sequence.predictor(hparams)
    raise ValueError(f"no predictor for classifier kind {kind!r}")
