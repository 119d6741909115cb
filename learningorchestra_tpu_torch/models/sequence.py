"""Sequence-classifier trainer ("tx") — the transformer as a product
surface.

The port of the JAX package's ``models/sequence.py``: a stored dataset
whose feature columns are token ids trains through ``POST /models`` with
``classificators_list: ["tx"]``, is saved as one ``params.npz``, and
re-serves through ``/trained-models`` like every other family.

The train step is the 3-axis program of models/transformer.py on the
runtime's process mesh: every rank draws the same batch from the seeded
generator and takes its own (data, seq) block of it, attention heads and
the FFN hidden dimension split over ``model``. After the fit the
model-axis shards are gathered, so every rank holds whole params and
predicts with the unsharded forward.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np
import torch

from learningorchestra_tpu_torch.models import moe
from learningorchestra_tpu_torch.models.base import TrainedModel
from learningorchestra_tpu_torch.models.transformer import (
    MLA_FIELDS, ONE_RANK, TxConfig, adam_init, forward_shard, gather_params,
    init_params, init_params_mla, shard_params, train_step)
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import regions, tracing


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


#: The ``mla_moe`` block's hparams, named after DeepSeek-V3's config
#: keys, and their defaults: Moonlight-16B-A3B's published values.
MLA_HPARAMS = {k: getattr(TxConfig, k) for k in MLA_FIELDS}

_lock = threading.Lock()
#: The last fit's step losses (``fit_losses``).
_losses: List[float] = []


def fit_losses() -> List[float]:
    """The mean loss of each training step of the last (or running)
    fit, read back as each step ends."""
    with _lock:
        return list(_losses)


def check_mla(hp: dict) -> None:
    """The ``mla_moe`` block's cross-field limits (each field's own range
    is ``registry.HPARAM_SPECS``'s)."""
    if hp["qk_rope_head_dim"] % 2:
        raise ValueError("hparam 'qk_rope_head_dim' for classifier 'tx' "
                         "must be even (RoPE rotates pairs), got "
                         f"{hp['qk_rope_head_dim']!r}")
    if hp["num_experts_per_tok"] > hp["n_routed_experts"]:
        raise ValueError(
            "hparam 'num_experts_per_tok' for classifier 'tx' must be at "
            f"most n_routed_experts ({hp['n_routed_experts']}), got "
            f"{hp['num_experts_per_tok']!r}")


def fit(runtime: DeviceRuntime, X: np.ndarray, y: np.ndarray,
        num_classes: int, seed: int = 0, *, d_model: int = 64,
        n_heads: int = 4, n_layers: int = 2, d_ff: int = 128,
        vocab: int = 0, train_steps: int = 300, batch: int = 1024,
        lr: float = 1e-3, causal: bool = False,
        remat: bool = False, block: str = "encoder",
        **mla) -> TrainedModel:
    """Token-column design matrix → fitted transformer classifier.

    The feature columns ARE the sequence: column j holds token id at
    position j (the design matrix arrives float32; values cast back to
    int). ``vocab=0`` infers the vocabulary from the data. ``block``
    picks the encoder (the default) or ``mla_moe``, whose widths are the
    keyword arguments of ``MLA_HPARAMS`` (its defaults where absent).
    """
    if block not in ("encoder", "mla_moe") or (block == "encoder" and mla):
        raise ValueError(f"tx block {block!r} with hparams {sorted(mla)}")
    mesh = runtime.mesh
    dev = runtime.device
    tokens_all = np.maximum(np.asarray(X, np.float32), 0.0).astype(np.int32)
    n, T = tokens_all.shape
    if n == 0 or T == 0:
        raise ValueError("tx needs at least one row and one token column")
    if not vocab:
        vocab = int(tokens_all.max()) + 1
    vocab = max(int(vocab), 2)
    tokens_all = np.minimum(tokens_all, vocab - 1)

    # Round every sharded dimension up to its mesh axis: T to the seq
    # axis (pad token 0), heads/FFN to the model axis, batch to the data
    # axis — the same program then runs on one device or a dp×tp×sp mesh.
    S = mesh.size(SEQ_AXIS)
    Dax = mesh.size(DATA_AXIS)
    M = mesh.size(MODEL_AXIS)
    T_pad = _round_up(T, S)
    if T_pad > T:
        tokens_all = np.pad(tokens_all, ((0, 0), (0, T_pad - T)))
    n_heads = _round_up(max(n_heads, 1), M)
    d_ff = _round_up(max(d_ff, 1), M)
    if block == "encoder":
        d_model = _round_up(max(d_model, n_heads), n_heads)
    else:
        mla = dict(MLA_HPARAMS, **mla)
        check_mla(mla)
        mla["moe_intermediate_size"] = _round_up(
            mla["moe_intermediate_size"], M)
    batch = min(_round_up(batch, Dax), _round_up(n, Dax))

    cfg = TxConfig(vocab=vocab, d_model=d_model, n_heads=n_heads,
                   n_layers=n_layers, d_ff=d_ff, n_classes=num_classes,
                   max_len=T_pad, causal=causal, remat=remat, block=block,
                   **({} if block == "encoder" else mla))
    init_attrs = {}
    with tracing.span("tx.init", init_attrs):
        if block == "encoder":
            whole = init_params(torch.Generator().manual_seed(int(seed)),
                                cfg)
            params = {k: v.to(dev) for k, v in
                      shard_params(whole, cfg, mesh).items()}
            del whole
        else:
            # Drawn on the device: billions of host normals and their copy
            # would outweigh the fit.
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            params = init_params_mla(gen, cfg, mesh)
        init_attrs.update(
            params=sum(v.numel() for v in params.values()),
            bytes=sum(v.numel() * v.element_size() for v in params.values()))
    opt_state = adam_init(params)

    # This rank's (data, seq) block of every batch.
    Bl, Tl = batch // Dax, T_pad // S
    r0 = mesh.index(DATA_AXIS) * Bl
    c0 = mesh.index(SEQ_AXIS) * Tl
    y_all = np.asarray(y, np.int32)
    rng = np.random.default_rng(seed)
    with _lock:
        _losses.clear()
    for _ in range(int(train_steps)):
        sel = rng.integers(0, n, batch)[r0:r0 + Bl]
        bt = torch.from_numpy(np.ascontiguousarray(
            tokens_all[sel, c0:c0 + Tl])).to(dev)
        bl = torch.from_numpy(y_all[sel]).to(dev)
        attrs = {"tokens": int(bt.numel())}
        with tracing.span("tx.step", attrs) as sp:
            aux = None if block == "encoder" else {}
            if (aux is not None and sp is not None and sp.sampled
                    and dev.type == "cuda"):
                aux["timer"] = regions.RegionTimer()
            params, opt_state, loss = train_step(
                params, opt_state, bt, bl, cfg=cfg, mesh=mesh, lr=lr,
                aux=aux)
            # The step's one read-back: the loss, once the step's work,
            # the Adam update and the bias update included, is done.
            attrs["loss"] = value = float(loss)
            if aux is not None and "timer" in aux:
                dt = aux["timer"].seconds()
                attrs["mla_ms"] = 1e3 * dt.get("mla", 0.0)
                attrs["moe_ms"] = 1e3 * dt.get("moe", 0.0)
            if aux is not None:
                loads = moe.counts()["loads"]
                attrs["load_ratio"] = max(
                    (b / m for b, m in loads.values()), default=0.0)
        with _lock:
            _losses.append(value)

    # Whole params on every rank: predict then runs the unsharded forward
    # on any topology, and saving stays a process-local numpy write.
    del opt_state
    params = gather_params(params, cfg, mesh)
    hp = {"vocab": vocab, "d_model": d_model, "n_heads": n_heads,
          "n_layers": n_layers, "d_ff": d_ff, "n_classes": num_classes,
          "max_len": T_pad, "causal": causal, "train_steps": train_steps,
          "lr": lr}
    if block != "encoder":
        hp.update(block=block, **mla)
    return TrainedModel(kind="tx", params=params,
                        predict_proba_fn=predictor(hp),
                        num_classes=num_classes, hparams=hp)


#: Device bytes a predict chunk's activations may take (the predictor's
#: rows a chunk follow from ``row_bytes``).
PREDICT_BYTES = 8 << 30


def row_bytes(cfg: TxConfig) -> int:
    """An upper estimate of one row's float32 activations at once in the
    no-grad forward: the residual stream and norms, the attention's
    projections and one key chunk's scores, and the feed-forward's (or
    the experts' k rows a token) widest layer."""
    from learningorchestra_tpu_torch.parallel.ring_attention import KV_BLOCK

    T, d, H = cfg.max_len, cfg.d_model, cfg.n_heads
    chunk = min(KV_BLOCK, T)
    if cfg.block == "encoder":
        hd = d // max(H, 1)
        per_token = 6 * d + 5 * H * hd + 3 * H * chunk + 2 * cfg.d_ff
    else:
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        k, I = cfg.num_experts_per_tok, cfg.moe_intermediate_size
        per_token = (6 * d + cfg.kv_lora_rank + 3 * H * qk
                     + 3 * H * cfg.v_head_dim + 3 * H * chunk
                     + max(3 * cfg.d_ff, k * (3 * d + 4 * I)
                           + 3 * cfg.n_shared_experts * I))
    return 4 * T * per_token


def config_from_hparams(hparams: dict) -> TxConfig:
    """The TxConfig a (possibly restored) tx model's hparams describe."""
    extra = {}
    if hparams.get("block", "encoder") != "encoder":
        extra = {k: type(v)(hparams[k]) for k, v in MLA_HPARAMS.items()}
        extra["block"] = hparams["block"]
    return TxConfig(vocab=int(hparams["vocab"]),
                    d_model=int(hparams["d_model"]),
                    n_heads=int(hparams["n_heads"]),
                    n_layers=int(hparams["n_layers"]),
                    d_ff=int(hparams["d_ff"]),
                    n_classes=int(hparams["n_classes"]),
                    max_len=int(hparams["max_len"]),
                    causal=bool(hparams.get("causal", False)), **extra)


def predictor(hparams: dict):
    """(params, X_dev) → probs for a (possibly restored) tx model: token
    ids cast and clipped to the vocabulary, padded with token 0 to
    ``max_len``, through the unsharded forward with blockwise attention
    (the ring on one rank), in row chunks of at most ``PREDICT_BYTES``
    of activations (``row_bytes``), one ``tx.predict`` span a chunk."""
    cfg = config_from_hparams(hparams)

    def proba(params, X):
        tokens = torch.clamp(X.to(torch.int32), 0, cfg.vocab - 1)
        pad = cfg.max_len - tokens.shape[1]
        if pad < 0:
            raise ValueError(
                f"dataset has {tokens.shape[1]} token columns but the "
                f"model was trained with max_len {cfg.max_len}")
        if pad:
            tokens = torch.nn.functional.pad(tokens, (0, pad))
        rows = max(1, PREDICT_BYTES // row_bytes(cfg))
        out = []
        with torch.no_grad():
            for i in range(0, max(tokens.shape[0], 1), rows):
                part = tokens[i:i + rows]
                with tracing.span("tx.predict", rows=int(part.shape[0])):
                    out.append(torch.softmax(forward_shard(
                        params, part, cfg=cfg, mesh=ONE_RANK), dim=-1))
        return torch.cat(out)

    return proba
