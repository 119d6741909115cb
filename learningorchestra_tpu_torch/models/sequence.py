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
    BLOCKS, ONE_RANK, TxConfig, adam_init, forward_shard, gather_params,
    round_up, train_step)
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import regions, tracing


_lock = threading.Lock()
#: The last fit's step losses (``fit_losses``).
_losses: List[float] = []


def fit_losses() -> List[float]:
    """The mean loss of each training step of the last (or running)
    fit, read back as each step ends."""
    with _lock:
        return list(_losses)


def fit(runtime: DeviceRuntime, X: np.ndarray, y: np.ndarray,
        num_classes: int, seed: int = 0, *, d_model: int = 64,
        n_heads: int = 4, n_layers: int = 2, d_ff: int = 128,
        vocab: int = 0, train_steps: int = 300, batch: int = 1024,
        lr: float = 1e-3, causal: bool = False,
        remat: bool = False, block: str = TxConfig.block,
        **fields) -> TrainedModel:
    """Token-column design matrix → fitted transformer classifier.

    The feature columns ARE the sequence: column j holds token id at
    position j (the design matrix arrives float32; values cast back to
    int). ``vocab=0`` infers the vocabulary from the data. ``block``
    names an entry of ``transformer.BLOCKS`` (the encoder by default);
    the block's own widths are keyword arguments (its ``fields``, whose
    defaults fill the rest).
    """
    blk = BLOCKS.get(block)
    if blk is None or set(fields) - set(blk.fields):
        raise ValueError(f"tx block {block!r} with hparams {sorted(fields)}")
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
    T_pad = round_up(T, S)
    if T_pad > T:
        tokens_all = np.pad(tokens_all, ((0, 0), (0, T_pad - T)))
    n_heads = round_up(max(n_heads, 1), M)
    d_ff = round_up(max(d_ff, 1), M)
    widths = dict(blk.fields, d_model=d_model, n_heads=n_heads, d_ff=d_ff,
                  **fields)
    blk.resolve(widths, M)
    batch = min(round_up(batch, Dax), round_up(n, Dax))

    cfg = TxConfig(vocab=vocab, n_layers=n_layers, n_classes=num_classes,
                   max_len=T_pad, causal=causal, remat=remat, block=block,
                   **widths)
    init_attrs = {}
    with tracing.span("tx.init", init_attrs):
        params = blk.init(seed, cfg, mesh, dev)
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
            aux, held = {}, moe.counts()["pairs_held"]
            if sp is not None and sp.sampled and dev.type == "cuda":
                aux["timer"] = regions.RegionTimer()
            params, opt_state, loss = train_step(
                params, opt_state, bt, bl, cfg=cfg, mesh=mesh, lr=lr,
                aux=aux)
            # The step's one read-back: the loss, once the step's work,
            # the Adam update and the block's after-step included, is done.
            attrs["loss"] = value = float(loss)
            # The device time of each region the block marked
            # (``kda_ms``, ``mla_ms``, ``moe_ms``), the expert loads and
            # the (token, expert) pairs the held experts computed, if any.
            if "timer" in aux:
                attrs.update((f"{r}_ms", 1e3 * s)
                             for r, s in aux["timer"].seconds().items())
            if aux.get("loads"):
                counts = moe.counts()
                attrs["load_ratio"] = max(
                    (b / m for b, m in counts["loads"].values()),
                    default=0.0)
                attrs["pairs_held"] = counts["pairs_held"] - held
        with _lock:
            _losses.append(value)

    # Whole params on every rank: predict then runs the unsharded forward
    # on any topology, and saving stays a process-local numpy write.
    del opt_state
    params = gather_params(params, cfg, mesh)
    hp = dict({k: getattr(cfg, k) for k in SAVED_WIDTHS}, causal=causal,
              train_steps=train_steps, lr=lr)
    # A model of the default block keeps the JAX package's hparams, with
    # no ``block`` key: models saved before blocks existed load as it.
    if blk is not BLOCKS[TxConfig.block]:
        hp.update(block=block, **{k: getattr(cfg, k) for k in blk.fields})
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
    the experts' k rows a token) widest layer (the block's
    ``token_floats``)."""
    from learningorchestra_tpu_torch.parallel.ring_attention import KV_BLOCK

    T = cfg.max_len
    return 4 * T * BLOCKS[cfg.block].token_floats(cfg, min(KV_BLOCK, T))


#: The ``TxConfig`` widths a saved tx model's hparams hold, beside
#: ``causal``, ``train_steps``, ``lr`` and a block's own fields.
SAVED_WIDTHS = ("vocab", "d_model", "n_heads", "n_layers", "d_ff",
                "n_classes", "max_len")


def config_from_hparams(hparams: dict) -> TxConfig:
    """The TxConfig a (possibly restored) tx model's hparams describe."""
    block = hparams.get("block", TxConfig.block)
    return TxConfig(causal=bool(hparams.get("causal", False)), block=block,
                    **{k: type(getattr(TxConfig, k))(hparams[k]) for k in
                       SAVED_WIDTHS + tuple(BLOCKS[block].fields)})


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
