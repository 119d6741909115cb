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

import numpy as np
import torch

from learningorchestra_tpu_torch.models.base import TrainedModel
from learningorchestra_tpu_torch.models.transformer import (
    TxConfig, adam_init, forward_reference, gather_params, init_params,
    shard_params, train_step)
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS)
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fit(runtime: DeviceRuntime, X: np.ndarray, y: np.ndarray,
        num_classes: int, seed: int = 0, *, d_model: int = 64,
        n_heads: int = 4, n_layers: int = 2, d_ff: int = 128,
        vocab: int = 0, train_steps: int = 300, batch: int = 1024,
        lr: float = 1e-3, causal: bool = False,
        remat: bool = False) -> TrainedModel:
    """Token-column design matrix → fitted transformer classifier.

    The feature columns ARE the sequence: column j holds token id at
    position j (the design matrix arrives float32; values cast back to
    int). ``vocab=0`` infers the vocabulary from the data.
    """
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
    d_model = _round_up(max(d_model, n_heads), n_heads)
    batch = min(_round_up(batch, Dax), _round_up(n, Dax))

    cfg = TxConfig(vocab=vocab, d_model=d_model, n_heads=n_heads,
                   n_layers=n_layers, d_ff=d_ff, n_classes=num_classes,
                   max_len=T_pad, causal=causal, remat=remat)
    whole = init_params(torch.Generator().manual_seed(int(seed)), cfg)
    params = {k: v.to(dev) for k, v in
              shard_params(whole, cfg, mesh).items()}
    opt_state = adam_init(params)

    # This rank's (data, seq) block of every batch.
    Bl, Tl = batch // Dax, T_pad // S
    r0 = mesh.index(DATA_AXIS) * Bl
    c0 = mesh.index(SEQ_AXIS) * Tl
    y_all = np.asarray(y, np.int32)
    rng = np.random.default_rng(seed)
    for _ in range(int(train_steps)):
        sel = rng.integers(0, n, batch)[r0:r0 + Bl]
        bt = torch.from_numpy(np.ascontiguousarray(
            tokens_all[sel, c0:c0 + Tl])).to(dev)
        bl = torch.from_numpy(y_all[sel]).to(dev)
        params, opt_state, _loss = train_step(
            params, opt_state, bt, bl, cfg=cfg, mesh=mesh, lr=lr)

    # Whole params on every rank: predict then runs the unsharded forward
    # on any topology, and saving stays a process-local numpy write.
    params = gather_params(params, cfg, mesh)
    hp = {"vocab": vocab, "d_model": d_model, "n_heads": n_heads,
          "n_layers": n_layers, "d_ff": d_ff, "n_classes": num_classes,
          "max_len": T_pad, "causal": causal, "train_steps": train_steps,
          "lr": lr}
    return TrainedModel(kind="tx", params=params,
                        predict_proba_fn=predictor(hp),
                        num_classes=num_classes, hparams=hp)


def predictor(hparams: dict):
    """(params, X_dev) → probs for a (possibly restored) tx model: token
    ids cast and clipped to the vocabulary, padded with token 0 to
    ``max_len``, through the unsharded forward. Its attention holds the
    whole (n, heads, max_len, max_len) scores, as the JAX package's does."""
    cfg = TxConfig(vocab=int(hparams["vocab"]),
                   d_model=int(hparams["d_model"]),
                   n_heads=int(hparams["n_heads"]),
                   n_layers=int(hparams["n_layers"]),
                   d_ff=int(hparams["d_ff"]),
                   n_classes=int(hparams["n_classes"]),
                   max_len=int(hparams["max_len"]),
                   causal=bool(hparams.get("causal", False)))

    def proba(params, X):
        tokens = torch.clamp(X.to(torch.int32), 0, cfg.vocab - 1)
        pad = cfg.max_len - tokens.shape[1]
        if pad < 0:
            raise ValueError(
                f"dataset has {tokens.shape[1]} token columns but the "
                f"model was trained with max_len {cfg.max_len}")
        if pad:
            tokens = torch.nn.functional.pad(tokens, (0, pad))
        with torch.no_grad():
            return torch.softmax(
                forward_reference(params, tokens, cfg=cfg), dim=-1)

    return proba
