"""Sequence transformer — the long-context model family (dp × tp × sp).

The port of the JAX package's ``models/transformer.py``. The training
step is one program per rank of the (data, model, seq) process mesh
(parallel/mesh.py):

- ``data``  — batch rows sharded;
- ``model`` — Megatron-style tensor parallelism: attention heads and the
  FFN hidden dimension are column-split, output projections row-split
  with one ``psum`` per block;
- ``seq``   — context parallelism: sequence length is sharded and exact
  attention runs as a ring of point-to-point hops
  (parallel/ring_attention.py).

The JAX package differentiates through ``shard_map``, whose replication
tracking gives every leaf its whole gradient. Here the collectives carry
their transposes (``pvary`` into the model-split regions, ``psum`` out of
them), which makes every leaf's gradient whole over the model axis; over
the data and seq axes each rank's gradient is its share, summed after
``backward`` returns, leaf by leaf in a fixed order (``reduce_grads``).
``head_w`` and ``head_b`` act on the pooled features, which the seq
``psum`` already made whole, so they are summed over data only.

Parameters are a flat dict of float32 tensors: ``embed``, ``pos``,
``head_w``, ``head_b`` and ``layers.<i>.<name>`` — what ``TrainedModel``
and ``persistence`` take. The optimizer is ``logistic.adam_update``
(optax's Adam, written out).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from learningorchestra_tpu_torch.models.logistic import adam_update
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, ProcessMesh, all_gather, all_reduce_,
    psum, pvary)
from learningorchestra_tpu_torch.parallel.ring_attention import (
    reference_attention, ring_attention)


@dataclass(frozen=True)
class TxConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 256
    n_classes: int = 2
    max_len: int = 1024
    causal: bool = False          # classifier default; True for LM-style
    #: Recompute each layer's activations in the backward pass
    #: (``torch.utils.checkpoint``): live activation memory O(1) in depth,
    #: the long-context lever (32k tokens on one card needs it).
    remat: bool = False


#: Per-layer leaves, in the order of the JAX package's layer dict.
LAYER_LEAVES = ("ln1_g", "ln1_b", "wqkv", "wo", "ln2_g", "ln2_b", "w1",
                "b1", "w2", "b2")
#: Leaves that act on the pooled features (replicated over seq).
POOLED_LEAVES = ("head_w", "head_b")


def param_names(cfg: TxConfig) -> List[str]:
    """The flat parameter keys in the fixed leaf order."""
    return (["embed", "pos", "head_w", "head_b"]
            + [f"layers.{i}.{n}" for i in range(cfg.n_layers)
               for n in LAYER_LEAVES])


def init_params(gen: torch.Generator, cfg: TxConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's shapes and scales, drawn from ``gen`` (a CPU
    generator) in its order."""
    hd = cfg.d_model // cfg.n_heads

    def dense(*shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[0])
        return torch.randn(shape, generator=gen, dtype=torch.float32) * scale

    def ones(n):
        return torch.ones(n, dtype=torch.float32)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32)

    params = {
        "embed": dense(cfg.vocab, cfg.d_model, scale=0.02),
        "pos": dense(cfg.max_len, cfg.d_model, scale=0.02),
        "head_w": dense(cfg.d_model, cfg.n_classes),
        "head_b": zeros(cfg.n_classes),
    }
    for i in range(cfg.n_layers):
        layer = {
            "ln1_g": ones(cfg.d_model), "ln1_b": zeros(cfg.d_model),
            "wqkv": dense(cfg.d_model, 3, cfg.n_heads, hd),
            "wo": dense(cfg.n_heads, hd, cfg.d_model,
                        scale=1.0 / np.sqrt(cfg.d_model)),
            "ln2_g": ones(cfg.d_model), "ln2_b": zeros(cfg.d_model),
            "w1": dense(cfg.d_model, cfg.d_ff),
            "b1": zeros(cfg.d_ff),
            "w2": dense(cfg.d_ff, cfg.d_model),
            "b2": zeros(cfg.d_model),
        }
        params.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return params


#: The model-axis split of each per-layer leaf (the dimension sharded;
#: heads and the FFN hidden dimension), the JAX ``param_specs``; every
#: other leaf is replicated.
_MODEL_DIM = {"wqkv": 2, "wo": 0, "w1": 1, "b1": 0, "w2": 0}


def param_specs(cfg: TxConfig) -> Dict[str, Optional[int]]:
    """The model-axis dimension of each leaf, None for a replicated one."""
    return {k: _MODEL_DIM.get(k.rsplit(".", 1)[-1]) for k in param_names(cfg)}


def shard_params(params: Dict[str, torch.Tensor], cfg: TxConfig,
                 mesh: ProcessMesh) -> Dict[str, torch.Tensor]:
    """This rank's model-axis shard of whole params (no communication:
    every rank holds the whole params)."""
    M, mi = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    out = {}
    for k, dim in param_specs(cfg).items():
        v = params[k]
        if dim is not None:
            w = v.shape[dim] // M
            v = v.narrow(dim, mi * w, w)
        out[k] = v.contiguous()
    return out


def gather_params(local: Dict[str, torch.Tensor], cfg: TxConfig,
                  mesh: ProcessMesh) -> Dict[str, torch.Tensor]:
    """Whole params from every rank's model-axis shards (collective)."""
    return {k: (local[k] if dim is None
                else all_gather(local[k], mesh, MODEL_AXIS, dim))
            for k, dim in param_specs(cfg).items()}


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _layer(x, lyr, *, cfg: TxConfig, mesh: ProcessMesh):
    # --- attention: heads column-split (tp), ring over seq (sp) ----------
    h = pvary(_ln(x, lyr["ln1_g"], lyr["ln1_b"]), mesh, MODEL_AXIS)
    qkv = torch.einsum("btd,dkhe->btkhe", h, lyr["wqkv"])
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = ring_attention(q, k, v, mesh=mesh, causal=cfg.causal)
    out = torch.einsum("bthe,hed->btd", attn, lyr["wo"])
    x = x + psum(out, mesh, MODEL_AXIS)          # row-parallel reduce
    # --- FFN: hidden dim column-split (tp) -------------------------------
    h = pvary(_ln(x, lyr["ln2_g"], lyr["ln2_b"]), mesh, MODEL_AXIS)
    ff = F.gelu(h @ lyr["w1"] + lyr["b1"], approximate="tanh")
    return x + psum(ff @ lyr["w2"], mesh, MODEL_AXIS) + lyr["b2"]


def _layers(params, cfg: TxConfig):
    for i in range(cfg.n_layers):
        yield {n: params[f"layers.{i}.{n}"] for n in LAYER_LEAVES}


def forward_shard(params, tokens, *, cfg: TxConfig, mesh: ProcessMesh):
    """Per-rank forward. tokens: (B_local, T_local) integer → logits
    (B_local, n_classes), replicated over the model and seq axes."""
    seq_idx, seq_size = mesh.index(SEQ_AXIS), mesh.size(SEQ_AXIS)
    Tl = tokens.shape[1]
    if Tl * seq_size > cfg.max_len:
        # An out-of-range position would index past the table.
        raise ValueError(
            f"sequence length {Tl * seq_size} exceeds max_len "
            f"{cfg.max_len}")
    tokens = tokens.long()
    pos = seq_idx * Tl + torch.arange(Tl, device=tokens.device)
    x = params["embed"][tokens] + params["pos"][pos][None, :, :]
    layer_fn = partial(_layer, cfg=cfg, mesh=mesh)
    for lyr in _layers(params, cfg):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(layer_fn, x, lyr, use_reentrant=False)
        else:
            x = layer_fn(x, lyr)
    # Mean-pool over the (sharded) sequence, then classify.
    pool = psum(x.sum(dim=1), mesh, SEQ_AXIS) / (Tl * seq_size)
    return pool @ params["head_w"] + params["head_b"]


def loss_shard(params, tokens, labels, *, cfg: TxConfig, mesh: ProcessMesh):
    """Mean cross-entropy over the global batch, on every rank."""
    logits = forward_shard(params, tokens, cfg=cfg, mesh=mesh)
    logp = torch.log_softmax(logits, dim=-1)
    local = -logp.gather(1, labels.long()[:, None]).sum()
    n = psum(torch.tensor(float(labels.shape[0]), dtype=torch.float32,
                          device=logits.device), mesh, DATA_AXIS)
    return psum(local, mesh, DATA_AXIS) / n


def reduce_grads(grads: Dict[str, torch.Tensor], mesh: ProcessMesh) -> None:
    """Sum each rank's gradient shares over the data and seq axes, in
    place of the dict's entries, leaf by leaf in the dict's (fixed) order
    — every rank issues the same all-reduces in the same order.
    ``POOLED_LEAVES`` are whole over seq already. (Autograd may hand back
    a strided gradient, an einsum's permuted view: each is made
    contiguous first.)"""
    for k in grads:
        grads[k] = g = grads[k].contiguous()
        all_reduce_(g, mesh, DATA_AXIS)
        if k not in POOLED_LEAVES:
            all_reduce_(g, mesh, SEQ_AXIS)


def adam_init(params: Dict[str, torch.Tensor]) -> dict:
    """optax.adam's state: zero moments, step count 0."""
    return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": 0}


def train_step(params, opt_state, tokens, labels, *, cfg: TxConfig,
               mesh: ProcessMesh, lr: float):
    """One Adam step on this rank's shard of params and of the batch.
    Returns (params, opt_state, loss); params and state are updated in
    place of their dict entries."""
    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    loss = loss_shard(dict(zip(names, leaves)), tokens, labels, cfg=cfg,
                      mesh=mesh)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    reduce_grads(grads, mesh)
    with torch.no_grad():
        adam_update(params, grads, opt_state, lr)
    return params, opt_state, loss.detach()


# --- single-device numerics oracle (tests, predict) ------------------------

def forward_reference(params, tokens, *, cfg: TxConfig):
    """Unsharded forward: same math, no mesh — must match forward_shard."""
    Tl = tokens.shape[1]
    if Tl > cfg.max_len:
        raise ValueError(f"sequence length {Tl} exceeds max_len "
                         f"{cfg.max_len}")
    tokens = tokens.long()
    x = (params["embed"][tokens]
         + params["pos"][torch.arange(Tl, device=tokens.device)][None])
    for lyr in _layers(params, cfg):
        h = _ln(x, lyr["ln1_g"], lyr["ln1_b"])
        qkv = torch.einsum("btd,dkhe->btkhe", h, lyr["wqkv"])
        attn = reference_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                   causal=cfg.causal)
        x = x + torch.einsum("bthe,hed->btd", attn, lyr["wo"])
        h = _ln(x, lyr["ln2_g"], lyr["ln2_b"])
        x = x + F.gelu(h @ lyr["w1"] + lyr["b1"],
                       approximate="tanh") @ lyr["w2"] + lyr["b2"]
    pool = x.mean(dim=1)
    return pool @ params["head_w"] + params["head_b"]
