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

Two blocks (``TxConfig.block``):

- ``encoder`` (the default, the JAX package's): learned absolute
  positions, pre-LayerNorm, full multi-head attention with one head
  width, a GELU FFN;
- ``mla_moe``, DeepSeek-V3's block at Moonlight-16B-A3B's widths by
  default: RMSNorm; latent attention (MLA) without query compression —
  ``q = x W_q`` per head split into a no-position part and a rotary
  part, ``[c, k_pe] = x W_kva``, ``c`` RMS-normed, ``[k_nope, v] = c
  W_kvb`` per head, RoPE on ``q_pe`` and on the one ``k_pe`` all heads
  share, scores over the concatenated widths scaled by 1/sqrt of it, a
  value width of its own, ``W_o`` over the heads' outputs; the first
  ``first_k_dense_replace`` layers a SwiGLU MLP of width ``d_ff``, the
  rest the expert layer of models/moe.py; a final RMSNorm, then the same
  mean-pooled head. No position table. Its parameters are drawn on the
  device from a seeded generator (``init_params_mla``). On the model
  axis the heads split ``wq``, ``wkv_b`` and ``wo``, the SwiGLU widths
  split the dense and expert weights; ``wkv_a``, the norms and the
  router are replicated. The loss adds the experts' sequence-wise
  balance loss, and each step ends with the correction-bias update.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from learningorchestra_tpu_torch.models import moe
from learningorchestra_tpu_torch.models.logistic import adam_update
from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, ProcessMesh, all_gather, all_reduce_,
    psum, pvary)
from learningorchestra_tpu_torch.parallel.ring_attention import (
    reference_attention, ring_attention)
from learningorchestra_tpu_torch.utils.regions import CLOSE, OPEN, mark


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
    #: ``encoder`` or ``mla_moe`` (the module docstring); the fields
    #: below are the ``mla_moe`` block's, named after DeepSeek-V3's
    #: config keys, at Moonlight-16B-A3B's published values.
    block: str = "encoder"
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5


#: The ``mla_moe`` block's fields, its hparams (their defaults above).
MLA_FIELDS = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
              "v_head_dim", "rope_theta", "n_routed_experts",
              "n_shared_experts", "num_experts_per_tok",
              "moe_intermediate_size", "first_k_dense_replace",
              "routed_scaling_factor", "rms_norm_eps")

#: A mesh of one rank with no process group: every collective is the
#: identity and the ring is blockwise attention on one device.
ONE_RANK = ProcessMesh((1, 1, 1))

#: Per-layer leaves, in the order of the JAX package's layer dict.
LAYER_LEAVES = ("ln1_g", "ln1_b", "wqkv", "wo", "ln2_g", "ln2_b", "w1",
                "b1", "w2", "b2")
#: Leaves that act on the pooled features (replicated over seq).
POOLED_LEAVES = ("head_w", "head_b")


#: The ``mla_moe`` block's leaves: every layer's attention leaves, then
#: the dense SwiGLU's (the first ``first_k_dense_replace`` layers) or the
#: expert layer's (models/moe.py).
MLA_LEAVES = ("attn_norm", "wq", "wkv_a", "kv_norm", "wkv_b", "wo",
              "ffn_norm")
DENSE_LEAVES = ("w1", "w3", "w2")
#: Leaves no gradient reaches: the experts' correction biases.
FROZEN_LEAVES = ("e_bias",)


def layer_leaves(cfg: TxConfig, i: int) -> tuple:
    """Layer ``i``'s leaf names, in order."""
    if cfg.block == "encoder":
        return LAYER_LEAVES
    if i < cfg.first_k_dense_replace:
        return MLA_LEAVES + DENSE_LEAVES
    return (MLA_LEAVES + moe.ROUTER_LEAVES + moe.EXPERT_LEAVES
            + (moe.SHARED_LEAVES if cfg.n_shared_experts else ()))


def moe_layers(cfg: TxConfig) -> List[int]:
    """The indices of the expert layers (none in the encoder block)."""
    if cfg.block == "encoder":
        return []
    return list(range(cfg.first_k_dense_replace, cfg.n_layers))


def param_names(cfg: TxConfig) -> List[str]:
    """The flat parameter keys in the fixed leaf order."""
    top = (["embed", "pos", "head_w", "head_b"] if cfg.block == "encoder"
           else ["embed", "final_norm", "head_w", "head_b"])
    return top + [f"layers.{i}.{n}" for i in range(cfg.n_layers)
                  for n in layer_leaves(cfg, i)]


def trainable(name: str) -> bool:
    return name.rsplit(".", 1)[-1] not in FROZEN_LEAVES


def param_shapes(cfg: TxConfig) -> Dict[str, tuple]:
    """The ``mla_moe`` block's whole (unsharded) leaf shapes, in order."""
    d, H, E = cfg.d_model, cfg.n_heads, cfg.n_routed_experts
    r, R = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    n, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    I, S = cfg.moe_intermediate_size, cfg.n_shared_experts
    leaf = {"attn_norm": (d,), "wq": (d, H, n + R), "wkv_a": (d, r + R),
            "kv_norm": (r,), "wkv_b": (r, H, n + dv), "wo": (H, dv, d),
            "ffn_norm": (d,), "w1": (d, cfg.d_ff), "w3": (d, cfg.d_ff),
            "w2": (cfg.d_ff, d), "router": (d, E), "e_bias": (E,),
            "experts_w1": (E, d, I), "experts_w3": (E, d, I),
            "experts_w2": (E, I, d), "shared_w1": (d, S * I),
            "shared_w3": (d, S * I), "shared_w2": (S * I, d)}
    top = {"embed": (cfg.vocab, d), "final_norm": (d,),
           "head_w": (d, cfg.n_classes), "head_b": (cfg.n_classes,)}
    out = {}
    for k in param_names(cfg):
        out[k] = top[k] if k in top else leaf[k.rsplit(".", 1)[-1]]
    return out


#: Standard deviation of the ``mla_moe`` block's normal draws (the
#: DeepSeek-V3 modeling code's ``initializer_range`` default, 0.02; the
#: Moonlight config gives none).
INIT_STD = 0.02


def init_leaf(name: str, shape: tuple, gen: torch.Generator) -> torch.Tensor:
    """One ``mla_moe`` leaf: ones for a norm's scale, zeros for the
    correction bias and the head's bias, else a normal draw of std
    ``INIT_STD`` from ``gen`` on its device."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("_norm"):
        return torch.ones(shape, dtype=torch.float32, device=gen.device)
    if leaf in ("e_bias", "head_b"):
        return torch.zeros(shape, dtype=torch.float32, device=gen.device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).mul_(INIT_STD)


def init_params_mla(gen: torch.Generator, cfg: TxConfig,
                    mesh: Optional[ProcessMesh] = None
                    ) -> Dict[str, torch.Tensor]:
    """The ``mla_moe`` block's params drawn on ``gen``'s device, leaf by
    leaf in ``param_names`` order; with a mesh, each leaf is cut to this
    rank's model-axis shard as soon as it is drawn."""
    specs = param_specs(cfg)
    out = {}
    for k, shape in param_shapes(cfg).items():
        v = init_leaf(k, shape, gen)
        dim = specs[k]
        if mesh is not None and dim is not None:
            M, mi = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
            w = v.shape[dim] // M
            v = v.narrow(dim, mi * w, w).contiguous()
        out[k] = v
    return out


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
_MODEL_DIM = {"wqkv": 2, "wo": 0, "w1": 1, "b1": 0, "w2": 0,
              # the mla_moe block: heads, the dense and expert widths
              "wq": 1, "wkv_b": 1, "w3": 1, "experts_w1": 2,
              "experts_w3": 2, "experts_w2": 1, "shared_w1": 1,
              "shared_w3": 1, "shared_w2": 0}


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


# --- the mla_moe block -------------------------------------------------------

def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta: float):
    """Rotate the last axis of ``x`` (B, T, ..., R) as R/2 interleaved
    pairs ``(x[2i], x[2i+1])`` by the angle ``pos · θ^(-2i/R)``,
    DeepSeek-V3's pairing; ``pos`` (T,) are global positions."""
    R = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, R, 2, dtype=torch.float32,
                                        device=x.device) / R))
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 3) + (R // 2,)
    cos, sin = ang.cos().view(shape), ang.sin().view(shape)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack((x1 * cos - x2 * sin, x1 * sin + x2 * cos),
                       dim=-1).flatten(-2)


def _mla(x, lyr, *, cfg: TxConfig, mesh: ProcessMesh, pos, timer):
    """Latent attention on this rank's heads, whole over the model axis."""
    n, R, eps = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.rms_norm_eps
    h = mark(_rms(x, lyr["attn_norm"], eps), timer, "mla", OPEN)
    # Replicated over the model axis: the latent and the shared k_pe.
    c, k_pe = (h @ lyr["wkv_a"]).split([cfg.kv_lora_rank, R], dim=-1)
    c = _rms(c, lyr["kv_norm"], eps)
    k_pe = rope(k_pe, pos, cfg.rope_theta)
    h, c, k_pe = (pvary(t, mesh, MODEL_AXIS) for t in (h, c, k_pe))
    q = torch.einsum("btd,dhe->bthe", h, lyr["wq"])
    q = torch.cat([q[..., :n], rope(q[..., n:], pos, cfg.rope_theta)],
                  dim=-1)
    kv = torch.einsum("btc,che->bthe", c, lyr["wkv_b"])
    k = torch.cat([kv[..., :n],
                   k_pe[:, :, None, :].expand(-1, -1, q.shape[2], -1)],
                  dim=-1)
    attn = ring_attention(q, k, kv[..., n:], mesh=mesh, causal=cfg.causal)
    out = torch.einsum("bthe,hed->btd", attn, lyr["wo"])
    return mark(psum(out, mesh, MODEL_AXIS), timer, "mla", CLOSE)


def _mla_layer(x, lyr, *, cfg: TxConfig, mesh: ProcessMesh, pos, i: int,
               timer, balance: bool):
    """One ``mla_moe`` layer: (x, this rank's balance-loss sum or None,
    the local expert loads or None)."""
    x = x + _mla(x, lyr, cfg=cfg, mesh=mesh, pos=pos, timer=timer)
    h = _rms(x, lyr["ffn_norm"], cfg.rms_norm_eps)
    if i < cfg.first_k_dense_replace:
        h = pvary(h, mesh, MODEL_AXIS)
        out = moe.swiglu(h, lyr["w1"], lyr["w3"], lyr["w2"])
        return x + psum(out, mesh, MODEL_AXIS), None, None
    out, bal, load = moe.moe_layer(mark(h, timer, "moe", OPEN), lyr,
                                   cfg=cfg, mesh=mesh, layer=i,
                                   balance=balance)
    return x + mark(out, timer, "moe", CLOSE), bal, load


def _forward_mla(params, tokens, *, cfg: TxConfig, mesh: ProcessMesh,
                 aux: Optional[dict]):
    seq_idx, seq_size = mesh.index(SEQ_AXIS), mesh.size(SEQ_AXIS)
    Tl = tokens.shape[1]
    pos = seq_idx * Tl + torch.arange(Tl, device=tokens.device)
    x = params["embed"][tokens.long()]
    timer = aux.get("timer") if aux is not None else None
    for i in range(cfg.n_layers):
        lyr = {n: params[f"layers.{i}.{n}"] for n in layer_leaves(cfg, i)}
        fn = partial(_mla_layer, cfg=cfg, mesh=mesh, pos=pos, i=i,
                     timer=timer, balance=aux is not None)
        if cfg.remat and torch.is_grad_enabled():
            # A whole recompute: every region mark is met again, in
            # pairs (utils/regions.py).
            with set_checkpoint_early_stop(False):
                x, bal, load = checkpoint(fn, x, lyr, use_reentrant=False)
        else:
            x, bal, load = fn(x, lyr)
        if aux is not None and load is not None:
            aux.setdefault("balance", []).append(bal)
            aux.setdefault("loads", []).append(load)
    x = _rms(x, params["final_norm"], cfg.rms_norm_eps)
    pool = psum(x.sum(dim=1), mesh, SEQ_AXIS) / (Tl * seq_size)
    return pool @ params["head_w"] + params["head_b"]


def forward_shard(params, tokens, *, cfg: TxConfig, mesh: ProcessMesh,
                  aux: Optional[dict] = None):
    """Per-rank forward. tokens: (B_local, T_local) integer → logits
    (B_local, n_classes), replicated over the model and seq axes. With
    ``aux`` (the ``mla_moe`` block), the expert layers' balance-loss sums
    and loads are appended to ``aux["balance"]`` and ``aux["loads"]``,
    and ``aux["timer"]`` (a ``regions.RegionTimer``) marks the attention
    and expert regions."""
    seq_idx, seq_size = mesh.index(SEQ_AXIS), mesh.size(SEQ_AXIS)
    Tl = tokens.shape[1]
    if Tl * seq_size > cfg.max_len:
        # An out-of-range position would index past the table.
        raise ValueError(
            f"sequence length {Tl * seq_size} exceeds max_len "
            f"{cfg.max_len}")
    if cfg.block != "encoder":
        return _forward_mla(params, tokens, cfg=cfg, mesh=mesh, aux=aux)
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


def loss_shard(params, tokens, labels, *, cfg: TxConfig, mesh: ProcessMesh,
               aux: Optional[dict] = None):
    """Mean cross-entropy over the global batch, on every rank; the
    ``mla_moe`` block adds α times its expert layers' sequence-wise
    balance loss, meaned over the batch's sequences (``aux`` receives
    what ``forward_shard`` puts in it)."""
    aux = {} if aux is None else aux
    logits = forward_shard(params, tokens, cfg=cfg, mesh=mesh, aux=aux)
    logp = torch.log_softmax(logits, dim=-1)
    local = -logp.gather(1, labels.long()[:, None]).sum()
    if aux.get("balance"):
        local = local + moe.BALANCE_ALPHA * sum(aux["balance"])
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
               mesh: ProcessMesh, lr: float, aux: Optional[dict] = None):
    """One Adam step on this rank's shard of params and of the batch.
    Returns (params, opt_state, loss); params and state are updated in
    place of their dict entries. The ``mla_moe`` block's step ends with
    the correction-bias update from the step's expert loads (``aux``, if
    given, keeps them, and its ``timer`` the region events)."""
    names = [k for k in params if trainable(k)]
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    full = dict(params)
    full.update(zip(names, leaves))
    aux = {} if aux is None else aux
    loss = loss_shard(full, tokens, labels, cfg=cfg, mesh=mesh, aux=aux)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    reduce_grads(grads, mesh)
    with torch.no_grad():
        adam_update(params, grads, opt_state, lr)
    if cfg.block != "encoder":
        moe.update_bias(params, moe_layers(cfg), aux["loads"], mesh)
    return params, opt_state, loss.detach()


# --- single-device numerics oracle (tests, predict) ------------------------

def forward_reference(params, tokens, *, cfg: TxConfig):
    """Unsharded forward: same math, no mesh — must match forward_shard.
    The ``mla_moe`` block's is ``forward_shard`` on a one-rank mesh (its
    attention blockwise)."""
    if cfg.block != "encoder":
        return forward_shard(params, tokens, cfg=cfg, mesh=ONE_RANK)
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
