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

Parameters are a flat dict of float32 tensors: ``embed``, the block's
other top-level leaves, ``head_w``, ``head_b`` and ``layers.<i>.<name>``
— what ``TrainedModel`` and ``persistence`` take. The optimizer is
``logistic.adam_update`` (optax's Adam, written out).

``TxConfig.block`` names an entry of ``BLOCKS``, which holds all that the
trainer, the registry and the predictor need of a block; three exist:

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
  device from a seeded generator. On the model axis the heads split
  ``wq``, ``wkv_b`` and ``wo``, the SwiGLU widths split the dense and
  expert weights; ``wkv_a``, the norms and the router are replicated.
  The loss adds the experts' sequence-wise balance loss, and each step
  ends with the correction-bias update;
- ``kda_mla_moe``, Kimi Linear's hybrid block at Kimi-Linear-48B-A3B's
  widths by default: ``mla_moe``'s layers, but for the attention of every
  layer i with (i + 1) mod ``full_attn_every`` ≠ 0, which is Kimi Delta
  Attention (models/kda.py), and latent attention without positions
  (``rope = False``: no rotation, the ``qk_rope_head_dim``-wide part of
  q and k kept); the expert layer may hold a share of the experts
  (``experts_held``, ``expert_share``; models/moe.py). No seq axis: the
  recurrent state is not passed between seq ranks. See
  ``KdaMlaMoeBlock`` for its departures from the published model.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from learningorchestra_tpu_torch.models import kda, moe
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
    #: A key of ``BLOCKS``; the fields below are the ``mla_moe`` block's,
    #: named after DeepSeek-V3's config keys, at Moonlight-16B-A3B's
    #: published values.
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
    #: The ``kda_mla_moe`` block's own fields (Kimi Linear's config keys;
    #: ``KdaMlaMoeBlock.fields`` holds its defaults) and the expert share,
    #: 0 experts held meaning all of them.
    linear_num_heads: int = 32
    linear_head_dim: int = 128
    short_conv_kernel_size: int = 4
    full_attn_every: int = 4
    experts_held: int = 0
    expert_share: int = 0


#: A mesh of one rank with no process group: every collective is the
#: identity and the ring is blockwise attention on one device.
ONE_RANK = ProcessMesh((1, 1, 1))

#: Leaves that act on the pooled features (replicated over seq).
POOLED_LEAVES = ("head_w", "head_b")
#: Leaves no gradient reaches: the experts' correction biases.
FROZEN_LEAVES = ("e_bias",)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def param_shapes(cfg: TxConfig) -> Dict[str, tuple]:
    """The whole (unsharded) leaf shapes, in the fixed leaf order: the
    top-level leaves, then ``layers.<i>.<name>``."""
    top, layer = BLOCKS[cfg.block].shapes(cfg)
    return dict(top, **{f"layers.{i}.{n}": v for i in range(cfg.n_layers)
                        for n, v in layer(i).items()})


def param_names(cfg: TxConfig) -> List[str]:
    """The flat parameter keys in the fixed leaf order."""
    return list(param_shapes(cfg))


def param_specs(cfg: TxConfig) -> Dict[str, Optional[int]]:
    """The model-axis dimension of each leaf, None for a replicated one
    (the JAX ``param_specs``: heads and the FFN hidden dimension)."""
    split = BLOCKS[cfg.block].split
    return {k: split.get(_leaf(k)) for k in param_shapes(cfg)}


def trainable(name: str) -> bool:
    return _leaf(name) not in FROZEN_LEAVES


def _shard(v: torch.Tensor, dim: Optional[int], mesh: ProcessMesh):
    """This rank's model-axis slice of a whole leaf."""
    if dim is None:
        return v
    w = v.shape[dim] // mesh.size(MODEL_AXIS)
    return v.narrow(dim, mesh.index(MODEL_AXIS) * w, w)


def shard_params(params: Dict[str, torch.Tensor], cfg: TxConfig,
                 mesh: ProcessMesh) -> Dict[str, torch.Tensor]:
    """This rank's model-axis shard of whole params (no communication:
    every rank holds the whole params)."""
    return {k: _shard(params[k], dim, mesh).contiguous()
            for k, dim in param_specs(cfg).items()}


def gather_params(local: Dict[str, torch.Tensor], cfg: TxConfig,
                  mesh: ProcessMesh) -> Dict[str, torch.Tensor]:
    """Whole params from every rank's model-axis shards (collective)."""
    return {k: (local[k] if dim is None
                else all_gather(local[k], mesh, MODEL_AXIS, dim))
            for k, dim in param_specs(cfg).items()}


class Block:
    """One ``tx`` block: all that the trainer, the registry and the
    predictor ask of it (``BLOCKS``), so that none of them names a block.

    ``shapes(cfg)`` gives the top-level leaves' whole shapes and
    ``i ↦`` layer i's, in order; ``split`` each split leaf's model-axis
    dimension. ``resolve(hp, M)`` checks ``hp`` (``d_model``, ``n_heads``
    and ``d_ff``, the last two rounded to the model axis's size ``M``, and
    the ``fields``) and rounds its widths. ``init(seed, cfg, mesh,
    device)`` draws this rank's shard; ``forward(params, tokens, *, cfg,
    mesh, aux)`` gives the hidden states before the pooling,
    ``reference(params, tokens, *, cfg)`` one device's logits, and
    ``token_floats(cfg, chunk)`` a token's float32 activations at once
    in the no-grad forward.
    """
    fields: Dict[str, object] = {}  # hparams beyond the encoder's: defaults

    def check(self, hp: dict) -> None:
        """Raise a ``ValueError`` where the fields do not fit together."""

    def after_step(self, params, cfg: TxConfig, aux: dict, mesh) -> None:
        """The end of a training step, after the Adam update."""


# --- the encoder block (the JAX package's) -----------------------------------

#: Per-layer leaves, in the order of the JAX package's layer dict.
LAYER_LEAVES = ("ln1_g", "ln1_b", "wqkv", "wo", "ln2_g", "ln2_b", "w1",
                "b1", "w2", "b2")


def init_params(gen: torch.Generator, cfg: TxConfig) -> Dict[str, torch.Tensor]:
    """The encoder's params at the JAX package's shapes and scales, drawn
    from ``gen`` (a CPU generator) in its order: gains one, biases zero,
    normals scaled by 0.02 for the tables, by 1/sqrt(d_model) for ``wo``
    and by 1/sqrt(fan-in) for the other weights."""
    out = {}
    for k, shape in param_shapes(cfg).items():
        leaf = _leaf(k)
        if leaf.endswith("_g"):
            out[k] = torch.ones(shape, dtype=torch.float32)
        elif leaf.endswith("_b") or leaf.startswith("b"):
            out[k] = torch.zeros(shape, dtype=torch.float32)
        else:
            scale = (0.02 if leaf in ("embed", "pos") else 1.0 / np.sqrt(
                cfg.d_model if leaf == "wo" else shape[0]))
            out[k] = torch.randn(shape, generator=gen,
                                 dtype=torch.float32) * scale
    return out


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


class EncoderBlock(Block):
    split = {"wqkv": 2, "wo": 0, "w1": 1, "b1": 0, "w2": 0}

    def resolve(self, hp: dict, M: int) -> None:
        hp["d_model"] = round_up(max(hp["d_model"], hp["n_heads"]),
                                 hp["n_heads"])

    def shapes(self, cfg: TxConfig):
        d, H, f = cfg.d_model, cfg.n_heads, cfg.d_ff
        layer = {"ln1_g": (d,), "ln1_b": (d,), "wqkv": (d, 3, H, d // H),
                 "wo": (H, d // H, d), "ln2_g": (d,), "ln2_b": (d,),
                 "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,)}
        return {"embed": (cfg.vocab, d), "pos": (cfg.max_len, d),
                "head_w": (d, cfg.n_classes),
                "head_b": (cfg.n_classes,)}, lambda i: layer

    def init(self, seed: int, cfg: TxConfig, mesh: ProcessMesh, device):
        # Drawn whole on the host, in the JAX package's order, then sharded.
        whole = init_params(torch.Generator().manual_seed(int(seed)), cfg)
        return {k: v.to(device)
                for k, v in shard_params(whole, cfg, mesh).items()}

    def forward(self, params, tokens, *, cfg: TxConfig, mesh: ProcessMesh,
                aux: Optional[dict]):
        Tl, dev = tokens.shape[1], tokens.device
        tokens = tokens.long()
        pos = mesh.index(SEQ_AXIS) * Tl + torch.arange(Tl, device=dev)
        x = params["embed"][tokens] + params["pos"][pos][None, :, :]
        layer_fn = partial(_layer, cfg=cfg, mesh=mesh)
        for lyr in _layers(params, cfg):
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer_fn, x, lyr, use_reentrant=False)
            else:
                x = layer_fn(x, lyr)
        return x

    def reference(self, params, tokens, *, cfg: TxConfig):
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
            attn = reference_attention(qkv[:, :, 0], qkv[:, :, 1],
                                       qkv[:, :, 2], causal=cfg.causal)
            x = x + torch.einsum("bthe,hed->btd", attn, lyr["wo"])
            h = _ln(x, lyr["ln2_g"], lyr["ln2_b"])
            x = x + F.gelu(h @ lyr["w1"] + lyr["b1"],
                           approximate="tanh") @ lyr["w2"] + lyr["b2"]
        pool = x.mean(dim=1)
        return pool @ params["head_w"] + params["head_b"]

    def token_floats(self, cfg: TxConfig, chunk: int) -> int:
        d, H = cfg.d_model, cfg.n_heads
        hd = d // max(H, 1)
        return 6 * d + 5 * H * hd + 3 * H * chunk + 2 * cfg.d_ff


# --- the mla_moe block -------------------------------------------------------

#: Every layer's attention leaves, then the dense SwiGLU's (the first
#: ``first_k_dense_replace`` layers) or the expert layer's (models/moe.py).
MLA_LEAVES = ("attn_norm", "wq", "wkv_a", "kv_norm", "wkv_b", "wo",
              "ffn_norm")
DENSE_LEAVES = ("w1", "w3", "w2")

#: Standard deviation of the block's normal draws (the DeepSeek-V3
#: modeling code's ``initializer_range`` default, 0.02; the Moonlight
#: config gives none).
INIT_STD = 0.02


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


def _mla(x, lyr, *, cfg: TxConfig, mesh: ProcessMesh, pos, timer,
         rope_pe: bool = True):
    """Latent attention on this rank's heads, whole over the model axis;
    without ``rope_pe`` no rotation."""
    n, R, eps = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.rms_norm_eps
    h = mark(_rms(x, lyr["attn_norm"], eps), timer, "mla", OPEN)
    # Replicated over the model axis: the latent and the shared k_pe.
    c, k_pe = (h @ lyr["wkv_a"]).split([cfg.kv_lora_rank, R], dim=-1)
    c = _rms(c, lyr["kv_norm"], eps)
    if rope_pe:
        k_pe = rope(k_pe, pos, cfg.rope_theta)
    h, c, k_pe = (pvary(t, mesh, MODEL_AXIS) for t in (h, c, k_pe))
    q = torch.einsum("btd,dhe->bthe", h, lyr["wq"])
    if rope_pe:
        q = torch.cat([q[..., :n], rope(q[..., n:], pos, cfg.rope_theta)],
                      dim=-1)
    kv = torch.einsum("btc,che->bthe", c, lyr["wkv_b"])
    k = torch.cat([kv[..., :n],
                   k_pe[:, :, None, :].expand(-1, -1, q.shape[2], -1)],
                  dim=-1)
    attn = ring_attention(q, k, kv[..., n:], mesh=mesh, causal=cfg.causal)
    out = torch.einsum("bthe,hed->btd", attn, lyr["wo"])
    return mark(psum(out, mesh, MODEL_AXIS), timer, "mla", CLOSE)


def _kda(x, lyr, *, cfg: TxConfig, mesh: ProcessMesh, pos, timer):
    """Kimi Delta Attention on this rank's heads, whole over the model
    axis."""
    h = mark(_rms(x, lyr["attn_norm"], cfg.rms_norm_eps), timer, "kda",
             OPEN)
    return mark(kda.attention(h, lyr, cfg=cfg, mesh=mesh), timer, "kda",
                CLOSE)


def _mla_layer(x, lyr, *, cfg: TxConfig, mesh: ProcessMesh, pos, i: int,
               timer, balance: bool, attn=_mla):
    """One ``mla_moe`` layer, or with ``attn`` another attention's: (x,
    this rank's balance-loss sum or None, the local expert loads or
    None)."""
    x = x + attn(x, lyr, cfg=cfg, mesh=mesh, pos=pos, timer=timer)
    h = _rms(x, lyr["ffn_norm"], cfg.rms_norm_eps)
    if i < cfg.first_k_dense_replace:
        h = pvary(h, mesh, MODEL_AXIS)
        out = moe.swiglu(h, lyr["w1"], lyr["w3"], lyr["w2"])
        return x + psum(out, mesh, MODEL_AXIS), None, None
    out, bal, load = moe.moe_layer(mark(h, timer, "moe", OPEN), lyr,
                                   cfg=cfg, mesh=mesh, layer=i,
                                   balance=balance)
    return x + mark(out, timer, "moe", CLOSE), bal, load


class MlaMoeBlock(Block):
    #: Whether the latent attention rotates its ``qk_rope_head_dim``-wide
    #: part (RoPE, ``rope_theta``).
    rope = True
    fields = {k: getattr(TxConfig, k) for k in (
        "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim", "rope_theta", "n_routed_experts", "n_shared_experts",
        "num_experts_per_tok", "moe_intermediate_size",
        "first_k_dense_replace", "routed_scaling_factor", "rms_norm_eps")}
    split = {"wq": 1, "wkv_b": 1, "wo": 0, "w1": 1, "w3": 1, "w2": 0,
             "experts_w1": 2, "experts_w3": 2, "experts_w2": 1,
             "shared_w1": 1, "shared_w3": 1, "shared_w2": 0}

    def layer(self, cfg: TxConfig, i: int) -> tuple:
        """Layer ``i``'s leaf names, in order."""
        if i < cfg.first_k_dense_replace:
            return MLA_LEAVES + DENSE_LEAVES
        return (MLA_LEAVES + moe.ROUTER_LEAVES + moe.EXPERT_LEAVES
                + (moe.SHARED_LEAVES if cfg.n_shared_experts else ()))

    def check(self, hp: dict) -> None:
        # Each field's own range is ``registry.HPARAM_SPECS``'s.
        if self.rope and hp["qk_rope_head_dim"] % 2:
            raise ValueError("hparam 'qk_rope_head_dim' for classifier 'tx' "
                             "must be even (RoPE rotates pairs), got "
                             f"{hp['qk_rope_head_dim']!r}")
        if hp["num_experts_per_tok"] > hp["n_routed_experts"]:
            raise ValueError(
                "hparam 'num_experts_per_tok' for classifier 'tx' must be at "
                f"most n_routed_experts ({hp['n_routed_experts']}), got "
                f"{hp['num_experts_per_tok']!r}")

    def resolve(self, hp: dict, M: int) -> None:
        self.check(hp)
        I = round_up(hp["moe_intermediate_size"], M)
        hp["moe_intermediate_size"] = I

    def shapes(self, cfg: TxConfig):
        leaf = self.leaf_shapes(cfg)
        return ({"embed": (cfg.vocab, cfg.d_model),
                 "final_norm": (cfg.d_model,),
                 "head_w": (cfg.d_model, cfg.n_classes),
                 "head_b": (cfg.n_classes,)},
                lambda i: {k: leaf[k] for k in self.layer(cfg, i)})

    def leaf_shapes(self, cfg: TxConfig) -> dict:
        """Every layer leaf's shape by its name; the expert stacks hold
        ``experts_held`` experts (0: all)."""
        d, H, E = cfg.d_model, cfg.n_heads, cfg.n_routed_experts
        r, R = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        n, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
        I, S = cfg.moe_intermediate_size, cfg.n_shared_experts
        held = cfg.experts_held or E
        return {"attn_norm": (d,), "wq": (d, H, n + R), "wkv_a": (d, r + R),
                "kv_norm": (r,), "wkv_b": (r, H, n + dv), "wo": (H, dv, d),
                "ffn_norm": (d,), "w1": (d, cfg.d_ff), "w3": (d, cfg.d_ff),
                "w2": (cfg.d_ff, d), "router": (d, E), "e_bias": (E,),
                "experts_w1": (held, d, I), "experts_w3": (held, d, I),
                "experts_w2": (held, I, d), "shared_w1": (d, S * I),
                "shared_w3": (d, S * I), "shared_w2": (S * I, d)}

    def init(self, seed: int, cfg: TxConfig, mesh: ProcessMesh, device):
        """Drawn on the device leaf by leaf in ``param_names`` order, each
        cut to this rank's model-axis shard as soon as it is drawn
        (billions of host normals and their copy would outweigh the fit):
        ones for a norm's scale, zeros for the correction bias and the
        head's bias, else a normal draw of std ``INIT_STD``."""
        self.on_mesh(mesh)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        specs, out = param_specs(cfg), {}
        for k, shape in param_shapes(cfg).items():
            out[k] = _shard(self.draw(_leaf(k), shape, gen), specs[k],
                            mesh).contiguous()
        return out

    def draw(self, leaf: str, shape, gen: torch.Generator):
        dev = gen.device
        if leaf.endswith("_norm"):
            return torch.ones(shape, dtype=torch.float32, device=dev)
        if leaf in ("e_bias", "head_b"):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev).mul_(INIT_STD)

    def on_mesh(self, mesh: ProcessMesh) -> None:
        """Raise a ``ValueError`` on a mesh the block cannot run on."""

    def attention(self, cfg: TxConfig, i: int):
        """Layer ``i``'s attention function."""
        return _mla if self.rope else partial(_mla, rope_pe=False)

    def forward(self, params, tokens, *, cfg: TxConfig, mesh: ProcessMesh,
                aux: Optional[dict]):
        self.on_mesh(mesh)
        Tl, dev = tokens.shape[1], tokens.device
        pos = mesh.index(SEQ_AXIS) * Tl + torch.arange(Tl, device=dev)
        x = params["embed"][tokens.long()]
        timer = aux.get("timer") if aux is not None else None
        for i in range(cfg.n_layers):
            lyr = {n: params[f"layers.{i}.{n}"] for n in self.layer(cfg, i)}
            fn = partial(_mla_layer, cfg=cfg, mesh=mesh, pos=pos, i=i,
                         timer=timer, balance=aux is not None,
                         attn=self.attention(cfg, i))
            if cfg.remat and torch.is_grad_enabled():
                # A whole recompute: every region mark is met again, in
                # pairs (utils/regions.py).
                with set_checkpoint_early_stop(False):
                    x, bal, load = checkpoint(fn, x, lyr,
                                              use_reentrant=False)
            else:
                x, bal, load = fn(x, lyr)
            if aux is not None and load is not None:
                aux.setdefault("balance", []).append(bal)
                aux.setdefault("loads", []).append(load)
        return _rms(x, params["final_norm"], cfg.rms_norm_eps)

    def reference(self, params, tokens, *, cfg: TxConfig):
        return forward_shard(params, tokens, cfg=cfg, mesh=ONE_RANK)

    def after_step(self, params, cfg, aux, mesh):
        # The correction-bias update from the step's expert loads.
        moe.update_bias(params, range(cfg.first_k_dense_replace, cfg.n_layers),
                        aux.get("loads", []), mesh)

    def token_floats(self, cfg: TxConfig, chunk: int) -> int:
        return self.attn_floats(cfg, chunk) + self.ffn_floats(cfg)

    def attn_floats(self, cfg: TxConfig, chunk: int) -> int:
        d, H = cfg.d_model, cfg.n_heads
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return (6 * d + cfg.kv_lora_rank + 3 * H * qk
                + 3 * H * cfg.v_head_dim + 3 * H * chunk)

    def ffn_floats(self, cfg: TxConfig) -> int:
        k, I = cfg.num_experts_per_tok, cfg.moe_intermediate_size
        return max(3 * cfg.d_ff, k * (3 * cfg.d_model + 4 * I)
                   + 3 * cfg.n_shared_experts * I)


# --- the kda_mla_moe block ---------------------------------------------------

#: A KDA layer's attention leaves (models/kda.py), between the two norms.
KDA_LEAVES = ("attn_norm",) + kda.LEAVES + ("ffn_norm",)


class KdaMlaMoeBlock(MlaMoeBlock):
    """Kimi Linear's hybrid block (``mla_moe``'s layers with KDA in three
    layers of four), at Kimi-Linear-48B-A3B's published widths by
    default. Departures from the published model, beside ``mla_moe``'s
    (the ``tx`` head for the LM head, Adam): the layer pattern is by
    period, layer i full attention where (i + 1) mod ``full_attn_every``
    = 0 (the published list, 4, 8, …, 24 and 27 counted from 1, agrees
    on layers 1–26); the q/k L2 norm's ε is 1e-6,
    flash-linear-attention's; A_log, dt_bias and the gate's bias are
    drawn as ``kda.draw`` says, every other matrix and convolution weight
    normal(0, 0.02), norms one, biases zero."""
    rope = False
    fields = dict({k: v for k, v in MlaMoeBlock.fields.items()
                   if k != "rope_theta"},
                  n_routed_experts=256, n_shared_experts=1,
                  num_experts_per_tok=8, moe_intermediate_size=1024,
                  linear_num_heads=32, linear_head_dim=128,
                  short_conv_kernel_size=4, full_attn_every=4,
                  experts_held=0, expert_share=0)
    split = dict(MlaMoeBlock.split, **kda.SPLIT)

    @staticmethod
    def full(cfg: TxConfig, i: int) -> bool:
        return (i + 1) % cfg.full_attn_every == 0

    def layer(self, cfg: TxConfig, i: int) -> tuple:
        names = super().layer(cfg, i)
        if self.full(cfg, i):
            return names
        return KDA_LEAVES + names[len(MLA_LEAVES):]

    def check(self, hp: dict) -> None:
        super().check(hp)
        E, held = hp["n_routed_experts"], hp["experts_held"]
        if held and E % held:
            raise ValueError(
                "hparam 'experts_held' for classifier 'tx' must divide "
                f"n_routed_experts ({E}), got {held!r}")
        shares = E // held if held else 1
        if hp["expert_share"] >= shares:
            raise ValueError(
                "hparam 'expert_share' for classifier 'tx' must be below "
                f"the number of shares ({shares}), got "
                f"{hp['expert_share']!r}")

    def resolve(self, hp: dict, M: int) -> None:
        super().resolve(hp, M)
        hp["linear_num_heads"] = round_up(hp["linear_num_heads"], M)

    def leaf_shapes(self, cfg: TxConfig) -> dict:
        return dict(super().leaf_shapes(cfg), **kda.shapes(cfg))

    def draw(self, leaf: str, shape, gen: torch.Generator):
        v = kda.draw(leaf, shape, gen)
        return super().draw(leaf, shape, gen) if v is None else v

    def on_mesh(self, mesh: ProcessMesh) -> None:
        if mesh.size(SEQ_AXIS) > 1:
            raise ValueError(
                "tx block 'kda_mla_moe' needs a seq axis of 1 (its "
                "recurrent state is not passed between seq ranks), got "
                f"{mesh.size(SEQ_AXIS)}")

    def attention(self, cfg: TxConfig, i: int):
        return super().attention(cfg, i) if self.full(cfg, i) else _kda

    def attn_floats(self, cfg: TxConfig, chunk: int) -> int:
        return max(super().attn_floats(cfg, chunk), kda.token_floats(cfg))


# --- the step ----------------------------------------------------------------

def forward_shard(params, tokens, *, cfg: TxConfig, mesh: ProcessMesh,
                  aux: Optional[dict] = None):
    """Per-rank forward. tokens: (B_local, T_local) integer → logits
    (B_local, n_classes), replicated over the model and seq axes. With
    ``aux`` (the ``mla_moe`` block), the expert layers' balance-loss sums
    and loads are appended to ``aux["balance"]`` and ``aux["loads"]``,
    and ``aux["timer"]`` (a ``regions.RegionTimer``) marks the attention
    and expert regions."""
    seq_size = mesh.size(SEQ_AXIS)
    Tl = tokens.shape[1]
    if Tl * seq_size > cfg.max_len:
        # An out-of-range position would index past the table.
        raise ValueError(
            f"sequence length {Tl * seq_size} exceeds max_len "
            f"{cfg.max_len}")
    x = BLOCKS[cfg.block].forward(params, tokens, cfg=cfg, mesh=mesh,
                                  aux=aux)
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
    place of their dict entries. The block's ``after_step`` ends the step
    (``mla_moe``'s correction-bias update from the step's expert loads);
    ``aux``, if given, keeps what the forward put in it, and its
    ``timer`` the region events."""
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
    BLOCKS[cfg.block].after_step(params, cfg, aux, mesh)
    return params, opt_state, loss.detach()


def forward_reference(params, tokens, *, cfg: TxConfig):
    """Unsharded forward: same math, no mesh — must match forward_shard.
    The encoder's is the JAX package's oracle, written out; the
    ``mla_moe`` block's is ``forward_shard`` on a one-rank mesh (its
    attention blockwise)."""
    return BLOCKS[cfg.block].reference(params, tokens, cfg=cfg)


#: Every ``tx`` block by its ``TxConfig.block`` name.
BLOCKS: Dict[str, Block] = {"encoder": EncoderBlock(),
                            "mla_moe": MlaMoeBlock(),
                            "kda_mla_moe": KdaMlaMoeBlock()}
