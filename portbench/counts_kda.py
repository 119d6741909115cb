"""The work a ``tx`` build of the ``kda_mla_moe`` block needs, counted from
shapes alone: the yardstick of ``mfu.txbuild8k``.

A token's forward pass needs two operations a weight it multiplies. A
KDA layer (a layer i with (i + 1) mod ``full_attn_every`` ≠ 0): ``W_q``,
``W_k``, ``W_v``, ``W_f1``, ``W_f2``, ``W_b``, ``W_g1``, ``W_g2``,
``W_o``; its three causal convolutions, two operations a tap a channel;
and the recurrence, 7·d_k·d_v a head: decaying the state, ``k̂ᵀS``, the
rank-one update and ``Sᵀq̂`` (two operations an entry each, the decay
one). A latent-attention layer: ``W_q``, ``W_kva``, ``W_kvb``, ``W_o``,
and causal attention's (T + 1) / 2 keys a query on average, a score over
the query-key width and a weighted value over the value width, two
operations each, a head. Then the dense SwiGLU's three matrices, or the
router's and, a token, ``num_experts_per_tok`` × held / routed experts'
three matrices (the pairs this card's experts take, on average) and the
shared experts'. The classifier head once a sequence. A training token
costs three forward passes (the forward and the two products of the
backward pass); recomputation is not counted. A predicted token costs
one.
"""

from __future__ import annotations

from portbench import counts


def kda_flops(cfg: dict) -> float:
    """One token's forward operations in a KDA layer's attention."""
    d, H, e = cfg["d_model"], cfg["linear_num_heads"], cfg["linear_head_dim"]
    weights = (3 * d * H * e + d * e + e * H * e + d * H + d * e
               + e * H * e + H * e * d)
    conv = 3 * 2.0 * H * e * cfg["short_conv_kernel_size"]
    return 2.0 * weights + conv + 7.0 * H * e * e


def mla_flops(cfg: dict, T: int) -> float:
    """One token's forward operations in a latent-attention layer's
    attention at sequence length ``T``."""
    d, H = cfg["d_model"], cfg["n_heads"]
    n, R = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    weights = d * H * (n + R) + d * (r + R) + r * H * (n + dv) + H * dv * d
    return 2.0 * weights + 2.0 * H * (T + 1) / 2.0 * ((n + R) + dv)


def ffn_flops(cfg: dict, moe: bool) -> float:
    d = cfg["d_model"]
    if not moe:
        return 2.0 * 3 * d * cfg["d_ff"]
    E = cfg["n_routed_experts"]
    held = cfg["experts_held"] or E
    routed = cfg["num_experts_per_tok"] * held / E
    return 2.0 * (d * E + 3 * d * cfg["moe_intermediate_size"]
                  * (routed + cfg["n_shared_experts"]))


def layer_flops(cfg: dict, T: int, i: int) -> float:
    full = (i + 1) % cfg["full_attn_every"] == 0
    attn = mla_flops(cfg, T) if full else kda_flops(cfg)
    return attn + ffn_flops(cfg, i >= cfg["first_k_dense_replace"])


def forward_flops(cfg: dict, T: int) -> float:
    """One sequence's forward operations: every layer's for each of its
    ``T`` tokens, and the head once."""
    per_token = sum(layer_flops(cfg, T, i) for i in range(cfg["n_layers"]))
    return T * per_token + 2.0 * cfg["d_model"] * cfg["n_classes"]


def build_flops(cfg: dict, T: int, train_sequences: int,
                predict_sequences: int) -> float:
    f = forward_flops(cfg, T)
    return 3.0 * f * train_sequences + f * predict_sequences


def build_bound_s(cfg: dict, T: int, train_sequences: int,
                  predict_sequences: int) -> float:
    """A build's needed work as seconds at the card's float32 peak."""
    return counts.bound_s(0.0, build_flops(cfg, T, train_sequences,
                                           predict_sequences))
