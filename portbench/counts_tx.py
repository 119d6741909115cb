"""The work a ``tx`` build of the ``mla_moe`` block needs, counted from
shapes alone: the yardstick of ``mfu.txbuild``.

A token's forward pass needs two operations a weight it multiplies: in
every layer the attention's projections (``W_q``, ``W_kva``, ``W_kvb``,
``W_o``), then the dense SwiGLU's three matrices, or the router's and
the ``num_experts_per_tok`` routed experts' and the shared experts'
three matrices each; the classifier head once a sequence. Causal
attention adds, a query, (T + 1) / 2 keys on average, each a score over
the query-key width and a weighted value over the value width, two
operations each, per head. A training token costs three forward passes
(the forward and the two products of the backward pass); recomputation
is not counted. A predicted token costs one.
"""

from __future__ import annotations

from portbench import counts


def layer_flops(cfg: dict, T: int, moe: bool) -> float:
    """One token's forward operations in one layer at sequence length
    ``T``."""
    d, H = cfg["d_model"], cfg["n_heads"]
    n, R = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    weights = d * H * (n + R) + d * (r + R) + r * H * (n + dv) + H * dv * d
    keys = (T + 1) / 2.0
    attention = 2.0 * H * keys * ((n + R) + dv)
    if moe:
        I = cfg["moe_intermediate_size"]
        weights += (d * cfg["n_routed_experts"]
                    + 3 * d * I * (cfg["num_experts_per_tok"]
                                   + cfg["n_shared_experts"]))
    else:
        weights += 3 * d * cfg["d_ff"]
    return 2.0 * weights + attention


def forward_flops(cfg: dict, T: int) -> float:
    """One sequence's forward operations: every layer's for each of its
    ``T`` tokens, and the head once."""
    dense = cfg["first_k_dense_replace"]
    per_token = sum(layer_flops(cfg, T, moe=i >= dense)
                    for i in range(cfg["n_layers"]))
    return T * per_token + 2.0 * cfg["d_model"] * cfg["n_classes"]


def build_flops(cfg: dict, T: int, train_sequences: int,
                predict_sequences: int) -> float:
    """A build's needed operations: its training sequences at three
    forward passes each, its predicted sequences at one."""
    f = forward_flops(cfg, T)
    return 3.0 * f * train_sequences + f * predict_sequences


def build_bound_s(cfg: dict, T: int, train_sequences: int,
                  predict_sequences: int) -> float:
    """A build's needed work as seconds at the card's float32 peak."""
    return counts.bound_s(0.0, build_flops(cfg, T, train_sequences,
                                           predict_sequences))
