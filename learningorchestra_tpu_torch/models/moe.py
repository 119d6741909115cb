"""The expert layer of the ``tx`` family's ``mla_moe`` block: DeepSeek-V3's
sigmoid-routed experts with shared experts and auxiliary-loss-free
balancing (``topk_method: noaux_tc``).

For a token's normed hidden state ``x`` (width d):

- ``s = sigmoid(x W_r)``: one score an expert (``n_routed_experts``);
- the token's experts are the top ``num_experts_per_tok`` of ``s + b``,
  where ``b`` is the per-expert correction bias — it steers selection
  only, and no gradient reaches it;
- the gates are the chosen scores normalised to sum to one and scaled by
  ``routed_scaling_factor``;
- the output is ``shared(x) + Σ_chosen g_i E_i(x)``, each expert (and the
  shared experts, one SwiGLU of ``n_shared_experts`` times the width) a
  SwiGLU ``(silu(x W1) * (x W3)) W2``.

Routing keeps every token: each goes to exactly ``num_experts_per_tok``
distinct experts, with no capacity limit, so nothing is dropped. The
(token, expert) pairs are sorted by expert (a stable sort), each expert
multiplies the rows it received, and the results are put back in pair
order and summed over a token's experts — a fixed order, so the layer
gives the same bits run after run. The experts' row counts are read on
the host once a layer (they size the per-expert products): the host
waits there for the router, so the device idles until the host has
launched the experts' products. A pair no expert took would add nothing
to its token; the counter ``tokens_dropped`` counts the tokens short of
an expert from the rows the experts did take, and reads 0 while the
row counts are the router's own (no capacity limit).

Balancing, as DeepSeek-V3 trains (its technical report, §2.1.2):

- after each step ``b_i += γ · sign(mean load − load_i)``, the loads
  summed over the data and seq axes first, so every rank holds the same
  bias (``update_bias``);
- the sequence-wise balance loss ``α Σ_i f_i P_i`` a sequence, with
  ``f_i = E / (K T) · #(tokens choosing i)`` and ``P_i`` the mean over
  the sequence's tokens of ``s_i / Σ_j s_j``; the loss adds its mean
  over the batch's sequences, for every expert layer.

An expert share (``experts_held``, ``expert_share``; Kimi Linear's cell):
the layer holds experts ``[share·held, (share + 1)·held)`` of the
router's ``n_routed_experts``, as one of the ranks of an expert-parallel
deployment does. The router, its correction bias, the top-k and the
gates stay over all experts; only the pairs whose expert is held are
gathered and computed, and the shared experts are added as before. The
loads, the balance loss and the bias update stay over all experts. A
pair sent to an expert held elsewhere is no drop: the counters
``pairs_held`` and ``pairs_elsewhere`` count the pairs each way. With
every expert held (``experts_held`` 0, the default) the layer is the
whole layer.

On the model axis the router is replicated and every expert's (and the
shared experts') intermediate width is split: the token rows and gates
enter the split region through ``pvary`` and the partial outputs leave
it through ``psum``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from learningorchestra_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, ProcessMesh, all_reduce_, psum, pvary)

#: Leaves of an expert layer, in their fixed order. ``e_bias`` is the
#: correction bias (no gradient); the shared experts' three leaves exist
#: when ``n_shared_experts`` > 0.
ROUTER_LEAVES = ("router", "e_bias")
EXPERT_LEAVES = ("experts_w1", "experts_w3", "experts_w2")
SHARED_LEAVES = ("shared_w1", "shared_w3", "shared_w2")

#: The balance loss's α and the bias step γ, DeepSeek-V3's technical
#: report's (its config carries neither).
BALANCE_ALPHA = 1e-4
BIAS_STEP = 1e-3

_lock = threading.Lock()
_counts = {"tokens_routed": 0, "tokens_dropped": 0, "bias_updates": 0,
           "pairs_held": 0, "pairs_elsewhere": 0}
#: Each expert layer's (busiest expert's rows, mean rows) at its last
#: forward, by layer index.
_loads: Dict[int, tuple] = {}
#: An observer of the routing, ``fn(layer, expert_ids)`` with the
#: (tokens, k) chosen experts of each forward; None leaves it uncalled.
_route_observer: Optional[Callable] = None


def counts() -> dict:
    """Tokens routed (each token once a layer), tokens dropped (a token
    with a pair no expert took, ``dispatch``'s count), bias updates, the
    (token, expert) pairs whose expert this layer holds and those held
    elsewhere (an expert share's), and each layer's last loads as
    ``{layer: (busiest, mean)}``."""
    with _lock:
        return dict(_counts, loads=dict(_loads))


def reset_counts() -> None:
    with _lock:
        for k in _counts:
            _counts[k] = 0
        _loads.clear()


def set_route_observer(fn: Optional[Callable]) -> None:
    global _route_observer
    _route_observer = fn


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, k: int,
          scaling: float):
    """(scores (N, E), chosen experts (N, k), gates (N, k)) for rows ``x``
    (N, d)."""
    s = torch.sigmoid(x @ router)
    idx = torch.topk(s.detach() + bias, k, dim=-1).indices
    g = s.gather(1, idx)
    g = g / (g.sum(dim=-1, keepdim=True) + 1e-20) * scaling
    return s, idx, g


def dispatch(x: torch.Tensor, idx: torch.Tensor, g: torch.Tensor,
             loads: List[int], w1: torch.Tensor, w3: torch.Tensor,
             w2: torch.Tensor, first: int = 0):
    """(``Σ_j g[t, j] E_{idx[t, j]}(x[t])`` over the held experts for every
    row t, the rows short of an expert): the (row, expert) pairs sorted
    by expert, each held expert's rows through its SwiGLU, the results
    back in pair order and summed over a row's k. ``loads`` are every
    expert's pair counts (host integers); ``w1``/``w3``/``w2`` stack the
    held experts ``first``, ``first + 1``, …, whose pairs lie between
    the counts of the experts before and after them. Holding every
    expert, a pair past the rows the counts give adds nothing, and its
    row is counted (read back only then)."""
    N, k = idx.shape
    held = w1.shape[0]
    order = torch.argsort(idx.reshape(-1), stable=True)
    pairs = order[sum(loads[:first]):N * k - sum(loads[first + held:])]
    # Each row repeated k times, then permuted: both backward passes are
    # a sum over k and a permutation, with no colliding adds.
    xs = x[:, None, :].expand(N, k, x.shape[1]).reshape(N * k, -1)[pairs]
    gs = g.reshape(-1)[pairs]
    w1s, w3s, w2s = w1.unbind(0), w3.unbind(0), w2.unbind(0)
    outs, start = [], 0
    for e, c in enumerate(loads[first:first + held]):
        if c:
            outs.append(swiglu(xs[start:start + c], w1s[e], w3s[e], w2s[e]))
            start += c
    out = x.new_zeros((N * k, w2.shape[-1]))
    if outs:
        out.index_copy_(0, pairs[:start], torch.cat(outs) * gs[:start, None])
    short = (0 if start == pairs.numel()
             else int(torch.unique(pairs[start:] // k).numel()))
    return out.view(N, k, -1).sum(dim=1), short


def balance_loss_terms(s: torch.Tensor, idx: torch.Tensor, B: int,
                       mesh: ProcessMesh):
    """This rank's sum over its sequences of ``Σ_i f_i P_i`` (the
    sequence-wise balance loss before α), each sequence's f and P summed
    over the seq axis first. ``s`` (B·T_local, E), ``idx`` (B·T_local,
    k)."""
    E, k = s.shape[1], idx.shape[1]
    Tl = s.shape[0] // B
    T = Tl * mesh.size(SEQ_AXIS)
    p = (s / s.sum(dim=-1, keepdim=True)).view(B, Tl, E).sum(dim=1)
    P = psum(p, mesh, SEQ_AXIS) / T
    hits = torch.zeros((B, E), dtype=s.dtype, device=s.device)
    hits.scatter_add_(1, idx.view(B, Tl * k),
                      torch.ones((B, Tl * k), dtype=s.dtype,
                                 device=s.device))
    f = psum(hits, mesh, SEQ_AXIS) * (E / (k * T))
    return (f * P).sum()


def moe_layer(h: torch.Tensor, lyr: Dict[str, torch.Tensor], *, cfg,
              mesh: ProcessMesh, layer: int, balance: bool = False):
    """The expert layer on this rank's (B, T_local, d) normed rows ``h``
    (replicated over the model axis). Returns (output, whole over the
    model axis; this rank's balance-loss sum, or None without
    ``balance``; the local expert loads (E,)). A forward that a
    checkpointed backward pass recomputes adds nothing to the counters."""
    B, Tl, d = h.shape
    x = h.reshape(-1, d)
    k = cfg.num_experts_per_tok
    s, idx, g = route(x, lyr["router"], lyr["e_bias"], k,
                      cfg.routed_scaling_factor)
    load = torch.bincount(idx.reshape(-1), minlength=s.shape[1])
    loads = load.tolist()
    held = lyr["experts_w1"].shape[0]
    first = cfg.expert_share * held
    xv = pvary(x, mesh, MODEL_AXIS)
    out, short = dispatch(xv, idx, pvary(g, mesh, MODEL_AXIS), loads,
                          lyr["experts_w1"], lyr["experts_w3"],
                          lyr["experts_w2"], first=first)
    if torch._C._current_graph_task_id() == -1:
        pairs = sum(loads[first:first + held])
        with _lock:
            _counts["tokens_routed"] += x.shape[0]
            _counts["tokens_dropped"] += short
            _counts["pairs_held"] += pairs
            _counts["pairs_elsewhere"] += x.shape[0] * k - pairs
            _loads[layer] = (max(loads), sum(loads) / len(loads))
        if _route_observer is not None:
            _route_observer(layer, idx.detach())
    if cfg.n_shared_experts:
        out = out + swiglu(xv, lyr["shared_w1"], lyr["shared_w3"],
                           lyr["shared_w2"])
    bal = balance_loss_terms(s, idx, B, mesh) if balance else None
    return psum(out, mesh, MODEL_AXIS).view(B, Tl, d), bal, load


def update_bias(params: Dict[str, torch.Tensor], moe_layers: List[int],
                loads: List[torch.Tensor], mesh: ProcessMesh) -> None:
    """``b_i += γ · sign(mean − load_i)`` in each expert layer, the loads
    of the step summed over the data and seq axes (every rank ends with
    the same bias)."""
    with torch.no_grad():
        for i, load in zip(moe_layers, loads):
            c = load.to(torch.float32).contiguous()
            all_reduce_(c, mesh, DATA_AXIS)
            all_reduce_(c, mesh, SEQ_AXIS)
            key = f"layers.{i}.e_bias"
            params[key] = params[key] + BIAS_STEP * torch.sign(c.mean() - c)
    with _lock:
        _counts["bias_updates"] += len(loads)
