"""t-SNE's edge table on the device that holds the kNN.

The tests marked ``card`` need a CUDA card and skip without one; whether
there is one is decided inside the ``card`` fixture. This file imports
no JAX, so that it runs on the card's machine, which has none:

    python -m pytest --noconftest -q tests/test_torch_tsne_card.py

(``--noconftest``: ``tests/conftest.py`` imports JAX). On the card the
table is held bit for bit against the same function on the CPU, whose
table the CPU tests hold against the JAX package's host table.
"""

import numpy as np
import pytest
import torch

from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import tracing
from learningorchestra_tpu_torch.viz import tsne


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)


def _knn_like(n_valid, n_pad, k, seed):
    """kNN indices and P at the image service's shape: every row's first
    neighbour one of five hubs (each drawing about 12,000 in-edges, far
    past the 2k cap), and a few neighbours in the padding rows."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_valid, (n_valid, k))
    idx[:, 0] = rng.integers(0, 5, n_valid)
    idx[::997, 3] = n_valid + rng.integers(0, n_pad - n_valid, 61)
    P = rng.random((n_valid, k)).astype(np.float32)
    P /= P.sum(1, keepdims=True)
    return torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(P)


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.card
def test_card_table_equals_cpu_table(card):
    """At 60,416 rows × 90 neighbours with hubs, the table built on the
    card equals the one built on the CPU from the same tensors in all
    five tensors, the weights bit for bit, and two builds on the card
    are equal."""
    n_valid, n_pad, k = 60_000, 60_416, 90
    idx, P = _knn_like(n_valid, n_pad, k, seed=11)
    host = tsne._edge_table(idx, P, n_pad, n_valid)
    assert host[2].shape[0] > 0 and host[0].shape[1] == 3 * k
    builds = [tsne._edge_table(idx.to(card), P.to(card), n_pad, n_valid)
              for _ in range(2)]
    for built in builds:
        for i, (a, b) in enumerate(zip(built, host)):
            assert a.device.type == "cuda" and a.dtype == b.dtype, i
            assert torch.equal(_bits(a), _bits(b)), i


@pytest.mark.parametrize("on_card", [
    pytest.param(False, id="cpu"),
    pytest.param(True, id="cuda", marks=pytest.mark.card),
])
def test_edge_table_span_attributes(on_card, request):
    """``viz.edge_table`` carries the edges kept, the incoming columns,
    the overflow edges and the type of the device that built the
    table."""
    dev = request.getfixturevalue("card") if on_card else "cpu"
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal(size=(300, 8)),
                        rng.normal(size=(200, 8)) * 0.2]).astype(np.float32)
    runtime = DeviceRuntime(Settings(), device=str(dev))
    with tracing.trace("test.tsne", sampled=True) as ctx:
        tsne.tsne_embed(runtime, X, perplexity=5.0, iters=4,
                        exaggeration_iters=2)
    spans = {sp["name"]: sp.get("attrs") for sp in tracing.spans_for(
        ctx.trace_id)}
    attrs = spans["viz.edge_table"]
    k = 15
    assert attrs["device"] == torch.device(dev).type
    assert attrs["edges"] == len(X) * k
    assert 0 < attrs["in_cols"] <= 2 * k
    assert attrs["overflow_edges"] == spans["viz.descent"]["overflow_edges"]
    assert all(type(attrs[key]) is int
               for key in ("edges", "in_cols", "overflow_edges"))
