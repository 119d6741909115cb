"""The PyTorch package's tree kernels against the JAX package's Pallas ones.

On the CPU each wrapper of ``learningorchestra_tpu_torch.ops.tree_kernels``
runs its plain PyTorch version; the JAX side runs the Pallas kernels in
interpret mode. Inputs come from numpy with a seed and go to both.
Routing, descent and integer-valued histograms must be bit-identical;
float histograms agree to rtol 1e-5 with atol 1e-6·Σ|stats|, because the
two sum in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from learningorchestra_tpu.ops import pallas_kernels as pk
from learningorchestra_tpu_torch.ops import tree_kernels as tk

# (n, d, n_bins, NL, S): n off the kernel tiles, every listed d, n_bins,
# node width and stat count appears.
HIST_CASES = [
    (1000, 6, 8, 1, 2),
    (3000, 28, 32, 16, 2),
    (1000, 28, 256, 4, 3),
    (3000, 6, 256, 16, 2),
    (1000, 6, 32, 4, 3),
    (3000, 28, 8, 1, 3),
    (3000, 28, 256, 16, 3),
    (1000, 28, 32, 16, 2),
]


def _hist_inputs(n, d, nb, NL, S, integer, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, nb, (n, d)).astype(np.uint8)
    active = rng.random(n) < 0.8
    rel = np.where(active, rng.integers(0, NL, n), 0).astype(np.int32)
    stats = (rng.poisson(1.5, (S, n)) if integer
             else rng.normal(size=(S, n))).astype(np.float32)
    return codes, stats, rel, active


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("n,d,nb,NL,S", HIST_CASES)
def test_histogram_matches_pallas(n, d, nb, NL, S, integer):
    codes, stats, rel, active = _hist_inputs(n, d, nb, NL, S, integer)
    ref = np.asarray(pk.tree_histogram(
        jnp.asarray(codes), jnp.asarray(stats), jnp.asarray(rel),
        jnp.asarray(active), n_nodes=NL, n_bins=nb,
        tile=pk.tree_tile(d, nb)))
    out = tk.tree_histogram(
        torch.from_numpy(codes), torch.from_numpy(stats),
        torch.from_numpy(rel), torch.from_numpy(active),
        n_nodes=NL, n_bins=nb).numpy()
    assert out.shape == (NL, d, nb, S)
    if integer:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(stats).sum())


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("n,M,S", [(1000, 63, 2), (3000, 127, 3),
                                   (3000, 7, 2)])
def test_leaf_stats_match_pallas(n, M, S, integer):
    rng = np.random.default_rng(1)
    assign = rng.integers(0, M, n).astype(np.int32)
    stats = (rng.poisson(2.0, (S, n)) if integer
             else rng.normal(size=(S, n))).astype(np.float32)
    ref = np.asarray(pk.tree_leaf_stats(
        jnp.asarray(assign), jnp.asarray(stats), n_nodes=M,
        tile=pk.tree_tile(1, M)))
    out = tk.tree_leaf_stats(torch.from_numpy(assign),
                             torch.from_numpy(stats), n_nodes=M).numpy()
    assert out.shape == (S, M)
    if integer:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(stats).sum())


@pytest.mark.parametrize("n,d,nb,NL", [(1000, 6, 8, 1), (3000, 28, 32, 4),
                                       (3000, 28, 256, 16)])
def test_route_level_matches_pallas(n, d, nb, NL):
    rng = np.random.default_rng(2)
    codes = rng.integers(0, nb, (n, d)).astype(np.uint8)
    active = rng.random(n) < 0.7
    rel = np.where(active, rng.integers(0, NL, n), 0).astype(np.int32)
    assign = (rel + NL - 1).astype(np.int32)
    best_f = rng.integers(0, d, NL).astype(np.int32)
    best_t = rng.integers(0, nb, NL).astype(np.int32)
    split = rng.random(NL) < 0.6
    ref = np.asarray(pk.tree_route_level(
        *map(jnp.asarray, (codes, rel, active, assign, best_f, best_t,
                           split)), tile=pk.TREE_ROUTE_TILE))
    out = tk.tree_route_level(*map(torch.from_numpy, (
        codes, rel, active, assign, best_f, best_t, split))).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n,d,depth", [(1000, 6, 1), (3000, 28, 5),
                                       (1000, 28, 3)])
def test_descend_matches_pallas(n, d, depth):
    rng = np.random.default_rng(3)
    M = 2 ** (depth + 1) - 1
    T = 3
    codes = rng.integers(0, 32, (n, d)).astype(np.uint8)
    feat = rng.integers(0, d, (T, M)).astype(np.int32)
    thr = rng.integers(0, 32, (T, M)).astype(np.int32)
    internal = rng.random((T, M)) < 0.8
    batched = tk.tree_descend(*map(torch.from_numpy, (
        codes, feat, thr, internal)), max_depth=depth).numpy()
    assert batched.shape == (T, n)
    for t in range(T):
        ref = np.asarray(pk.tree_descend(
            *map(jnp.asarray, (codes, feat[t], thr[t], internal[t])),
            max_depth=depth))
        one = tk.tree_descend(*map(torch.from_numpy, (
            codes, feat[t], thr[t], internal[t])), max_depth=depth).numpy()
        np.testing.assert_array_equal(one, ref)
        np.testing.assert_array_equal(batched[t], ref)


def test_wrappers_refuse_other_devices():
    """No silent fallback: only CPU tensors take the plain version; a
    device the kernels do not run on is refused, not moved."""
    codes = torch.zeros((4, 2), dtype=torch.uint8, device="meta")
    rel = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tk.tree_route_level(codes, rel, rel.bool(), rel, rel[:1], rel[:1],
                            rel[:1].bool())
    with pytest.raises(ValueError):
        tk.tree_descend(codes, torch.zeros(3, dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int32),
                        torch.zeros(3, dtype=torch.bool), max_depth=1)


@pytest.mark.parametrize("n,d,nb,S,NL,slices", [
    (11_000_000, 28, 32, 2, 16, 1),     # the HIGGS sweep: one slice
    (11_000_000, 28, 256, 2, 16, 4),    # node groups split
    (100_000, 28, 256, 3, 2048, 1024),
    (500_000, 1, 8191, 10, 1, 2),       # leaf form, columns split
])
def test_hist_plan_fits_shared_memory(n, d, nb, S, NL, slices):
    NG, CG, R, rows = tk.hist_plan(n, d, nb, S, NL, n_sms=132)
    assert NG * CG * S * 4 <= tk.SMEM_BYTES
    assert -(-NL // NG) * -(-(d * nb) // CG) == slices
    assert R * rows >= n and (R - 1) * rows < n
    assert R * NL * d * nb * S * 4 <= max(tk._PARTIAL_BYTES,
                                          NL * d * nb * S * 4)
