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
    (11_000_000, 28, 256, 2, 16, 8),    # node groups split
    (100_000, 28, 256, 3, 2048, 2048),
    (500_000, 1, 8191, 10, 1, 4),       # leaf form, columns split
    (40_000_000, 28, 32, 2, 16, 1),     # the row cap sets the chunks
])
def test_hist_plan_fits_shared_memory(n, d, nb, S, NL, slices):
    """Slices of 8-byte fixed-point slots fit a block's shared memory, and
    no row chunk exceeds the kernel's row cap."""
    NG, CG, R, rows = tk.hist_plan(n, d, nb, S, NL, n_sms=132)
    assert tk.hist_smem_bytes(NG, CG, S) <= tk.SMEM_BYTES
    assert tk.hist_smem_bytes(NG, CG, S) == NG * CG * S * 8 + 4 * S
    assert -(-NL // NG) * -(-(d * nb) // CG) == slices
    assert R * rows >= n and (R - 1) * rows < n
    assert rows <= tk.HIST_MAX_ROWS
    # int64 partials within their cap, unless the row cap needs more.
    assert (R * NL * d * nb * S * 8 <= max(tk._PARTIAL_BYTES,
                                           NL * d * nb * S * 8)
            or R == -(-n // tk.HIST_MAX_ROWS))


def test_hist_words_cannot_overflow():
    """The worst a block can add to one slot: every one of its
    HIST_MAX_ROWS rows at the largest |x|. The signed high word and the
    unsigned low word both stay inside 32 bits."""
    x_max = 1 << tk.HIST_VALUE_BITS
    hi_max = x_max >> tk.HIST_LO_BITS
    lo_max = (1 << tk.HIST_LO_BITS) - 1
    assert tk.HIST_MAX_ROWS * hi_max < 2 ** 31
    assert tk.HIST_MAX_ROWS * lo_max < 2 ** 31
    assert (-x_max) >> tk.HIST_LO_BITS == -hi_max


# ---------------------------------------------------------------------------
# The card's fixed-point histogram, modelled in numpy
# ---------------------------------------------------------------------------

def _fixed_point_histogram(codes, stats, rel, active, n_nodes, n_bins):
    """What csrc/tree_kernels.cu computes, step by step: a power-of-two
    scale per stat row from max|v|, x = rint(v·2^k), x split into a signed
    high and an unsigned low word summed in 32 bits per row chunk of the
    launch plan (checked for overflow), the chunks' exact int64 sums
    added, and one conversion to float32."""
    n, d = codes.shape
    S = stats.shape[0]
    max_abs = tk.stat_max_abs(torch.from_numpy(stats)).numpy()
    k = np.zeros(S, np.int64)
    for s in range(S):
        if max_abs[s] > 0:
            m, e = np.frexp(np.float32(max_abs[s]))
            k[s] = min(tk.HIST_VALUE_BITS - (e - 1 if m == 0.5 else e), 126)
    scale = np.ldexp(np.float32(1.0), k).astype(np.float32)
    x = np.rint(stats * scale[:, None]).astype(np.int64)          # (S, n)
    assert np.abs(x).max(initial=0) <= 2 ** tk.HIST_VALUE_BITS
    hi = x >> tk.HIST_LO_BITS
    lo = x & ((1 << tk.HIST_LO_BITS) - 1)
    key = (rel.astype(np.int64)[:, None] * d + np.arange(d)) * n_bins \
        + codes.astype(np.int64)                                 # (n, d)
    slots = n_nodes * d * n_bins
    total = np.zeros((slots, S), np.int64)
    # A small SM count gives several row chunks even at test sizes.
    _, _, R, rows = tk.hist_plan(n, d, n_bins, S, n_nodes, n_sms=4)
    for r0 in range(0, n, rows):
        a = active[r0:r0 + rows]
        kk = key[r0:r0 + rows][a].reshape(-1)
        for s in range(S):
            for word, shift in ((hi, tk.HIST_LO_BITS), (lo, 0)):
                w = np.repeat(word[s, r0:r0 + rows][a], d)
                chunk = np.bincount(kk, weights=w.astype(np.float64),
                                    minlength=slots)
                assert np.abs(chunk).max(initial=0) < 2 ** 31
                total[:, s] += chunk.astype(np.int64) << shift
    out = (total.astype(np.float64) * np.ldexp(1.0, -k)).astype(np.float32)
    return out.reshape(n_nodes, d, n_bins, S), max_abs


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("n,d,nb,NL,S", HIST_CASES[:5])
def test_fixed_point_histogram_matches_pallas(n, d, nb, NL, S, integer):
    """Integer-valued stats: bit-identical to the Pallas kernel. Float
    stats: within the kernel's stated bound of the exact (float64) sums,
    max|v|·2^-27 per row summed (half a step of
    2^(ceil(log2 max|v|) - 27)) plus one float32 rounding, and within
    the float tolerance of the other tests (rtol 1e-5, atol
    1e-6·Σ|stats|) of the Pallas kernel."""
    codes, stats, rel, active = _hist_inputs(n, d, nb, NL, S, integer,
                                             seed=7)
    ref = np.asarray(pk.tree_histogram(
        jnp.asarray(codes), jnp.asarray(stats), jnp.asarray(rel),
        jnp.asarray(active), n_nodes=NL, n_bins=nb,
        tile=pk.tree_tile(d, nb)))
    out, max_abs = _fixed_point_histogram(codes, stats, rel, active, NL, nb)
    if integer:
        np.testing.assert_array_equal(out, ref)
        return
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(stats).sum())
    key = (rel.astype(np.int64)[:, None] * d + np.arange(d)) * nb + codes
    exact = np.zeros((NL * d * nb, S))
    count = np.bincount(key[active].reshape(-1), minlength=NL * d * nb)
    for s in range(S):
        exact[:, s] = np.bincount(
            key[active].reshape(-1), minlength=NL * d * nb,
            weights=np.repeat(stats[s][active].astype(np.float64), d))
    bound = (count[:, None] * max_abs[None, :] * 2.0 ** -27
             + np.abs(exact) * 2.0 ** -24)
    assert (np.abs(out.reshape(-1, S) - exact) <= bound).all()


def test_fixed_point_histogram_zero_and_one_hot_stats():
    """A stat row of zeros scales by 2^0 and sums to 0; a one-hot class
    stat (dt's) sums to exact counts, as the plain version's."""
    n, d, nb, NL = 5000, 6, 32, 4
    codes, _, rel, active = _hist_inputs(n, d, nb, NL, 2, True, seed=8)
    y = np.random.default_rng(9).integers(0, 2, n)
    stats = np.stack([(y == 0), (y == 1), np.zeros(n)]).astype(np.float32)
    out, _ = _fixed_point_histogram(codes, stats, rel, active, NL, nb)
    ref = tk.tree_histogram(*map(torch.from_numpy, (codes, stats, rel,
                                                     active)),
                            n_nodes=NL, n_bins=nb).numpy()
    np.testing.assert_array_equal(out, ref)
    assert not out[..., 2].any()


def test_stat_max_abs():
    stats = torch.tensor([[1.0, -3.0, 2.0], [0.0, 0.0, 0.0]])
    assert torch.equal(tk.stat_max_abs(stats), torch.tensor([3.0, 0.0]))
    assert torch.equal(tk.stat_max_abs(torch.zeros((2, 0))),
                       torch.zeros(2))
    # Passing it in changes nothing on the CPU, where the plain version
    # runs.
    codes, st, rel, active = _hist_inputs(300, 4, 8, 2, 2, False)
    args = [torch.from_numpy(a) for a in (codes, st, rel, active)]
    a = tk.tree_histogram(*args, n_nodes=2, n_bins=8)
    b = tk.tree_histogram(*args, n_nodes=2, n_bins=8,
                          max_abs=tk.stat_max_abs(args[1]))
    assert torch.equal(a, b)
