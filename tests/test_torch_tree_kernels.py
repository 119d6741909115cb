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


# ---------------------------------------------------------------------------
# K2 and K3: packed node words, the feature-major codes, the descent plan
# ---------------------------------------------------------------------------

def _pack(feat, thr, go, d):
    """pack_node of csrc/tree_kernels.cu: a node that does not split
    stays (feature 0, tt 256, bit 31); a split goes right iff code >= tt,
    tt = thr + 1 clamped to [0, 256]; a feature outside [0, d) compares
    code 0, so its side is fixed by the sign of thr."""
    f, t = np.asarray(feat, np.int64), np.asarray(thr, np.int64)
    inside = (f >= 0) & (f < d)
    tt = np.where(inside, np.clip(t + 1, 0, 256), np.where(t < 0, 0, 256))
    word = np.where(inside, f, 0) << tk.NODE_TT_BITS | tt
    return np.where(np.asarray(go, bool), word, (1 << 31) | 256)


def _unpack(words):
    """The kernels' decode of packed node words: (stays, feature, tt)."""
    w = np.asarray(words, np.int64)
    return (w >> 31).astype(bool), (w >> tk.NODE_TT_BITS) & (
        (1 << 22) - 1), w & ((1 << tk.NODE_TT_BITS) - 1)


def _route_packed(codes_T, rel, active, assign, words):
    """What route_kernel computes, row by row, from the feature-major
    codes and the packed level table."""
    NL = len(words)
    stay, f, tt = _unpack(words)
    out = assign.copy()
    for i in range(len(assign)):
        r = rel[i]
        if active[i] and 0 <= r < NL and not stay[r]:
            out[i] = 2 * assign[i] + 1 + int(codes_T[f[r], i] >= tt[r])
    return out


def _steps(feat, thr, go, d):
    """pack_step of csrc/tree_kernels.cu, node a of each (T, W) table:
    {f, key}, so that a level of a walk is a' = (key + code[f]) >> 8. A
    split's key is ((2a + 1) << 8) + 256 - tt; a node that keeps its rows
    has f = 0 and key = a << 8."""
    f, t = np.asarray(feat, np.int64), np.asarray(thr, np.int64)
    go = np.asarray(go, bool)
    a = np.arange(f.shape[-1])
    inside = (f >= 0) & (f < d)
    tt = np.where(inside, np.clip(t + 1, 0, 256), np.where(t < 0, 0, 256))
    key = np.where(go, ((2 * a + 1) << 8) + 256 - tt, a << 8)
    return np.where(go & inside, f, 0), key


def _descend_steps(codes, depth, f, key):
    """What the descent kernels compute: every row's walk of ``depth``
    levels over (T, W) step tables."""
    rows = np.arange(len(codes))
    out = np.zeros((len(f), len(codes)), np.int64)
    for t in range(len(f)):
        a = out[t]
        for _ in range(depth):
            a[:] = (key[t, a] + codes[rows, f[t, a]]) >> 8
    return out.astype(np.int32)


def _descend_words(codes, depth, words):
    """The direct path's walk over (T, W) node words: a node that stays
    ends the walk."""
    stay, f, tt = _unpack(words)
    rows = np.arange(len(codes))
    out = np.zeros((len(words), len(codes)), np.int64)
    for t in range(len(words)):
        a = out[t]
        for _ in range(depth):
            child = 2 * a + 1 + (codes[rows, f[t, a]] >= tt[t, a])
            a[:] = np.where(stay[t, a], a, child)
    return out.astype(np.int32)


def _route_inputs(n, d, nb, NL, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, nb, (n, d)).astype(np.uint8)
    active = rng.random(n) < 0.7
    rel = np.where(active, rng.integers(0, NL, n), 0).astype(np.int32)
    assign = (rel + NL - 1).astype(np.int32)
    best_f = rng.integers(0, d, NL).astype(np.int32)
    # Thresholds past what a uint8 code can meet.
    best_t = rng.choice([-5, -1, 0, 3, nb - 2, 254, 255, 300],
                        NL).astype(np.int32)
    split = rng.random(NL) < 0.6
    return codes, rel, active, assign, best_f, best_t, split


@pytest.mark.parametrize("n,d,nb,NL", [(1001, 6, 256, 16), (3000, 28, 32, 4),
                                       (517, 28, 256, 64)])
def test_route_level_with_codes_T_matches_pallas(n, d, nb, NL):
    """Given the feature-major codes, the wrapper and the kernel's packed
    arithmetic both match the Pallas kernel bit for bit, thresholds past
    the codes' range included; the packed arithmetic also where a feature
    lies outside the row (the Pallas kernel compares code 0 there; the
    plain version takes only features inside it)."""
    args = _route_inputs(n, d, nb, NL, seed=10)
    codes, rel, active, assign, best_f, best_t, split = args
    ref = np.asarray(pk.tree_route_level(*map(jnp.asarray, args),
                                         tile=pk.TREE_ROUTE_TILE))
    t_args = [torch.from_numpy(a) for a in args]
    codes_T = tk.feature_major(t_args[0])
    assert codes_T.shape == (d, n) and codes_T.is_contiguous()
    out = tk.tree_route_level(*t_args, codes_T=codes_T).numpy()
    np.testing.assert_array_equal(out, ref)
    wild_f = best_f.copy()
    wild_f[::3] = np.resize([-2, -1, d, d + 1], len(wild_f[::3]))
    ref = np.asarray(pk.tree_route_level(
        *map(jnp.asarray, (codes, rel, active, assign, wild_f, best_t,
                           split)), tile=pk.TREE_ROUTE_TILE))
    words = _pack(wild_f, best_t, split, d)
    np.testing.assert_array_equal(
        _route_packed(codes_T.numpy(), rel, active, assign, words), ref)


def test_route_codes_T_changes_nothing_on_cpu():
    args = [torch.from_numpy(a) for a in _route_inputs(700, 6, 32, 8, 11)]
    a = tk.tree_route_level(*args)
    b = tk.tree_route_level(*args, codes_T=tk.feature_major(args[0]))
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_route_refuses_bad_codes_T(bad):
    args = [torch.from_numpy(a) for a in _route_inputs(64, 6, 32, 4, 12)]
    codes_T = tk.feature_major(args[0])
    codes_T = {"shape": codes_T[:, :-1],
               "dtype": codes_T.int(),
               "device": codes_T.to("meta")}[bad]
    with pytest.raises(ValueError):
        tk.tree_route_level(*args, codes_T=codes_T)


@pytest.mark.parametrize("short", [4, 5, 6])
def test_route_refuses_unequal_tables(short):
    """best_f, best_t and split are one level's tables: one of another
    length is refused, not read past its end on the card."""
    args = [torch.from_numpy(a) for a in _route_inputs(64, 6, 32, 4, 12)]
    args[short] = args[short][:-1]
    with pytest.raises(ValueError):
        tk.tree_route_level(*args)


@pytest.mark.parametrize("n,d,nb,depth,M,T", [
    (1001, 6, 256, 5, 63, 3),      # ragged n, the widest bins
    (300, 28, 32, 12, 8191, 2),    # depth 12: 4,095 words a table
    (400, 28, 32, 8, 63, 2),       # max_depth past the table's levels
    (257, 5, 16, 4, 20, 2),        # M not a full tree: ids >= M stay
    (300, 3, 8, 0, 7, 1),          # no level walked
])
def test_descend_packed_tables_match_pallas(n, d, nb, depth, M, T):
    """The tables over the levels ``descend_depth`` keeps, walked as the
    staged (step entries) and direct (node words) kernels walk them,
    match the Pallas kernel bit for bit, also
    with features outside the row (code 0, as in the Pallas kernel) and
    walks that reach ids past M (they stay there). The wrapper matches it
    on what the plain version takes: features inside the row, walks that
    stay below M."""
    rng = np.random.default_rng(13)
    codes = rng.integers(0, nb, (n, d)).astype(np.uint8)
    feat = rng.integers(0, d, (T, M)).astype(np.int32)
    thr = rng.integers(-2, nb + 2, (T, M)).astype(np.int32)
    internal = rng.random((T, M)) < 0.85
    wild = np.where(rng.random((T, M)) < 0.2,
                    rng.choice([-1, d, d + 5], (T, M)), feat).astype(np.int32)
    plain = M >= 2 ** (depth + 1) - 1
    if plain:
        out = tk.tree_descend(*map(torch.from_numpy, (codes, feat, thr,
                                                       internal)),
                              max_depth=depth).numpy()
    for f_tab in (feat, wild):
        # The kernels' tables: the walk's levels, nodes past M stay.
        levels = tk.descend_depth(M, depth)
        assert levels == min(depth, M.bit_length())
        W = tk.table_words(levels)
        pad = max(W - M, 0)
        tables = [np.pad(a[:, :W], ((0, 0), (0, pad)))
                  for a in (f_tab, thr, internal)]
        model = _descend_steps(codes, levels, *_steps(*tables, d))
        np.testing.assert_array_equal(
            _descend_words(codes, levels, _pack(*tables, d)), model)
        for t in range(T):
            ref = np.asarray(pk.tree_descend(
                *map(jnp.asarray, (codes, f_tab[t], thr[t], internal[t])),
                max_depth=depth))
            np.testing.assert_array_equal(model[t], ref)
            if plain and f_tab is feat:
                np.testing.assert_array_equal(out[t], ref)


def test_pack_nodes_round_trip_at_the_limits():
    d = tk.NODE_MAX_D
    i32 = np.iinfo(np.int32)
    feat = np.array([0, d - 1, d - 1, 5, -1, d, 7, 7], np.int32)
    thr = np.array([i32.min, -1, 255, 254, -1, 3, i32.max, 0], np.int32)
    go = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    stay, f, tt = _unpack(_pack(feat, thr, go, d))
    sf, key = _steps(feat[None], thr[None], go[None], d)
    np.testing.assert_array_equal(stay, [0, 0, 0, 0, 0, 0, 0, 1])
    # Features outside the row compare code 0: the side is fixed.
    np.testing.assert_array_equal(f, [0, d - 1, d - 1, 5, 0, 0, 7, 0])
    np.testing.assert_array_equal(tt, [0, 0, 256, 255, 0, 256, 256, 256])
    # Every uint8 code goes to the same side as code > thr says.
    for code in (0, 1, 254, 255):
        for k in range(7):
            inside = 0 <= int(feat[k]) < d
            v = code if inside else 0
            assert (v >= tt[k]) == (v > int(thr[k]))
            # K3's step from node k: its child, or k itself if it stays.
            child = 2 * k + 1 + int(v > int(thr[k])) if go[k] else k
            assert (key[0, k] + code * (sf[0, k] == f[k])) >> 8 == child
    tk.check_node_features(d)
    with pytest.raises(ValueError):
        tk.check_node_features(d + 1)


@pytest.mark.parametrize("T", [1, 20, 60])
@pytest.mark.parametrize("depth", [1, 5, 12])
@pytest.mark.parametrize("d", [6, 28, 784, 5000])
def test_descend_plan_fits_shared_memory(d, depth, T):
    """The tiles and a chunk of tables fit a block's shared memory; the
    chunks cover every tree; staged iff d <= SECTOR_BYTES * depth (as
    csrc/tree_kernels.cu says), with tiles of whole thread rows."""
    n = 11_000_000
    plan = tk.descend_plan(n, d, depth, T, n_sms=132)
    tb = tk.STEP_BYTES * tk.table_words(depth)
    assert plan.smem_bytes <= tk.SMEM_BYTES
    assert plan.smem_bytes == 2 * plan.tile_bytes + plan.trees_per_chunk * tb
    assert plan.chunks == -(-T // plan.trees_per_chunk)
    assert (plan.chunks - 1) * plan.trees_per_chunk < T
    assert plan.staged == (d <= tk.SECTOR_BYTES * depth)
    if plan.staged:
        assert plan.rows_per_tile // tk.DESCEND_THREADS in (1, 2, 4)
        assert plan.rows_per_tile % tk.DESCEND_THREADS == 0
        assert plan.tile_bytes == tk.descend_tile_bytes(plan.rows_per_tile,
                                                        d)
    else:
        assert plan.rows_per_tile == plan.tile_bytes == 0
    assert 1 <= plan.blocks <= -(-n // (plan.rows_per_tile
                                        or tk.DESCEND_THREADS))


@pytest.mark.parametrize("d,depth,T,rows_per_thread,chunks", [
    (28, 5, 20, 4, 1),      # the HIGGS sweep
    (128, 5, 3, 2, 1),      # two rows a thread
    (300, 12, 5, 1, 2),     # one row a thread, tables in two chunks
])
def test_descend_plan_rows_per_thread(d, depth, T, rows_per_thread, chunks):
    """Each staged instantiation of the kernel (kRows = 4, 2, 1) is
    reached at the shapes chip_smoke.py checks it on."""
    plan = tk.descend_plan(100_003, d, depth, T, n_sms=132)
    assert plan.staged
    assert plan.rows_per_tile // tk.DESCEND_THREADS == rows_per_thread
    assert plan.chunks == chunks


@pytest.mark.parametrize("depth", [1, 5, 12])
def test_descend_plan_flips_at_a_sector_a_level(depth):
    at = tk.SECTOR_BYTES * depth
    assert tk.descend_plan(1000, at, depth, 20, n_sms=132).staged
    assert not tk.descend_plan(1000, at + 1, depth, 20, n_sms=132).staged


def test_descend_plan_refuses_walks_past_the_deepest():
    """The deepest walk's table fits beside the ring; one level more is
    refused, not walked wrong (a staged entry's key holds ids < 2^15)."""
    depth = tk.MAX_DESCEND_DEPTH
    plan = tk.descend_plan(1000, 28, depth, 1, n_sms=132)
    assert plan.smem_bytes <= tk.SMEM_BYTES
    # The largest key (a split at the last entry) plus a code.
    assert ((2 * tk.table_words(depth) - 1) << 8) + 256 + 255 < 1 << 23
    with pytest.raises(ValueError):
        tk.descend_plan(1000, 28, depth + 1, 1, n_sms=132)


@pytest.mark.parametrize("rows,d", [(256, 28), (512, 28), (2048, 6),
                                    (256, 160), (1, 1), (7, 3)])
def test_descend_tile_holds_its_chunks_at_any_alignment(rows, d):
    """The 16-B chunks covering a tile's rows · d bytes, starting at any
    offset within a chunk, fit its buffer (stage_rows in the source)."""
    for start in range(16):
        g0 = start // 16 * 16
        g1 = -(-(start + rows * d) // 16) * 16
        assert g1 - g0 <= tk.descend_tile_bytes(rows, d)
    assert tk.descend_tile_bytes(rows, d) % 16 == 0
