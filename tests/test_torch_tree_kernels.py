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


# ---------------------------------------------------------------------------
# K1's live nodes and persistent blocks, K3's grouping by bin matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("n_live", [1, 2, 16, 32])
def test_histogram_live_nodes_match_pallas(n_live, integer):
    """A depth-6 level (NL = 32 node slots) whose rows lie in the first
    n_live nodes: the histogram over the live nodes alone is the Pallas
    kernel's over all 32, the other nodes 0; the slice and fixed forms
    agree."""
    NL, n, d, nb, S = 32, 2000, 6, 16, 2
    codes, stats, _, active = _hist_inputs(n, d, nb, NL, S, integer,
                                           seed=11)
    rng = np.random.default_rng(12)
    rel = np.where(active, rng.integers(0, n_live, n), 0).astype(np.int32)
    ref = np.asarray(pk.tree_histogram(
        jnp.asarray(codes), jnp.asarray(stats), jnp.asarray(rel),
        jnp.asarray(active), n_nodes=NL, n_bins=nb,
        tile=pk.tree_tile(d, nb)))
    args = [torch.from_numpy(a) for a in (codes, stats, rel, active)]
    out = tk.tree_histogram(*args, n_nodes=NL, n_bins=nb,
                            n_live=n_live).numpy()
    assert out.shape == (NL, d, nb, S)
    assert not out[n_live:].any()
    if integer:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(stats).sum())
    stack = [a[None] for a in args]
    sl = tk.tree_histogram_slices(stack[0], (0,), *stack[1:], n_nodes=NL,
                                  n_bins=nb, n_live=n_live)
    assert torch.equal(sl[0], torch.from_numpy(out))
    max_abs = tk.stat_max_abs(stack[1])
    fixed = tk.tree_histogram_fixed(stack[0], (0,), *stack[1:], n_nodes=NL,
                                    n_bins=nb, max_abs=max_abs,
                                    n_live=n_live)
    assert torch.equal(fixed, tk.tree_histogram_fixed(
        stack[0], (0,), *stack[1:], n_nodes=NL, n_bins=nb, max_abs=max_abs))
    if integer:
        assert torch.equal(tk.fixed_to_float(fixed, max_abs)[0],
                           torch.from_numpy(out))


def test_plain_versions_refuse_rows_past_the_live_nodes():
    """The live-node precondition, checked where the plain versions run:
    an active row at node n_live is refused by every histogram form; an
    inactive one there is not."""
    codes, stats, _, active = _hist_inputs(300, 4, 8, 8, 2, True, seed=13)
    rel = np.zeros(300, np.int32)
    i = int(np.flatnonzero(active)[0])
    rel[i] = 4
    args = [torch.from_numpy(a) for a in (codes, stats, rel, active)]
    kw = dict(n_nodes=8, n_bins=8, n_live=4)
    with pytest.raises(ValueError, match="live nodes"):
        tk.tree_histogram(*args, **kw)
    stack = [a[None] for a in args]
    with pytest.raises(ValueError, match="live nodes"):
        tk.tree_histogram_slices(stack[0], (0,), *stack[1:], **kw)
    with pytest.raises(ValueError, match="live nodes"):
        tk.tree_histogram_fixed(stack[0], (0,), *stack[1:],
                                max_abs=tk.stat_max_abs(stack[1]), **kw)
    tk.tree_histogram(*args, **dict(kw, n_live=5))
    args[3][i] = False
    tk.tree_histogram(*args, **kw)
    with pytest.raises(ValueError, match="n_live"):
        tk.tree_histogram(*args, **dict(kw, n_live=9))


@pytest.mark.parametrize("G", [1, 18, 24])
@pytest.mark.parametrize("depth", range(1, 9))
def test_hist_plan_at_every_level(depth, G):
    """Every level of a population at the tune's shape (11M rows, d=28, 32
    bins, 2 stats, NL = 2^(depth-1) slots, 2^level live): the copies of
    the slice fit a block's shared memory; the blocks fill whole waves of
    the card (an SM holds one 1,024-thread block of up to 64 registers),
    at most _HIST_MAX_ROUNDS of them and at least 95% busy; every block
    walks a chunk at least; no copy of the slice sums more rows than the
    row cap between flushes; the chunks cover the rows; and the int64
    partials stay within _PARTIAL_BYTES."""
    n, d, nb, S, sms = 11_000_000, 28, 32, 2, 132
    NL = 2 ** (depth - 1)
    for level in range(depth):
        live = 2 ** level
        plan = tk.hist_plan(n, d, nb, S, NL, sms, G, live)
        grid = tk.hist_grid(n, d, nb, S, NL, sms, G, live)
        smem = tk.hist_smem_bytes(plan.NG, plan.CG, S, grid.replicas)
        assert smem <= tk.SMEM_BYTES
        assert grid.replicas in tk.HIST_REPLICAS
        assert grid.replicas == tk.hist_replicas(plan.NG, plan.CG, S)
        assert plan.NG <= live
        groups = -(-live // plan.NG) * -(-(d * nb) // plan.CG)
        launched = grid.blocks * G * groups
        rounds = -(-launched // sms)
        assert rounds <= tk._HIST_MAX_ROUNDS
        assert launched / (rounds * sms) >= 0.95
        assert plan.R >= grid.blocks
        # The rows a copy sums between flushes (one row in `replicas` of
        # a chunk): within the row cap.
        assert -(-plan.rows // grid.replicas) <= tk.HIST_MAX_ROWS
        assert plan.R * plan.rows >= n and (plan.R - 1) * plan.rows < n
        assert 8 * grid.blocks * G * live * d * nb * S <= tk._PARTIAL_BYTES


@pytest.mark.parametrize("n,rows,blocks", [
    (11_000_000, 125_000, 11), (11_000_000, 83_334, 132), (1000, 1000, 1),
    (5, 2, 3), (0, 1, 1), (7000, 2048, 2)])
def test_hist_blocks_walk_every_chunk_once(n, rows, blocks):
    """hist_slice_kernel's chunk loop: block x of a stream walks chunks x,
    x + B, ... and each chunk of the stream's rows is walked by one block;
    every block runs the loop at least once, so each of its partial
    slots is stored (a block past the rows stores zeros)."""
    walked, firsts = [], []
    for x in range(blocks):
        r0 = x * rows
        first = True
        while r0 < n or first:
            firsts.append(first)
            walked.extend(range(r0, min(n, r0 + rows)))
            first = False
            r0 += blocks * rows
    assert sorted(walked) == list(range(n))
    assert sum(firsts) == blocks


@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("T,depth,d", [(1, 6, 28), (20, 5, 28),
                                       (3, 12, 28), (2, 6, 300)])
def test_descend_groups_cover_every_slice_once(P, T, depth, d):
    """Shuffled code_idx: the slices grouped by matrix, and the staged
    plan's chunks of each matrix's (slice, tree) pairs (as
    descend_staged_kernel walks them) take every (slice, tree) once,
    over its own matrix; the tables of a chunk fit beside the two
    tiles."""
    rng = np.random.default_rng(P * 100 + T)
    G = 24
    code_idx = [int(c) for c in rng.permutation(np.arange(G) % P)]
    grouped = tk.slice_groups(code_idx, P, torch.device("cpu"))
    order, first = grouped.order.tolist(), grouped.first.tolist()
    assert sorted(order) == list(range(G))
    assert grouped.counts == tuple(np.bincount(code_idx, minlength=P))
    for p in range(P):
        mine = order[first[p]:first[p + 1]]
        assert all(code_idx[g] == p for g in mine)
        assert mine == sorted(mine)
    plan = tk.descend_plan(100_003, d, depth, T, 132, grouped.counts)
    assert plan.staged == (d <= tk.SECTOR_BYTES * depth)
    tb = tk.STEP_BYTES * tk.table_words(depth)
    assert plan.smem_bytes == (2 * plan.tile_bytes
                               + plan.trees_per_chunk * tb)
    assert plan.smem_bytes <= tk.SMEM_BYTES
    if not plan.staged:
        assert plan.chunks == -(-T // plan.trees_per_chunk)
        return
    walked = []
    for p in range(P):
        pairs = grouped.counts[p] * T
        for y in range(plan.chunks):
            c0 = y * plan.trees_per_chunk
            for q in range(c0, min(c0 + plan.trees_per_chunk, pairs)):
                g = order[first[p] + q // T]
                assert code_idx[g] == p
                walked.append((g, q % T))
    assert sorted(walked) == [(g, t) for g in range(G) for t in range(T)]
    assert plan.chunks == -(-max(grouped.counts) * T
                            // plan.trees_per_chunk)


@pytest.mark.parametrize("replicas", [1, 2, 4, 8, 16])
def test_hist_copies_sum_within_the_row_cap(replicas):
    """A chunk of replicas · HIST_MAX_ROWS rows (the longest the plan
    gives a slice of that many copies): row i goes to thread i % 1024, so
    to copy (i % 32) % replicas, and no copy sums more than
    HIST_MAX_ROWS rows, the bound under which its 32-bit words cannot
    overflow (test_hist_words_cannot_overflow)."""
    rows = replicas * tk.HIST_MAX_ROWS
    copy = (np.arange(rows) % 1024 % 32) % replicas
    assert np.bincount(copy, minlength=replicas).max() <= tk.HIST_MAX_ROWS
    n, d, nb, S = 11_000_000, 28, 32, 2
    for live in (1, 2, 4, 8, 16):
        plan = tk.hist_plan(n, d, nb, S, 32, 132, 24, live)
        grid = tk.hist_grid(n, d, nb, S, 32, 132, 24, live)
        assert plan.rows <= grid.replicas * tk.HIST_MAX_ROWS


# ---------------------------------------------------------------------------
# The feature-major copy: the stack form, its plan, the kernel's layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,n,d", [(1, 1, 1), (2, 17, 28), (3, 15, 33),
                                   (2, 1025, 6), (4, 40, 300)])
def test_feature_major_stack_matches_numpy(P, n, d):
    """A (P, n, d) stack is one call: (P, d, n), numpy's transpose of the
    last two axes, and each matrix the one-matrix copy's."""
    codes = np.random.default_rng(20).integers(0, 256, (P, n, d)).astype(
        np.uint8)
    out = tk.feature_major(torch.from_numpy(codes))
    assert out.shape == (P, d, n) and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), codes.transpose(0, 2, 1))
    for p in range(P):
        np.testing.assert_array_equal(
            out[p].numpy(), tk.feature_major(torch.from_numpy(codes[p])))


@pytest.mark.parametrize("bad", ["one_axis", "four_axes", "dtype", "device"])
def test_feature_major_refuses_bad_codes(bad):
    codes = torch.zeros((2, 16, 6), dtype=torch.uint8)
    codes = {"one_axis": codes[0, 0], "four_axes": codes[None],
             "dtype": codes.int(), "device": codes.to("meta")}[bad]
    with pytest.raises(ValueError):
        tk.feature_major(codes)


@pytest.mark.parametrize("P,G,n,d,nb,NL", [(2, 5, 517, 28, 256, 16),
                                           (3, 4, 1001, 6, 32, 4)])
def test_route_slices_with_the_stack_match_pallas(P, G, n, d, nb, NL):
    """Routing G slices over a stack of P bin matrices, given the stack's
    feature-major copy (one call): each slice equals the Pallas kernel on
    its own matrix, and so does the routing kernel's packed arithmetic
    reading that matrix of the copy."""
    rng = np.random.default_rng(21)
    codes = rng.integers(0, nb, (P, n, d)).astype(np.uint8)
    code_idx = [g % P for g in range(G)]
    per = [_route_inputs(n, d, nb, NL, seed=30 + g)[1:] for g in range(G)]
    rel, active, assign, best_f, best_t, split = (np.stack(x)
                                                  for x in zip(*per))
    codes_T = tk.feature_major(torch.from_numpy(codes))
    got = tk.tree_route_level_slices(
        torch.from_numpy(codes), code_idx,
        *map(torch.from_numpy, (rel, active, assign, best_f, best_t, split)),
        codes_T=codes_T).numpy()
    for g, p in enumerate(code_idx):
        ref = np.asarray(pk.tree_route_level(
            *map(jnp.asarray, (codes[p], rel[g], active[g], assign[g],
                               best_f[g], best_t[g], split[g])),
            tile=pk.TREE_ROUTE_TILE))
        np.testing.assert_array_equal(got[g], ref)
        words = _pack(best_f[g], best_t[g], split[g], d)
        np.testing.assert_array_equal(
            _route_packed(codes_T[p].numpy(), rel[g], active[g], assign[g],
                          words), ref)


def _trans_reach(plan):
    """The last shared byte a feature-major tile can touch, plus one: its
    first row up to 15 bytes into its first chunk, a second word read
    past its last row's last feature group, and the pads."""
    R = tk.TRANS_ROWS
    return R * plan.pitch + 15 + 8 + 16 * plan.pad * (R // tk.TRANS_GROUP
                                                      + 1)


@pytest.mark.parametrize("n", [1, 3, 15, 17, 1025, 1_000_003, 11_000_000])
@pytest.mark.parametrize("d", [1, 6, 28, 32, 33, 128, 300, 784])
def test_feature_major_plan_at_the_edges(n, d):
    """Rows up to TRANS_FEATS bytes are staged whole; 16-row groups of
    staged rows lie an odd number of 16-B chunks apart (the shared reads'
    banks); the tile fits the default shared memory and holds every byte
    a tile touches; the tiles cover the matrix; stores are aligned only
    where every feature's output row is."""
    plan = tk.feature_major_plan(n, d)
    assert plan.span == (d <= tk.TRANS_FEATS)
    assert plan.pitch == min(d, tk.TRANS_FEATS)
    assert (plan.pitch + plan.pad) % 2 == 1 and plan.pad in (0, 1)
    assert _trans_reach(plan) <= plan.smem_bytes <= 48 * 1024
    assert plan.smem_bytes % 16 == 0
    assert (plan.feat_tiles - 1) * tk.TRANS_FEATS < d
    assert plan.feat_tiles * tk.TRANS_FEATS >= d
    assert (plan.row_tiles - 1) * tk.TRANS_ROWS < n
    assert plan.row_tiles * tk.TRANS_ROWS >= n
    assert plan.row_tiles * plan.feat_tiles < 2 ** 31
    assert plan.store == ("aligned" if n % 16 == 0 else "shifted")
    for addr in (4, 8, 3):
        assert tk.feature_major_plan(n, d, addr).store == "shifted"
    with pytest.raises(ValueError):
        tk.feature_major_plan(0, d)


def _prmt(x, y, s):
    """__byte_perm: result byte i is byte (s >> 4i) & 7 of y:x."""
    b = int(x).to_bytes(4, "little") + int(y).to_bytes(4, "little")
    return int.from_bytes(bytes(b[(s >> 4 * i) & 7] for i in range(4)),
                          "little")


def _emulate_feature_major(mem, base, n, d, P, out_addr, rng):
    """feature_major_kernel of csrc/tree_kernels.cu, byte for byte: codes
    at ``base`` of the byte array ``mem`` (matrices n·d bytes apart), the
    output at device address ``out_addr``; shared memory starts as
    noise. Each block stages its tile where the kernel does (its chunks
    with a pad after every pitch of them, or strided rows with the
    widest copy base and d allow), reads 32-bit words (two and a funnel
    shift where rows are not word-aligned, asserting every read is
    aligned and inside the tile), transposes 4 × 4 byte blocks with
    byte permutes, and stores as a warp does: 16 B a lane, shifted
    across two lanes where a feature's row is not 16-B aligned, bytes at
    a warp's ends and a ragged tail. Returns (P, d, n) and how often
    each output byte was written."""
    plan = tk.feature_major_plan(n, d, out_addr)
    R, FW, GR = tk.TRANS_ROWS, tk.TRANS_FEATS, tk.TRANS_GROUP
    pitch, pad = plan.pitch, plan.pad
    out = np.zeros(P * d * n, np.uint8)
    writes = np.zeros(P * d * n, np.int64)
    for z in range(P):
        mb = base + z * n * d
        for bx in range(plan.row_tiles * plan.feat_tiles):
            ft, r0 = bx % plan.feat_tiles, bx // plan.feat_tiles * R
            rows, f0 = min(R, n - r0), ft * FW
            F = min(FW, d - f0)
            smem = rng.integers(0, 256, plan.smem_bytes).astype(np.uint8)
            off = 0
            if plan.span:
                off = (mb + r0 * d) & 15
                g0 = (mb + r0 * d) & ~15
                for c in range(((mb + (r0 + rows) * d + 15) & ~15) - g0 >> 4):
                    g, ph = g0 + 16 * c, 16 * (c + pad * (c // pitch))
                    for i in range(16):
                        ok = mb <= g + i < mb + n * d
                        smem[ph + i] = mem[g + i] if ok else 0
            else:
                a = (mb + f0) | d
                v = next(w for w in (16, 8, 4, 1) if a % w == 0)
                for r in range(rows):
                    for j in range(0, F, v):
                        src = mb + (r0 + r) * d + f0 + j
                        s = r * FW + 16 * (r // GR) + j
                        k = min(v, F - j)
                        smem[s:s + k] = mem[src:src + k]
                        smem[s + k:s + v] = 0
            aligned = off % 4 == 0 and pitch % 4 == 0

            def word(grp, u):
                t = u >> 4
                p = grp + u + 16 * pad * ((t >= pitch) + (t >= 2 * pitch))
                assert p % 4 == 0 and p + 4 <= plan.smem_bytes
                return int.from_bytes(bytes(smem[p:p + 4]), "little")

            for q in range(-(-F // 4)):
                for gb in range(0, R // GR, 32):
                    if gb * GR >= rows:
                        continue
                    lanes = []
                    for g in range(gb, gb + 32):
                        grp = 16 * (pitch + pad) * g
                        o = np.zeros((4, 4), np.int64)
                        for i in range(4):
                            w = []
                            for k in range(4):
                                u = off + (4 * i + k) * pitch + 4 * q
                                if aligned:
                                    w.append(word(grp, u))
                                    continue
                                lo, hi = word(grp, u & ~3), word(grp,
                                                                 (u & ~3) + 4)
                                w.append((hi << 32 | lo) >> 8 * (u & 3)
                                         & 0xFFFFFFFF)
                            t0, t1 = (_prmt(w[0], w[1], s)
                                      for s in (0x5140, 0x7362))
                            t2, t3 = (_prmt(w[2], w[3], s)
                                      for s in (0x5140, 0x7362))
                            o[:, i] = [_prmt(t0, t2, 0x5410),
                                       _prmt(t0, t2, 0x7632),
                                       _prmt(t1, t3, 0x5410),
                                       _prmt(t1, t3, 0x7632)]
                        lanes.append(o)
                    for j in range(min(4, F - 4 * q)):
                        ys = [np.frombuffer(b"".join(
                            int(x).to_bytes(4, "little") for x in o[j]),
                            np.uint8) for o in lanes]
                        for lane in range(32):
                            g = gb + lane
                            mine = min(max(rows - g * GR, 0), GR)
                            nxt = min(max(rows - (g + 1) * GR, 0), GR)
                            dst = (z * d + f0 + 4 * q + j) * n + r0 + g * GR
                            m = (out_addr + dst) & 15

                            def put(at, data, align):
                                assert (out_addr + at) % align == 0
                                out[at:at + len(data)] = data
                                writes[at:at + len(data)] += 1
                            y = ys[lane]
                            if m == 0:
                                if mine == GR:
                                    put(dst, y, 16)
                                else:
                                    for p in range(mine):
                                        put(dst + p, y[p:p + 1], 1)
                                continue
                            s = GR - m
                            own = lane < 31 and mine == GR and nxt >= s
                            prev = lane > 0 and rows >= g * GR and mine >= s
                            if own:
                                put(dst + s, np.concatenate(
                                    [y, ys[lane + 1]])[s:s + 16], 16)
                            for p in range(s if prev else 0,
                                           s if own else mine):
                                put(dst + p, y[p:p + 1], 1)
    return out.reshape(P, d, n), writes


@pytest.mark.parametrize("n,d", [(1, 1), (3, 6), (15, 28), (17, 28),
                                 (17, 33), (40, 300), (33, 784), (1025, 6),
                                 (1025, 32)])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_feature_major_kernel_layout_transposes(n, d, offset):
    """The kernel's staging, shared reads, byte permutes and stores,
    emulated byte for byte (``_emulate_feature_major``), give the
    transpose at the sweep's edge shapes from a base ``offset`` bytes off
    a 16-B boundary, every output byte written exactly once."""
    rng = np.random.default_rng(22)
    codes = rng.integers(0, 256, (n, d)).astype(np.uint8)
    base = 64 + offset
    mem = rng.integers(0, 256, base + n * d + 64).astype(np.uint8)
    mem[base:base + n * d] = codes.reshape(-1)
    got, writes = _emulate_feature_major(mem, base, n, d, 1, 0, rng)
    np.testing.assert_array_equal(got[0], codes.T)
    assert (writes == 1).all()


@pytest.mark.parametrize("P,n,d,offset,out_addr", [
    (2, 17, 28, 0, 0), (3, 40, 6, 5, 0), (2, 33, 300, 0, 4),
    (2, 64, 28, 0, 3)])
def test_feature_major_kernel_layout_stacks(P, n, d, offset, out_addr):
    """The emulated kernel over a stack (matrices n·d bytes apart, so
    each may start at another alignment) and into an output that is not
    16-B aligned."""
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 256, (P, n, d)).astype(np.uint8)
    base = 64 + offset
    mem = rng.integers(0, 256, base + codes.size + 64).astype(np.uint8)
    mem[base:base + codes.size] = codes.reshape(-1)
    got, writes = _emulate_feature_major(mem, base, n, d, P, out_addr, rng)
    np.testing.assert_array_equal(got, codes.transpose(0, 2, 1))
    assert (writes == 1).all()
