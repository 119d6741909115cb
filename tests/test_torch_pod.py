"""The PyTorch package's data-parallel pod against the JAX package's, on
the CPU.

The port's ranks are spawned with ``torch.multiprocessing`` (start method
spawn), joined over gloo through a ``FileStore`` under the test's
temporary directory, one thread a rank, and run inside an SPMD mesh scope
(parallel/spmd.py) as a dispatched job does. Worlds of 1, 2 and 4 ranks
put every rank on the data axis. The JAX side runs on the 8-device CPU
mesh of tests/conftest.py, on a mesh of its first 2 or 4 devices with
``mesh_shape`` "2,1" or "4,1", so its data axis has as many devices as
the port has ranks; its Pallas kernels run in interpret mode. Inputs
are made from a seed with numpy and travel to the ranks in a file.
Tolerances:

- dt and gb: every param of 2 and 4 ranks bit-identical to the port's
  one-rank fit (the histogram sums are all-reduced as fixed-point
  integers at one scale); dt bit-identical to JAX's on the same data axis
  (small-integer stats); gb's predicted classes agree with JAX's on ≥ 99%
  of rows and accuracy within one point (test_torch_models.py's);
- rf with JAX's per-shard draws injected (2 ranks): bit-identical to
  JAX's trees;
- on 4 ranks, nb probabilities within rtol 1e-5, lr (Newton) and mlp
  within atol 2e-2 with accuracy within one point (test_torch_models.py's
  and test_torch_mlp.py's);
- ``_mesh_bincount`` counts equal to JAX's exactly;
- the row-sharded repulsion (Z, F) against JAX ``viz/tsne.py:_repulsion``
  on the same mesh, through its plain row scan (``use_pallas=False``;
  test_torch_tsne_kernels.py holds the row form against the interpreted
  Pallas kernel): Z rtol 1e-5, F rtol 1e-4 / atol 1e-5
  (test_torch_tsne_kernels.py's);
- the PCA Gram matrix of 2 and 4 ranks against one rank's, float64,
  rtol 1e-12;
- ``shard_rows``/``host_rows`` round trips, resident and streamed, at a
  row count no world divides: exact;
- ``check_mesh_entry``: a pod refuses ``shard_rows`` and ``replicate``
  outside a dispatched job.

The ranks import this module, so JAX is imported inside the tests only.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models import (
    logistic, mlp, naive_bayes, trees)
from learningorchestra_tpu_torch.ops import histogram
from learningorchestra_tpu_torch.parallel import spmd
from learningorchestra_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.viz import pca, tsne

#: Rows no world divides (ragged padding on 2 and 4 ranks).
N, D, CLASSES, N_TEST = 1001, 8, 2, 400
DEPTH, BINS = 4, 16
GB_ROUNDS, RF_TREES = 3, 3
MLP_HIDDEN, MLP_ITERS = 16, 20
#: The t-SNE repulsion: rows per tile (the Pallas kernel's 128) and rows.
TILE, TSNE_ROWS, TSNE_VALID = 128, 512, 500
WORLDS = (1, 2, 4)
#: The world whose rf is held against JAX's with its shard draws, and the
#: one whose lr, nb and mlp are (the other JAX compiles would double the
#: file's time).
RF_WORLD, DENSE_WORLD = 2, 4
SPAWN_TIMEOUT_S = 120.0
TREE_KEYS = ("feat", "thr", "internal", "leaf")
GB_KEYS = ("feat", "thr", "internal", "leaf_val")


class _Lazy:
    """A lazy design (``ops/preprocess.ChunkedDesign``'s protocol)."""

    def __init__(self, X):
        self.X, self.shape, self.dtype = X, X.shape, X.dtype

    def rows(self, a, b):
        return self.X[a:b]


def _rank_work(world: int, inp: dict) -> dict:
    """Every port computation of the pod, on this rank; rank 0's
    results."""
    cfg = Settings()
    rt = DeviceRuntime(cfg, device="cpu")
    rt.FEED_BLOCK_ROWS = 100
    mesh = rt.mesh
    out = {}
    X, y, Xt = inp["X"], inp["y"], inp["Xt"]
    try:
        rt.shard_rows(X)
    except ValueError:
        out["refused_shard_rows"] = np.asarray(True)
    try:
        rt.replicate(np.zeros(3, np.float32))
    except ValueError:
        out["refused_replicate"] = np.asarray(True)
    with spmd.mesh_scope():
        # round trips
        Xd, n = rt.shard_rows(X)
        out["rows_local"] = np.asarray(Xd.shape[0])
        out["roundtrip"] = rt.host_rows(Xd, n)
        Ld, ln = rt.shard_rows(_Lazy(X))
        out["roundtrip_lazy"] = rt.host_rows(Ld, ln)
        if rt.valid_rows(n) is not None:
            # Real rows over every rank's block: the padding is masked.
            vs = rt.valid_rows(n).sum().reshape(1)
            all_reduce_(vs, mesh, DATA_AXIS)
            out["valid_sum"] = vs.numpy()
        # trees
        dt = trees.fit_dt(rt, X, y, CLASSES, max_depth=DEPTH, n_bins=BINS)
        for k in TREE_KEYS:
            out[f"dt.{k}"] = dt.params[k].numpy()
        gb = trees.fit_gb(rt, X, y, CLASSES, n_rounds=GB_ROUNDS,
                          max_depth=DEPTH, n_bins=BINS)
        for k in GB_KEYS:
            out[f"gb.{k}"] = gb.params[k].numpy()
        out["gb.proba"] = gb.predict_proba(rt, Xt)
        if f"rf_w{world}" in inp:
            rf = trees.fit_rf(rt, X, y, CLASSES, n_trees=RF_TREES,
                              max_depth=DEPTH, n_bins=BINS,
                              weights=inp[f"rf_w{world}"],
                              feature_allowed=inp[f"rf_a{world}"])
            for k in TREE_KEYS:
                out[f"rf.{k}"] = rf.params[k].numpy()
        if world <= RF_WORLD:
            own = trees.fit_rf(rt, X, y, CLASSES, n_trees=RF_TREES,
                               max_depth=DEPTH, n_bins=BINS, seed=3)
            out["rf_own.proba"] = own.predict_proba(rt, Xt)
        # lr, nb, mlp
        out["lr.proba"] = logistic.fit(
            rt, inp["Xlr"], y, CLASSES).predict_proba(rt, inp["Xlr"])
        for em in ("gaussian", "multinomial"):
            Xn = np.abs(X) if em == "multinomial" else X
            out[f"nb_{em}.proba"] = naive_bayes.fit(
                rt, Xn, y, CLASSES, event_model=em).predict_proba(rt, Xn)
        p0 = {k[4:]: inp[k] for k in inp if k.startswith("mlp.")}
        out["mlp.proba"] = mlp.fit(
            rt, X, y, CLASSES, hidden=MLP_HIDDEN, iters=MLP_ITERS,
            lr=2e-2, params0=p0).predict_proba(rt, X)
        # exploration
        counts = histogram.field_counts(inp["hist"], rt)
        out["hist.keys"] = np.asarray(sorted(counts), np.int64)
        out["hist.vals"] = np.asarray([counts[k] for k in sorted(counts)],
                                      np.int64)
        Xd, n = rt.shard_rows(X)
        valid = rt.valid_rows(n)
        out["gram"] = pca._gram(Xd, n, valid, mesh)[2].numpy()
        Y = torch.from_numpy(inp["Y"])
        v = torch.from_numpy(inp["valid"])
        Z, F = tsne._repulsion(Y, v, mesh)
        out["Z"], out["F"] = Z.numpy(), F.numpy()
    return out


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        with np.load(os.path.join(tmp, "in.npz")) as f:
            inp = dict(f)
        out = _rank_work(world, inp)
        if rank == 0:
            np.savez(os.path.join(tmp, "out.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(world: int, inputs: dict, tmp) -> dict:
    """Run ``_rank_work`` on ``world`` ranks; rank 0's results."""
    np.savez(os.path.join(tmp, "in.npz"), **inputs)
    ctx = mp.start_processes(_rank, args=(world, str(tmp)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"the {world} ranks did not finish within "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    with np.load(os.path.join(tmp, "out.npz")) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# The JAX side and the inputs
# ---------------------------------------------------------------------------

def _blobs(n, seed, sep=1.2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(CLASSES, D)) * sep
    y = rng.integers(0, CLASSES, size=n)
    X = (centers[y] + rng.normal(size=(n, D))).astype(np.float32)
    return X, y.astype(np.int32)


def _jax_forest_draws(seed, n, d, n_trees, mtry, n_shards):
    """The JAX package's rf draws (test_torch_models.py's): per tree,
    split the batch key; Poisson(1) weights per data shard from
    ``fold_in(kb, shard)``; the first ``mtry`` of a permutation of the
    features."""
    import jax

    from learningorchestra_tpu.models import trees as jtrees

    tb, nb = jtrees._forest_batch_shape(n_trees)
    keys = jax.random.split(jax.random.PRNGKey(seed), nb * tb)
    local = (n + (-n) % n_shards) // n_shards
    weights, allowed = [], []
    for i in range(n_trees):
        kb, kf = jax.random.split(keys[i])
        w = np.concatenate([
            np.asarray(jax.random.poisson(jax.random.fold_in(kb, s), 1.0,
                                          (local,)), np.float32)
            for s in range(n_shards)])[:n]
        perm = np.asarray(jax.random.permutation(kf, d))
        a = np.zeros(d, bool)
        a[perm[:mtry]] = True
        weights.append(w)
        allowed.append(a)
    return np.stack(weights), np.stack(allowed)


def _jrt(world):
    """A JAX runtime whose mesh is ``world`` CPU devices, all on the data
    axis (``mesh_shape`` "world,1")."""
    import jax

    from learningorchestra_tpu.config import Settings as JaxSettings
    from learningorchestra_tpu.parallel.mesh import MeshRuntime, local_mesh

    cfg = JaxSettings()
    cfg.mesh_shape = f"{world},1"
    rt = MeshRuntime(cfg)
    rt._mesh = local_mesh(cfg, jax.devices()[:world])
    return rt


@pytest.fixture(scope="module")
def inputs():
    import jax

    from learningorchestra_tpu.models import mlp as jmlp

    X, y = _blobs(N, 0)
    Xt, yt = _blobs(N_TEST, 0)
    Xt = Xt + np.float32(0.01)
    rng = np.random.default_rng(1)
    inp = {"X": X, "y": y, "Xt": Xt, "yt": yt,
           "Xlr": (_blobs(N, 6, sep=0.4)[0] * np.float32(3.0)
                   + np.float32(10.0)),
           "hist": rng.integers(-3, 40, N).astype(np.int64)}
    mtry = max(1, int(np.sqrt(D)))
    inp[f"rf_w{RF_WORLD}"], inp[f"rf_a{RF_WORLD}"] = _jax_forest_draws(
        5, N, D, RF_TREES, mtry, RF_WORLD)
    p0 = jmlp.init_params(jax.random.PRNGKey(2), D, MLP_HIDDEN, CLASSES)
    inp.update({f"mlp.{k}": np.asarray(v) for k, v in p0.items()})
    Y = (rng.normal(size=(TSNE_ROWS, 2)) * 5.0).astype(np.float32)
    valid = (np.arange(TSNE_ROWS) < TSNE_VALID).astype(np.float32)
    Y[TSNE_VALID:] = 0.0
    inp["Y"], inp["valid"] = Y, valid
    return inp


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """Rank 0's results per world, each world run once."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _spawn(world, inputs,
                                  tmp_path_factory.mktemp(f"pod{world}"))
        return cache[world]

    return get


@pytest.fixture(scope="module")
def jax_fits(inputs):
    """The JAX package's fits per data-axis size (2 and 4)."""
    from learningorchestra_tpu.models import logistic as jlogistic
    from learningorchestra_tpu.models import mlp as jmlp
    from learningorchestra_tpu.models import naive_bayes as jnb
    from learningorchestra_tpu.models import trees as jtrees

    cache = {}

    def get(world):
        if world in cache:
            return cache[world]
        rt = _jrt(world)
        X, y, Xt = inputs["X"], inputs["y"], inputs["Xt"]
        out = {"rt": rt}
        out["dt"] = jtrees.fit_dt(rt, X, y, CLASSES, max_depth=DEPTH,
                                  n_bins=BINS)
        gb = jtrees.fit_gb(rt, X, y, CLASSES, n_rounds=GB_ROUNDS,
                           max_depth=DEPTH, n_bins=BINS)
        out["gb.proba"] = np.asarray(gb.predict_proba(rt, Xt))
        if world == RF_WORLD:
            out["rf"] = jtrees.fit_rf(rt, X, y, CLASSES, n_trees=RF_TREES,
                                      max_depth=DEPTH, n_bins=BINS, seed=5)
        if world != DENSE_WORLD:
            cache[world] = out
            return out
        out["lr.proba"] = np.asarray(jlogistic.fit(
            rt, inputs["Xlr"], y, CLASSES).predict_proba(rt, inputs["Xlr"]))
        for em in ("gaussian", "multinomial"):
            Xn = np.abs(X) if em == "multinomial" else X
            out[f"nb_{em}.proba"] = np.asarray(jnb.fit(
                rt, Xn, y, CLASSES, event_model=em).predict_proba(rt, Xn))
        out["mlp.proba"] = np.asarray(jmlp.fit(
            rt, X, y, CLASSES, seed=2, hidden=MLP_HIDDEN, iters=MLP_ITERS,
            lr=2e-2).predict_proba(rt, X))
        cache[world] = out
        return out

    return get


def _acc(p, y):
    return float((np.argmax(p, 1) == y).mean())


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family,keys", [("dt", TREE_KEYS),
                                         ("gb", GB_KEYS)])
def test_tree_fits_bit_identical_to_one_rank(runs, world, family, keys):
    one, many = runs(1), runs(world)
    for k in keys:
        np.testing.assert_array_equal(many[f"{family}.{k}"],
                                      one[f"{family}.{k}"],
                                      err_msg=f"{family}.{k}")
    if family == "gb":
        np.testing.assert_array_equal(many["gb.proba"], one["gb.proba"])


@pytest.mark.parametrize("world,fam", [(2, "dt"), (4, "dt"),
                                       (RF_WORLD, "rf")])
def test_dt_and_rf_match_jax_on_the_same_data_axis(runs, jax_fits, world,
                                                    fam):
    port, jx = runs(world), jax_fits(world)
    for k in TREE_KEYS:
        np.testing.assert_array_equal(
            port[f"{fam}.{k}"], np.asarray(jx[fam].params[k]),
            err_msg=f"{fam}.{k}")


@pytest.mark.parametrize("world", [2, 4])
def test_gb_agrees_with_jax(runs, jax_fits, inputs, world):
    pt, pj = runs(world)["gb.proba"], jax_fits(world)["gb.proba"]
    assert pt.shape == pj.shape == (N_TEST, CLASSES)
    assert (np.argmax(pt, 1) == np.argmax(pj, 1)).mean() >= 0.99
    assert abs(_acc(pt, inputs["yt"]) - _acc(pj, inputs["yt"])) <= 0.01


@pytest.mark.parametrize("world", [DENSE_WORLD])
@pytest.mark.parametrize("family", ["lr", "nb_gaussian", "nb_multinomial",
                                    "mlp"])
def test_dense_families_match_jax(runs, jax_fits, inputs, world, family):
    pt = runs(world)[f"{family}.proba"]
    pj = jax_fits(world)[f"{family}.proba"]
    assert pt.shape == pj.shape == (N, CLASSES)
    if family.startswith("nb"):
        np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(pt, pj, atol=2e-2)
        assert abs(_acc(pt, inputs["y"]) - _acc(pj, inputs["y"])) <= 0.01


@pytest.mark.parametrize("world", [RF_WORLD])
def test_rf_own_draws_depend_on_the_shard(runs, inputs, world):
    """rf's own bootstrap is drawn per rank: a pod's forest differs from
    one rank's, and both fit the data."""
    one, many = runs(1)["rf_own.proba"], runs(world)["rf_own.proba"]
    assert not np.array_equal(one, many)
    for p in (one, many):
        assert _acc(p, inputs["yt"]) > 0.9


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_bincount_matches_jax(runs, inputs, world):
    from learningorchestra_tpu.ops import histogram as jhist

    want = jhist.field_counts(_jrt(world), inputs["hist"])
    got = runs(world)
    assert dict(zip(got["hist.keys"].tolist(),
                    got["hist.vals"].tolist())) == want
    assert sum(want.values()) == N


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_repulsion_matches_jax(runs, inputs, world):
    import jax.numpy as jnp

    from learningorchestra_tpu.viz import tsne as jtsne

    rt = _jrt(world)
    Z, F = jtsne._repulsion(jnp.asarray(inputs["Y"]),
                            jnp.asarray(inputs["valid"]), tile=TILE,
                            use_pallas=False, mesh=rt.mesh)
    got = runs(world)
    assert np.isclose(float(got["Z"]), float(Z), rtol=1e-5)
    np.testing.assert_allclose(got["F"], np.asarray(F), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_pca_gram_matches_one_rank(runs, world):
    np.testing.assert_allclose(runs(world)["gram"], runs(1)["gram"],
                               rtol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_shard_and_host_rows_round_trip(runs, inputs, world):
    got = runs(world)
    assert int(got["rows_local"]) == -(-N // world)
    np.testing.assert_array_equal(got["roundtrip"], inputs["X"])
    np.testing.assert_array_equal(got["roundtrip_lazy"], inputs["X"])
    if world > 1:
        assert float(got["valid_sum"][0]) == N


@pytest.mark.parametrize("world", WORLDS)
def test_check_mesh_entry_refuses_undispatched_ops(runs, world):
    got = runs(world)
    for what in ("shard_rows", "replicate"):
        assert (f"refused_{what}" in got) == (world > 1), what


def test_tune_refuses_a_multi_rank_mesh():
    from learningorchestra_tpu_torch.models import tune
    from learningorchestra_tpu_torch.parallel.mesh import ProcessMesh

    rt = DeviceRuntime(Settings(), device="cpu")
    rt._mesh = ProcessMesh((2, 1, 1), rank=0)
    X, y = _blobs(64, 0)
    with pytest.raises(ValueError, match="one rank"):
        tune.sweep(rt, X, y, 2, "dt", [{"max_depth": 2}], cfg=Settings())


def _numpy_step(Y, vel, gains, table, n_valid, exaggeration, eta,
                momentum):
    """One descent step in float64 numpy, straight from the definition:
    the repulsion over all valid pairs, the table's attraction, and each
    overflow edge added on its own (``np.add.at``)."""
    sym_idx, sym_w, ov_src, ov_dst, ov_w = table
    Y, vel, gains = (a.astype(np.float64) for a in (Y, vel, gains))
    n = len(Y)
    valid = (np.arange(n) < n_valid).astype(np.float64)
    d = Y[:, None, :] - Y[None, :, :]
    q = 1.0 / (1.0 + (d * d).sum(-1)) * valid[:, None] * valid[None, :]
    np.fill_diagonal(q, 0.0)
    Z, Frep = q.sum(), ((q * q)[..., None] * d).sum(1)
    diff = Y[:, None, :] - Y[sym_idx]
    w = sym_w * exaggeration / (1.0 + (diff * diff).sum(-1))
    Fattr = (w[..., None] * diff).sum(1)
    dov = Y[ov_dst] - Y[ov_src]
    fov = (ov_w * exaggeration / (1.0 + (dov * dov).sum(-1)))[:, None] * dov
    np.add.at(Fattr, ov_dst, fov)
    grad = 4.0 * (Fattr - Frep / Z)
    gains = np.where(np.sign(grad) == np.sign(vel), gains * 0.8, gains + 0.2)
    gains = np.maximum(gains, 0.01)
    vel = momentum * vel - eta * gains * grad
    return (Y + vel) * valid[:, None], vel, gains


def test_overflow_segment_sums_match_the_atomic_adds():
    """The deterministic sum of the hub-overflow edges (one int64
    fixed-point running sum a destination, then one add a row), which
    every descent takes on one card and on a pod, gives the step of a
    float64 numpy evaluation that adds each edge on its own
    (``np.add.at``) within rtol 1e-5, atol 1e-7. The step runs in
    float64 here, as the reference does, so what differs is the order of
    the sums, not float32 rounding."""
    rng = np.random.default_rng(7)
    n, k = 300, 4
    idx = rng.integers(0, n, (n, k))
    idx[:, 0] = 0                        # row 0: a hub past the 2k cap
    P = rng.random((n, k)).astype(np.float32)
    P /= P.sum(1, keepdims=True)
    table = [a.numpy() for a in tsne._edge_table(
        torch.from_numpy(idx), torch.from_numpy(P), n, n)]
    assert len(table[3]) > 0
    t = lambda a, dt=None: torch.from_numpy(np.asarray(a, dt))
    sym_idx, ov_src, ov_dst = (t(a, np.int64) for a in
                               (table[0], table[2], table[3]))
    seg = tsne._overflow_segments(ov_dst)
    assert torch.equal(seg[0], torch.unique(ov_dst))
    Y = rng.normal(size=(n, 2))
    state = (t(Y), torch.zeros((n, 2), dtype=torch.float64),
             torch.ones((n, 2), dtype=torch.float64))
    args = (sym_idx, t(table[1], np.float64), ov_src, ov_dst,
            t(table[4], np.float64), n, 12.0, 50.0, 0.5)
    want = _numpy_step(Y, np.zeros((n, 2)), np.ones((n, 2)), table, n,
                       12.0, 50.0, 0.5)
    got = tsne._step(*state, *args, None, seg)
    for x, y in zip(want, got):
        np.testing.assert_allclose(y.numpy(), x, rtol=1e-5, atol=1e-7)
