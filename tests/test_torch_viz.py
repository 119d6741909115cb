"""The PyTorch package's PCA, t-SNE and image service against the JAX
package's, on the CPU.

t-SNE is held stage by stage: each port stage gets the JAX stage's numpy
output as its input (the state that crosses over — padded input, kNN,
P, edge table, (Y, vel, gains) — is numpy), then the whole embed is
compared by quality under exact affinities. The JAX side runs its Pallas
repulsion in interpret mode; the port its plain version. Each comparison
states its tolerance and why.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.parallel.mesh import MeshRuntime
from learningorchestra_tpu.viz import pca as jpca
from learningorchestra_tpu.viz import tsne as jt
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.viz import pca as tpca
from learningorchestra_tpu_torch.viz import tsne as tt
from learningorchestra_tpu_torch.viz.service import (
    ImageExists, ImageNotFound, ImageService, create_embedding_image,
    embed_dataset)


@pytest.fixture(scope="module")
def jax_rt():
    return MeshRuntime(JaxSettings())


@pytest.fixture(scope="module")
def cpu_rt():
    return DeviceRuntime(Settings(), device="cpu")


def _clusters(n_per=60, d=10, classes=3, sep=8.0, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * sep
    X = np.concatenate([centers[c] + rng.normal(size=(n_per, d))
                        for c in range(classes)])
    y = np.repeat(np.arange(classes), n_per)
    return X.astype(np.float32), y


# -- PCA ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["clusters", "odd101"])
def test_pca_matches_jax(jax_rt, cpu_rt, case):
    """Components agree up to a sign each, within 1e-4·max|JAX| (the port
    accumulates the Gram matrix in float64, the JAX package in float32)."""
    if case == "clusters":
        X, _ = _clusters()
    else:
        X = np.random.default_rng(0).normal(size=(101, 5)).astype(np.float32)
    ref = jpca.pca_embed(jax_rt, X)
    out = tpca.pca_embed(cpu_rt, X)
    assert out.shape == ref.shape == (len(X), 2)
    for j in range(2):
        sign = np.sign(np.dot(out[:, j], ref[:, j]))
        np.testing.assert_allclose(sign * out[:, j], ref[:, j], rtol=0,
                                   atol=1e-4 * np.abs(ref[:, j]).max())


def test_pca_needs_enough_columns(cpu_rt):
    with pytest.raises(ValueError, match="pca with 2 components"):
        tpca.pca_embed(cpu_rt, np.zeros((5, 1), np.float32))


# -- t-SNE stages -------------------------------------------------------------

def _padded(n=600, d=50, tile=128, seed=1):
    X = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return tt._pad_rows(X, tile)


def test_pad_rows_matches_jax():
    X = np.random.default_rng(0).normal(size=(37, 3)).astype(np.float32)
    out, n = tt._pad_rows(X, 16)
    ref, n_ref = jt._pad_rows(X, 16)
    assert n == n_ref == 37
    np.testing.assert_array_equal(out, ref)


def test_knn_matches_jax():
    """d2k within rtol 1e-5, atol 1e-4 (both use the |a|²+|b|²−2ab form in
    float32, summed in another order). Neighbour sets are equal except in
    rows whose k-th and (k+1)-th distances lie within 1e-5."""
    Xp, n_valid = _padded()
    k, tile = 30, 128
    d2_ref, idx_ref = (np.asarray(a) for a in jt._knn(jnp.asarray(Xp), k=k,
                                                      tile=tile))
    d2, idx = (t.numpy() for t in tt._knn(torch.from_numpy(Xp), k=k,
                                           tile=tile))
    assert idx.dtype == np.int32 and d2.shape == (len(Xp), k)
    np.testing.assert_allclose(d2[:n_valid], d2_ref[:n_valid], rtol=1e-5,
                               atol=1e-4)
    X64 = Xp[:n_valid].astype(np.float64)
    full = ((X64[:, None, :] - X64[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(full, np.inf)
    kth = np.sort(full, axis=1)[:, k - 1:k + 1]
    for r in range(n_valid):
        if set(idx[r]) != set(idx_ref[r]):
            assert kth[r, 1] - kth[r, 0] <= 1e-5, r


def test_calibrate_matches_jax():
    """P within rtol 1e-4 from the same d2k (50 bisection steps each)."""
    Xp, n_valid = _padded(seed=2)
    d2k, _ = jt._knn(jnp.asarray(Xp), k=30, tile=128)
    d2k = np.asarray(d2k)[:n_valid]
    ref = np.asarray(jt._calibrate(jnp.asarray(d2k), jnp.float32(10.0)))
    out = tt._calibrate(torch.from_numpy(d2k), 10.0).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4)
    np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-5)


def _hub_edges(n, n_pad, k, seed):
    """Random kNN indices where row 0 is every row's first neighbour: its
    in-degree exceeds the table's 2k cap, so overflow edges exist."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(1, n, (n, k)).astype(np.int32)
    idx[1:, 0] = 0
    P = rng.random((n, k)).astype(np.float32)
    P /= P.sum(1, keepdims=True)
    return idx, P


def _table_case(n, n_pad, k, case):
    """kNN indices and P of one edge-table case: ``hubs`` (overflow edges
    exist), ``ring`` (every in-degree k: no overflow), ``padding`` (hubs,
    and neighbours at or past ``n``, which are dropped at weight 0),
    ``empty`` (k = 0, as for one row)."""
    if case == "ring":
        idx = ((np.arange(n)[:, None] + np.arange(1, k + 1)) % n
               ).astype(np.int32)
        return idx, np.full((n, k), 1.0 / k, np.float32)
    if case == "empty":
        return np.zeros((n, 0), np.int32), np.zeros((n, 0), np.float32)
    idx, P = _hub_edges(n, n_pad, k, seed=3)
    if case == "padding":
        idx[::7, 2] = n_pad - 1
        idx[::5, 1] = n
    return idx, P


@pytest.mark.parametrize("n,n_pad,k,case", [
    pytest.param(300, 320, 5, "hubs", id="300-320-5"),
    pytest.param(256, 256, 8, "hubs", id="256-256-8"),
    pytest.param(300, 320, 5, "ring", id="no-overflow"),
    pytest.param(300, 320, 5, "padding", id="padding-neighbours"),
    pytest.param(1, 8, 0, "empty", id="k0"),
])
def test_edge_table_identical(n, n_pad, k, case):
    """The table built from CPU tensors equals the JAX package's host
    table: every index, and every weight's bits; int64 indices and
    float32 weights."""
    idx, P = _table_case(n, n_pad, k, case)
    out = tt._edge_table(torch.from_numpy(idx), torch.from_numpy(P), n_pad,
                         n)
    ref = jt._edge_table(idx, P, n_pad, n)
    assert (len(out[2]) > 0) == (case in ("hubs", "padding"))
    if case == "padding":
        assert (idx >= n).any()
    for i, (a, b) in enumerate(zip(out, ref)):
        want = torch.float32 if i in (1, 4) else torch.int64
        assert a.dtype == want and a.shape == b.shape
        a = a.numpy()
        if i in (1, 4):
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("exaggeration,momentum", [(12.0, 0.5), (1.0, 0.8)])
def test_step_matches_jax(exaggeration, momentum):
    """One descent step from the same (Y, vel, gains) and edge table, with
    overflow edges present: Y, vel and gains within rtol 1e-4, atol 1e-6
    of the JAX step through its Pallas repulsion (float32, other summation
    order)."""
    rng = np.random.default_rng(4)
    n, n_valid, k, tile, eta = 256, 240, 8, 128, 200.0
    idx, P = _hub_edges(n_valid, n, k, seed=5)
    table = jt._edge_table(idx, P, n, n_valid)
    Y = rng.normal(scale=1e-2, size=(n, 2)).astype(np.float32)
    vel = rng.normal(scale=1e-3, size=(n, 2)).astype(np.float32)
    gains = rng.uniform(0.5, 2.0, size=(n, 2)).astype(np.float32)
    ref = jt._step(jnp.array(Y), jnp.asarray(vel), jnp.asarray(gains),
                   *map(jnp.asarray, table), jnp.float32(n_valid),
                   jnp.float32(exaggeration), jnp.float32(eta),
                   jnp.float32(momentum), tile=tile, use_pallas=True)
    t_table = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                                else a) for a in table]
    out = tt._step(torch.from_numpy(Y), torch.from_numpy(vel),
                   torch.from_numpy(gains), *t_table, n_valid, exaggeration,
                   eta, momentum,
                   ov_seg=tt._overflow_segments(t_table[3]))
    for name, a, b in zip(("Y", "vel", "gains"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# -- t-SNE end to end ---------------------------------------------------------

def _quality_input():
    """tests/test_viz.py's 2,000-row quality input: 4 anisotropic
    clusters plus a connecting filament, in 20-D."""
    rng = np.random.default_rng(3)
    n_per = 450
    centers = rng.normal(size=(4, 20)) * 5.0
    parts = [centers[c] + rng.normal(size=(n_per, 20)) * (0.6 + 0.3 * c)
             for c in range(4)]
    t = rng.random(200)[:, None]
    parts.append(centers[0] * (1 - t) + centers[1] * t
                 + rng.normal(size=(200, 20)) * 0.3)
    return np.concatenate(parts).astype(np.float32)


def _exact_joint_P(X, perplexity=30.0):
    """Exact symmetrized t-SNE input affinities (full pairwise + per-row
    bisection), a copy of tests/test_viz.py's yardstick."""
    n = len(X)
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    target = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        d2_i = np.delete(d2[i], i)
        lo, hi, beta = 0.0, np.inf, 1.0
        for _ in range(60):
            w = np.exp(-d2_i * beta)
            s = w.sum()
            h = np.log(s) + beta * (d2_i * w).sum() / s
            if h > target:
                lo = beta
                beta = beta * 2.0 if np.isinf(hi) else (lo + hi) / 2.0
            else:
                hi = beta
                beta = (lo + hi) / 2.0
        P[i] = np.insert(w / s, i, 0.0)
    P = (P + P.T) / (2.0 * n)
    return np.maximum(P, 1e-12)


def _kl_divergence(P, Y):
    """KL(P || Q) of an embedding under exact input affinities P."""
    d2 = ((Y[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
    q = 1.0 / (1.0 + d2)
    np.fill_diagonal(q, 0.0)
    Q = np.maximum(q / q.sum(), 1e-12)
    return float((P * (np.log(P) - np.log(Q))).sum())


def test_tsne_embed_quality_matches_jax(jax_rt, cpu_rt):
    """500 iterations on the same input and seed: the port's KL under
    exact affinities within 5% of the JAX embed's, trustworthiness within
    0.02 (the two descents diverge pointwise after a few dozen steps, so
    quality, not coordinates, is compared)."""
    from sklearn.manifold import trustworthiness

    X = _quality_input()
    kw = dict(perplexity=30, iters=500, exaggeration_iters=150)
    ref = jt.tsne_embed(jax_rt, X, **kw)
    out = tt.tsne_embed(cpu_rt, X, **kw)
    assert out.shape == (2000, 2) and np.isfinite(out).all()
    P = _exact_joint_P(X.astype(np.float64))
    kl_ref, kl = _kl_divergence(P, ref), _kl_divergence(P, out)
    assert abs(kl - kl_ref) <= 0.05 * kl_ref, (kl, kl_ref)
    t_ref = trustworthiness(X, ref, n_neighbors=12)
    t_out = trustworthiness(X, out, n_neighbors=12)
    assert abs(t_out - t_ref) <= 0.02, (t_out, t_ref)


def test_tsne_first_iterations_match_jax(jax_rt, cpu_rt):
    """The first 10 iterations from the same start agree within rtol 1e-3
    (atol 1e-3·max|Y| for coordinates near zero), before the descent's
    sensitivity grows."""
    X = _quality_input()
    kw = dict(perplexity=30, iters=10, exaggeration_iters=150)
    ref = jt.tsne_embed(jax_rt, X, **kw)
    out = tt.tsne_embed(cpu_rt, X, **kw)
    np.testing.assert_allclose(out, ref, rtol=1e-3,
                               atol=1e-3 * np.abs(ref).max())


def test_tsne_separates_clusters(cpu_rt):
    X, y = _clusters(n_per=50, sep=12.0)
    emb = tt.tsne_embed(cpu_rt, X, perplexity=15, iters=300,
                        exaggeration_iters=100)
    assert emb.shape == (150, 2) and np.isfinite(emb).all()
    cents = np.stack([emb[y == c].mean(axis=0) for c in range(3)])
    spread = max(np.linalg.norm(emb[y == c] - cents[c], axis=1).mean()
                 for c in range(3))
    gaps = [np.linalg.norm(cents[a] - cents[b])
            for a in range(3) for b in range(a + 1, 3)]
    assert min(gaps) > 2.0 * spread


# -- the image service --------------------------------------------------------

@pytest.fixture()
def port_cfg(tmp_path):
    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    cfg.image_root = str(tmp_path / "images")
    cfg.persist = False
    return cfg


def test_create_embedding_images(port_cfg):
    store = DatasetStore(port_cfg)
    rt = DeviceRuntime(port_cfg, device="cpu")
    X, y = _clusters(n_per=30)
    store.create("viz_src", columns={
        **{f"f{i}": X[:, i] for i in range(X.shape[1])},
        "label": y.astype(np.int64)}, finished=True)
    for method in ("pca", "tsne"):
        path = create_embedding_image(
            store, rt, method, "viz_src", "img1", label="label",
            image_root=port_cfg.image_root,
            **({"iters": 50, "exaggeration_iters": 20}
               if method == "tsne" else {}))
        assert path.endswith(f"{method}/img1.png")
        assert os.path.getsize(path) > 1000
    emb, labels = embed_dataset(store, rt, "pca", "viz_src", label="label")
    assert emb.shape == (90, 2)
    np.testing.assert_array_equal(labels, y)


def test_image_service_crud(port_cfg):
    svc = ImageService("tsne", port_cfg)
    assert svc.list_names() == []
    with pytest.raises(ImageNotFound):
        svc.get_path("nope")
    p = os.path.join(port_cfg.image_root, "tsne", "a.png")
    os.makedirs(os.path.dirname(p), exist_ok=True)
    with open(p, "wb") as f:
        f.write(b"png")
    assert svc.list_names() == ["a"]
    with pytest.raises(ImageExists):
        svc.validate_new("a")
    svc.delete("a")
    assert svc.list_names() == []


def test_embedding_label_validation(port_cfg):
    store = DatasetStore(port_cfg)
    rt = DeviceRuntime(port_cfg, device="cpu")
    store.create("v2", columns={"x": np.arange(10.0)}, finished=True)
    with pytest.raises(ValueError, match="label field"):
        create_embedding_image(store, rt, "pca", "v2", "i", label="nope",
                               image_root=port_cfg.image_root)
    with pytest.raises(ValueError, match="unknown embedding"):
        create_embedding_image(store, rt, "umap", "v2", "i",
                               image_root=port_cfg.image_root)
