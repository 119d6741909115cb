"""The PyTorch package's t-SNE repulsion against the JAX package's Pallas one.

On the CPU ``learningorchestra_tpu_torch.ops.tsne_kernels`` runs its plain
PyTorch version; the JAX side runs the Pallas kernel in interpret mode
(tile 128, as tests/test_pallas.py does). Inputs come from numpy with a
seed and go to both. Tolerances are tests/test_pallas.py's: Z rtol 1e-5;
F rtol 1e-4, atol 1e-5 (float32 sums taken in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from learningorchestra_tpu.ops import pallas_kernels as pk
from learningorchestra_tpu_torch.ops import tsne_kernels as tsk

TILE = 128


def _inputs(n, n_valid, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(n, 2)).astype(np.float32)
    valid = (np.arange(n) < n_valid).astype(np.float32)
    return Y, valid


def _numpy_repulsion(Yq, vq, Y, valid, offset):
    """Float64 evaluation of the same sums, straight from the definition."""
    Yq, Y = Yq.astype(np.float64), Y.astype(np.float64)
    d2 = ((Yq[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
    q = 1.0 / (1.0 + d2)
    rid = offset + np.arange(len(Yq))
    q = q * vq[:, None] * valid[None, :] \
        * (rid[:, None] != np.arange(len(Y))[None, :])
    q2 = q * q
    return q.sum(), Yq * q2.sum(1, keepdims=True) - q2 @ Y


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n,n_valid", [(256, 256), (256, 201), (512, 512),
                                       (512, 401)])
def test_repulsion_matches_pallas(n, n_valid):
    Y, valid = _inputs(n, n_valid)
    Z_ref, F_ref = pk.tsne_repulsion(jnp.asarray(Y), jnp.asarray(valid),
                                     tile=TILE)
    Z, F = tsk.tsne_repulsion(*_torch(Y, valid))
    assert Z.shape == () and F.shape == (n, 2)
    assert np.isclose(float(Z), float(Z_ref), rtol=1e-5)
    np.testing.assert_allclose(F.numpy(), np.asarray(F_ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n,n_valid,offset", [(256, 256, 0), (256, 201, 128),
                                              (512, 401, 128),
                                              (512, 512, 0)])
def test_repulsion_rows_matches_pallas(n, n_valid, offset):
    Y, valid = _inputs(n, n_valid, seed=1)
    nq = 128
    Yq, vq = Y[offset:offset + nq], valid[offset:offset + nq]
    Z_ref, F_ref = pk.tsne_repulsion_rows(
        *map(jnp.asarray, (Yq, vq, Y, valid)), offset, tile=TILE)
    Z, F = tsk.tsne_repulsion_rows(*_torch(Yq, vq, Y, valid), offset)
    assert np.isclose(float(Z), float(Z_ref), rtol=1e-5)
    np.testing.assert_allclose(F.numpy(), np.asarray(F_ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n,n_valid,offset,nq", [(300, 300, 0, 300),
                                                 (300, 257, 37, 151),
                                                 (7, 5, 3, 4)])
def test_repulsion_ragged_matches_float64(n, n_valid, offset, nq):
    """Shapes off any tile (the Pallas kernel refuses them) against a
    float64 numpy evaluation; the diagonal uses the global row id."""
    Y, valid = _inputs(n, n_valid, seed=2)
    Yq, vq = Y[offset:offset + nq], valid[offset:offset + nq]
    Z, F = tsk.tsne_repulsion_rows(*_torch(Yq, vq, Y, valid), offset)
    Z_ref, F_ref = _numpy_repulsion(Yq, vq, Y, valid, offset)
    assert np.isclose(float(Z), Z_ref, rtol=1e-5)
    np.testing.assert_allclose(F.numpy(), F_ref, rtol=1e-4, atol=1e-5)


def test_row_halves_sum_to_the_whole():
    """Z partials of two row halves sum to the whole Z (rtol 1e-5) and the
    halves' F rows are the whole F's."""
    n = 512
    Y, valid = _inputs(n, 450, seed=3)
    Yt, vt = _torch(Y, valid)
    Z, F = tsk.tsne_repulsion(Yt, vt)
    h = n // 2
    Z0, F0 = tsk.tsne_repulsion_rows(Yt[:h], vt[:h], Yt, vt, 0)
    Z1, F1 = tsk.tsne_repulsion_rows(Yt[h:], vt[h:], Yt, vt, h)
    assert np.isclose(float(Z0 + Z1), float(Z), rtol=1e-5)
    np.testing.assert_allclose(torch.cat([F0, F1]).numpy(), F.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_padding_rows_masked_at_any_coordinates():
    """Padding rows start at random coordinates (before the first step
    zeroes them), so masking must not rely on zeros."""
    Y, valid = _inputs(256, 200, seed=4)
    Y[200:] = np.random.default_rng(5).normal(size=(56, 2)) * 1e3
    Z, F = tsk.tsne_repulsion(*_torch(Y, valid))
    Z_ref, F_ref = _numpy_repulsion(Y, valid, Y, valid, 0)
    assert np.isclose(float(Z), Z_ref, rtol=1e-5)
    np.testing.assert_allclose(F.numpy(), F_ref, rtol=1e-4, atol=1e-5)
    assert not F[200:].any()


def test_wrapper_refuses_other_devices():
    """No silent fallback: only CPU tensors take the plain version."""
    Y = torch.zeros((4, 2), device="meta")
    v = torch.zeros((4,), device="meta")
    with pytest.raises(ValueError):
        tsk.tsne_repulsion(Y, v)
    assert tsk.launch_counts() == {"tsne_repulsion": 0}
