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


# ---------------------------------------------------------------------------
# The card's whole-embedding kernel (each unordered pair once), modelled
# in PyTorch
# ---------------------------------------------------------------------------

def _symmetric_repulsion(Y, valid, tile):
    """What csrc/tsne_kernels.cu's whole-embedding kernel computes, tile
    pair by tile pair: square tiles of ``tile`` rows (the last one ragged,
    its missing rows invalid); for tile pairs I < J every pair once, its
    q²·(y_i − y_j) added to row i and subtracted from row j and 2q to Z,
    q masked only where a tile holds an invalid row; diagonal tiles in the
    direct form over ordered pairs with the self pair masked; each row's
    slots then summed in slot order."""
    n = Y.shape[0]
    nt = -(-n // tile)
    pad = nt * tile - n
    Yp = torch.cat([Y, torch.zeros((pad, 2))])
    vp = torch.cat([valid, torch.zeros(pad)])
    part = torch.zeros((nt, nt, tile, 2))
    zparts = []
    for i in range(nt):
        yi, vi = Yp[i * tile:(i + 1) * tile], vp[i * tile:(i + 1) * tile]
        for j in range(i, nt):
            yj, vj = Yp[j * tile:(j + 1) * tile], vp[j * tile:(j + 1) * tile]
            dx = yi[:, 0:1] - yj[None, :, 0]
            dy = yi[:, 1:2] - yj[None, :, 1]
            q = 1.0 / (1.0 + dx * dx + dy * dy)
            if i == j:
                q = q * (vi[:, None] * vj[None, :])
                q.fill_diagonal_(0.0)
            elif not (bool((vi == 1).all()) and bool((vj == 1).all())):
                q = q * (vi[:, None] * vj[None, :])
            q2 = q * q
            part[i, j, :, 0] = (q2 * dx).sum(1)
            part[i, j, :, 1] = (q2 * dy).sum(1)
            if i != j:
                part[j, i, :, 0] = -(q2 * dx).sum(0)
                part[j, i, :, 1] = -(q2 * dy).sum(0)
            zparts.append(q.sum() * (1.0 if i == j else 2.0))
    F = part.sum(dim=1).reshape(nt * tile, 2)[:n]
    return torch.stack(zparts).sum(), F


def _scattered_invalid(n, seed):
    """Inputs with invalid rows scattered among the valid ones and parked
    at 0, as the descent parks them, plus a trailing invalid tail."""
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(n, 2)).astype(np.float32) * 3.0
    valid = (rng.random(n) >= 0.05).astype(np.float32)
    valid[-40:] = 0.0
    Y[valid == 0] = 0.0
    return Y, valid


@pytest.mark.parametrize("n,tile,scattered", [(640, 256, False),
                                              (640, 256, True),
                                              (384, 256, True),
                                              (512, 128, True)])
def test_symmetric_repulsion_matches_pallas(n, tile, scattered):
    """Tile pairs over the upper triangle, an n off the modelled tile
    (a ragged last tile) and invalid rows trailing or scattered at 0,
    against the Pallas kernel (tile 128) at this file's tolerances: Z
    rtol 1e-5; F rtol 1e-4, atol 1e-5."""
    Y, valid = (_scattered_invalid(n, seed=6) if scattered
                else _inputs(n, n - 100, seed=6))
    Z_ref, F_ref = pk.tsne_repulsion(jnp.asarray(Y), jnp.asarray(valid),
                                     tile=TILE)
    Z, F = _symmetric_repulsion(*_torch(Y, valid), tile)
    assert np.isclose(float(Z), float(Z_ref), rtol=1e-5)
    np.testing.assert_allclose(F.numpy(), np.asarray(F_ref), rtol=1e-4,
                               atol=1e-5)
    assert not F[torch.from_numpy(valid) == 0].any()


def test_symmetric_repulsion_matches_the_plain_version():
    """The model and the port's plain version (direct form) agree on a
    size no Pallas tile divides, two points sharing a parked coordinate
    included: invalid rows at the same place add nothing (Z rtol 1e-5;
    F rtol 1e-4, atol 1e-5)."""
    Y, valid = _scattered_invalid(300, seed=7)
    Z, F = _symmetric_repulsion(*_torch(Y, valid), 128)
    Z_ref, F_ref = tsk.tsne_repulsion_ref(*_torch(Y, valid))
    assert np.isclose(float(Z), float(Z_ref), rtol=1e-5)
    np.testing.assert_allclose(F.numpy(), F_ref.numpy(), rtol=1e-4,
                               atol=1e-5)
