"""Seeded stand-ins for the configurations' public data sets.

Both generators draw on the device they are given, from one
``torch.Generator`` seeded with the run's seed, in a few large calls,
and return host arrays for the catalog. The same seed on the same
device gives the same bits.

- ``higgs_like``: the UCI HIGGS shape (28 float features, a binary
  label) with a calibrated class structure, a torch copy of the
  repository's HIGGS-like workload generator: three mean-shift features
  (the linear signal), five bimodal features whose per-class mean and
  variance match class 0's N(0, 1) (seen by tree splits only), four
  correlation-sign pairs (seen only through feature interactions), and
  N(0, 1) noise for the rest.
- ``manifold_mix``: the MNIST training-set shape (784 features, 10
  classes), a torch copy of the repository's MNIST-like generator: each
  class a curved 10-D manifold embedded in 784 dimensions, plus noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

HIGGS_FEATURES = 28
_DELTA = 0.24
_MODE = 0.95
_RHO = 0.55
_SHIFT_FEATURES = (10, 11, 12)
_BIMODAL_FEATURES = tuple(range(13, 18))
_PAIR_FEATURES = tuple((20 + 2 * j, 21 + 2 * j) for j in range(4))


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def higgs_like(n: int, gen: torch.Generator, device) -> tuple:
    """(X float32 (n, 28), y int64 (n,)) on ``device``."""
    y = torch.randint(0, 2, (n,), generator=gen, device=device)
    pos = y == 1
    X = torch.randn((n, HIGGS_FEATURES), generator=gen, device=device)
    mode_sd = math.sqrt(1.0 - _MODE * _MODE)
    nb = len(_BIMODAL_FEATURES)
    sign = torch.randint(0, 2, (n, nb), generator=gen, device=device) * 2 - 1
    bim = _MODE * sign + mode_sd * torch.randn((n, nb), generator=gen,
                                               device=device)
    cols = list(_BIMODAL_FEATURES)
    X[:, cols] = torch.where(pos[:, None], bim, X[:, cols])
    resid = math.sqrt(1.0 - _RHO * _RHO)
    npair = len(_PAIR_FEATURES)
    z = torch.randn((n, npair), generator=gen, device=device)
    e = torch.randn((n, npair), generator=gen, device=device)
    r = torch.where(pos, _RHO, -_RHO)[:, None]
    X[:, [a for a, _ in _PAIR_FEATURES]] = z
    X[:, [b for _, b in _PAIR_FEATURES]] = r * z + resid * e
    shift = torch.where(pos, _DELTA, -_DELTA)[:, None]
    X[:, list(_SHIFT_FEATURES)] += shift
    return X, y


def higgs_columns(X: torch.Tensor, y: torch.Tensor) -> dict:
    """Catalog columns ``f0`` … ``f27`` (float32) and ``label`` (int64),
    copied to the host once."""
    XT = X.T.contiguous().cpu().numpy()
    cols = {f"f{i}": XT[i] for i in range(XT.shape[0])}
    cols["label"] = y.cpu().numpy().astype(np.int64)
    return cols


def manifold_mix(n: int, d: int, n_cls: int, gen: torch.Generator,
                 device) -> tuple:
    """(X float32 (n, d), classes int64 (n,)) on ``device``."""
    t = torch.randn((n, 10), generator=gen, device=device)
    cls = torch.randint(0, n_cls, (n,), generator=gen, device=device)
    A = torch.randn((n_cls, 10, d), generator=gen, device=device) * 0.8
    B = torch.randn((n_cls, 10, d), generator=gen, device=device) * 0.4
    off = torch.randn((n_cls, d), generator=gen, device=device) * 3.0
    X = torch.randn((n, d), generator=gen, device=device) * 0.2
    for c in range(n_cls):
        m = cls == c
        tm = t[m]
        X[m] += tm @ A[c] + torch.tanh(tm) @ B[c] + off[c]
    return X, cls


def feature_columns(X: torch.Tensor, y: torch.Tensor, prefix: str) -> dict:
    XT = X.T.contiguous().cpu().numpy()
    cols = {f"{prefix}{i}": XT[i] for i in range(XT.shape[0])}
    cols["label"] = y.cpu().numpy().astype(np.int64)
    return cols
