"""PCA embedding on the device.

The reference's pca microservice Spark-loads the collection then runs
``sklearn.decomposition.PCA(n_components=2)`` on one Spark node
(reference pca.py:74-98). Here the whole design matrix goes to the card
once; the d×d Gram matrix is one matrix product over it and the
eigendecomposition of that small matrix runs on the device, so
HIGGS-11M (11M × 28) costs one pass over the rows, not a collect onto
one node.

The Gram matrix is accumulated in float64: a float32 sum of squares over
11M rows rounds at every add, and the HIGGS-like columns have near-equal
variances, whose eigenvectors such an error rotates.
"""

from __future__ import annotations

import numpy as np
import torch

from learningorchestra_tpu_torch.parallel.runtime import (
    DeviceRuntime, host_rows)


def _pca_project(X: torch.Tensor, *, k: int):
    """(n, d) float32 rows → ((n, k) float32 projection on the top-k
    components, (k,) their variances). One device holds every row, so
    there is no padding to mask."""
    n = X.shape[0]
    count = float(max(n, 1))
    mean = X.sum(dim=0, dtype=torch.float64) / count
    Xc = X - mean.float()
    Xc64 = Xc.double()
    cov = (Xc64.T @ Xc64) / count
    del Xc64
    evals, evecs = torch.linalg.eigh(cov)          # ascending
    comps = evecs.flip(1)[:, :k].float()           # top-k components (d, k)
    var = evals.flip(0)[:k].float()
    return Xc @ comps, var


def pca_embed(runtime: DeviceRuntime, X: np.ndarray,
              k: int = 2) -> np.ndarray:
    """(n, d) host matrix → (n, k) principal-component embedding."""
    X = np.asarray(X, np.float32)
    if X.ndim != 2 or X.shape[1] < k:
        # Matches sklearn's n_components <= n_features contract (the
        # reference's PCA(2) likewise rejects 1-column data) but as a
        # clean client error instead of an IndexError mid-plot.
        raise ValueError(
            f"pca with {k} components needs at least {k} numeric feature "
            f"columns; dataset has {X.shape[1] if X.ndim == 2 else 0}")
    emb, _ = _pca_project(runtime.replicate(X), k=k)
    return host_rows(emb)
