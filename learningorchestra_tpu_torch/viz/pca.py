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

On a pod the rows are sharded over the data axis: each rank sums its
rows' float64 mean and Gram partials, one all-reduce each adds them (the
JAX package's psum), every rank takes the same eigenvectors, and the
projected rows are gathered (``DeviceRuntime.host_rows``).
"""

from __future__ import annotations

import numpy as np
import torch

from learningorchestra_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime


def _gram(X: torch.Tensor, n=None, valid=None, mesh=None):
    """(float64 mean (d,), float32 centred rows, float64 Gram / count
    (d, d)) of (rows, d) float32 X. On a pod X is this rank's rows:
    ``n`` counts all of them, ``valid`` (rows,) masks the padding and
    the float64 partials sum over ``mesh``'s data axis."""
    count = float(max(X.shape[0] if n is None else n, 1))
    Xm = X if valid is None else X * valid[:, None]
    s = Xm.sum(dim=0, dtype=torch.float64)
    if mesh is not None:
        all_reduce_(s, mesh, DATA_AXIS)
    mean = s / count
    Xc = X - mean.float()
    Xc64 = Xc.double() if valid is None else Xc.double() * valid[:, None]
    gram = Xc64.T @ Xc64
    del Xc64
    if mesh is not None:
        all_reduce_(gram, mesh, DATA_AXIS)
    return mean, Xc, gram / count


def _pca_project(X: torch.Tensor, *, k: int, n=None, valid=None,
                 mesh=None):
    """(rows, d) float32 rows → ((rows, k) float32 projection on the
    top-k components, (k,) their variances); the pod arguments as for
    ``_gram``."""
    _, Xc, cov = _gram(X, n, valid, mesh)
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
    X_dev, n = runtime.shard_rows(X)
    valid = runtime.valid_rows(n)
    emb, _ = _pca_project(X_dev, k=k, n=n, valid=valid,
                          mesh=None if valid is None else runtime.mesh)
    return runtime.host_rows(emb, n)
