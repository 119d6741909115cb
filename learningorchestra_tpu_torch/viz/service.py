"""Embedding-image service core: tsne/pca create + image CRUD.

The reference ships two near-identical microservices (tsne_image/,
pca_image/): validate (PNG not already on disk, parent exists, label ∈
fields), Spark-load, embed, save PNG to an images volume, and full CRUD
over the PNGs (server.py:57-155 in each). Here one service hosts both
methods; the embed runs on the device (viz/pca.py, viz/tsne.py) instead
of sklearn on one Spark node. ``embed_dataset`` is the compute alone, so
the embedding can be driven without a plotting library.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch.catalog.store import (
    DatasetStore, validate_name)
from learningorchestra_tpu_torch.config import (
    Settings, settings as global_settings)
from learningorchestra_tpu_torch.ops.preprocess import design_matrix
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import tracing
from learningorchestra_tpu_torch.viz.pca import pca_embed
from learningorchestra_tpu_torch.viz.plotting import save_scatter
from learningorchestra_tpu_torch.viz.tsne import tsne_embed


class ImageExists(ValueError):
    pass


class ImageNotFound(KeyError):
    pass


def embed_dataset(store: DatasetStore, runtime: DeviceRuntime, method: str,
                  parent: str, label: Optional[str] = None,
                  marker: Optional[str] = None,
                  **embed_kwargs) -> Tuple[np.ndarray,
                                           Optional[np.ndarray]]:
    """Embed ``parent``'s numeric matrix with tsne|pca. Returns the (n, 2)
    embedding and the label column (None without a label).

    Label-encoding of string columns before embedding matches the
    reference's LabelEncoder pass (tsne.py:82-86); the label column
    itself is not a feature.

    Multi-process pods dispatch the embed to every worker first — the
    reference ran tsne/pca's data load through the shared Spark tier
    (reference tsne.py:74-80), so a pod deployment must serve them too.
    The spec pins the row count and fitted preprocessing state so workers
    rebuild bit-identical design matrices from the shared store;
    ``marker`` names the output dataset the REST layer created, failed
    if a worker dies mid-embed."""
    from learningorchestra_tpu_torch.parallel import spmd

    parent_ds = store.get(parent)
    if label is not None and label not in parent_ds.metadata.fields:
        raise ValueError(f"label field not in dataset: {label}")
    if method not in ("pca", "tsne"):
        raise ValueError(f"unknown embedding method: {method}")
    attrs = {"parent": parent}
    with tracing.span("design.build", attrs):
        X, _, feature_fields, state = design_matrix(parent_ds,
                                                    label or "__none__")
        attrs["rows"] = int(len(X))
    with spmd.dispatch_job(store, (parent,), {
            "op": "embed", "method": method, "parent": parent,
            "label": label, "n_rows": int(len(X)),
            "state": spmd.jsonable_state(state),
            "feature_fields": list(feature_fields),
            "embed_kwargs": embed_kwargs},
            outputs=(marker,) if marker else ()):
        if method == "pca":
            emb = pca_embed(runtime, X)
        else:
            emb = tsne_embed(runtime, X, **embed_kwargs)
    labels = parent_ds.columns[label] if label is not None else None
    return emb, labels


def create_embedding_image(store: DatasetStore, runtime: DeviceRuntime,
                           method: str, parent: str, image_name: str,
                           label: Optional[str] = None,
                           image_root: Optional[str] = None,
                           marker: Optional[str] = None,
                           **embed_kwargs) -> str:
    """Embed ``parent``'s numeric matrix with tsne|pca and save the PNG.

    Synchronous core (the reference's POST also returns before the PNG
    exists and clients GET until 200). ``marker`` names the output the
    REST layer created first (``embed_dataset``); PNG rendering stays
    process-0 business."""
    cfg_root = image_root or global_settings.image_root
    emb, labels = embed_dataset(store, runtime, method, parent, label,
                                marker=marker, **embed_kwargs)
    path = os.path.join(cfg_root, method, f"{image_name}.png")
    return save_scatter(emb, path, labels=labels,
                        title=f"{method} of {parent}")


class ImageService:
    """CRUD over generated PNGs (reference tsne_image/server.py:57-155)."""

    def __init__(self, method: str, cfg: Optional[Settings] = None):
        self.method = method
        self.cfg = cfg or global_settings

    def _path(self, name: str) -> str:
        # Image names arrive from the REST API and become file paths.
        validate_name(name)
        return os.path.join(self.cfg.image_root, self.method, f"{name}.png")

    def exists(self, name: str) -> bool:
        return os.path.isfile(self._path(name))

    def validate_new(self, name: str) -> None:
        if self.exists(name):
            raise ImageExists(name)

    def get_path(self, name: str) -> str:
        p = self._path(name)
        if not os.path.isfile(p):
            raise ImageNotFound(name)
        return p

    def list_names(self) -> List[str]:
        root = os.path.join(self.cfg.image_root, self.method)
        if not os.path.isdir(root):
            return []
        return sorted(f[:-4] for f in os.listdir(root) if f.endswith(".png"))

    def delete(self, name: str) -> None:
        os.remove(self.get_path(name))
