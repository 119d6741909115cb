"""Scatter-plot PNG rendering for the embedding services.

Mirrors the reference's seaborn scatterplot with optional label hue and
``savefig`` to the images volume (reference tsne.py:90-102, pca.py:90-98).
Headless matplotlib (Agg backend). matplotlib and seaborn are imported
when a plot is drawn, so the package imports, and embeds, on a machine
that has neither.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_scatter(embedding: np.ndarray, path: str,
                 labels: Optional[np.ndarray] = None,
                 title: str = "") -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 8))
    hue = None
    if labels is not None:
        hue = np.asarray(labels).astype(str)
    sns.scatterplot(x=embedding[:, 0], y=embedding[:, 1], hue=hue,
                    s=12, linewidth=0, ax=ax,
                    palette="deep" if hue is not None else None)
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
