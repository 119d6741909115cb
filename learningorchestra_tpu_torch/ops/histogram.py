"""Histogram service op: per-field value counts.

The reference's histogram microservice runs a Mongo aggregation
``[{"$group": {"_id": "$field", "count": {"$sum": 1}}}]`` per requested field
and stores the result as a new collection (reference histogram.py:49-74).

On one device the counts are host work: an integer column with a modest
value range is one ``np.bincount``, anything else (floats, strings, huge
integer ranges) a vectorized value count. This is the JAX package's
single-device branch, which measured a host↔device round trip per chunk
costing far more than the count itself. Its multi-device path — a
bincount per row shard, summed across devices — waits for the port's
multi-GPU runtime.

Result dataset shape matches the reference: one row per field, carrying the
value→count mapping, with lineage ``parent_filename`` set.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from learningorchestra_tpu_torch.catalog.store import (
    DatasetStore, column_value_counts)

#: Integer columns with more distinct levels than this go to the value
#: count instead of a bin vector.
MAX_BINCOUNT_BINS = 1 << 16


def field_counts(col: np.ndarray) -> Dict:
    """Value→count dict for one column."""
    if len(col) == 0:
        return {}
    if col.dtype.kind in "iu":
        lo, hi = int(col.min()), int(col.max())
        num_bins = hi - lo + 1
        if 0 < num_bins <= MAX_BINCOUNT_BINS:
            counts = np.bincount((col - lo).astype(np.int64),
                                 minlength=num_bins)
            return {int(lo + i): int(c) for i, c in enumerate(counts) if c}
    # floats, strings, huge integer ranges
    return column_value_counts(col)


def merge_counts(total: Dict, part: Dict) -> None:
    """Accumulate one chunk's value→count map into the running total."""
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def histogram_totals(parent_ds, fields: List[str]) -> Dict[str, Dict]:
    """Per-field value→count maps, streamed one chunk at a time through the
    prefetching read pipeline (``iter_chunks``), so a dataset larger than
    host RAM is counted without being materialized."""
    totals: Dict[str, Dict] = {f: {} for f in fields}
    for cols in parent_ds.iter_chunks(list(fields)):
        for f in fields:
            merge_counts(totals[f], field_counts(cols[f]))
    return totals


def create_histogram(store: DatasetStore, parent: str, name: str,
                     fields: List[str], existing: bool = False) -> None:
    """Build the histogram dataset (sync core; run under JobManager).

    ``existing=True`` means the API layer already created the output dataset
    (metadata-first protocol); otherwise it is created here.
    """
    parent_ds = store.get(parent)
    missing = [f for f in fields if f not in parent_ds.metadata.fields]
    if missing:
        raise ValueError(f"fields not in dataset: {missing}")
    ds = store.get(name) if existing else store.create(name, parent=parent)
    totals = histogram_totals(parent_ds, fields)
    ds.append_rows([{"field": f, "counts": totals[f]} for f in fields])
    store.finish(name)
