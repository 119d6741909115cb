"""Histogram service op: per-field value counts.

The reference's histogram microservice runs a Mongo aggregation
``[{"$group": {"_id": "$field", "count": {"$sum": 1}}}]`` per requested field
and stores the result as a new collection (reference histogram.py:49-74).

With one rank on the data axis the counts are host work: an integer
column with a modest value range is one ``np.bincount``, anything else
(floats, strings, huge integer ranges) a vectorized value count. This is
the JAX package's single-device branch, which measured a host↔device
round trip per chunk costing far more than the count itself. On a pod
(parallel/spmd.py) an integer column is counted on the device instead:
each rank bincounts its row shard exactly in int64 (``_mesh_bincount``)
and one all-reduce over the data axis sums the partial counts — the JAX
package's ``_mesh_bincount``, whose psum XLA lowers to an all-reduce.

Result dataset shape matches the reference: one row per field, carrying the
value→count mapping, with lineage ``parent_filename`` set.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from learningorchestra_tpu_torch.catalog.store import (
    DatasetStore, column_value_counts)
from learningorchestra_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_

#: Integer columns with more distinct levels than this go to the value
#: count instead of a bin vector.
MAX_BINCOUNT_BINS = 1 << 16


def _mesh_bincount(runtime, codes: torch.Tensor, n: int,
                   num_bins: int) -> np.ndarray:
    """Exact int64 bincount of this rank's row shard of ``codes`` (int,
    in [0, num_bins)), summed over the data axis. Padding rows (global
    row ≥ n) land in an overflow bin that is dropped after the sum."""
    valid = runtime.valid_rows(n)
    seg = codes.long()
    if valid is not None:
        seg = torch.where(valid > 0, seg, torch.full_like(seg, num_bins))
    local = torch.bincount(seg, minlength=num_bins + 1)
    all_reduce_(local, runtime.mesh, DATA_AXIS)
    return local[:num_bins].cpu().numpy()


def field_counts(col: np.ndarray, runtime=None) -> Dict:
    """Value→count dict for one column; on a pod's ``runtime`` an integer
    column with a modest value range is counted on the device
    (``_mesh_bincount``).

    The device/host decision depends only on the column's dtype and value
    range and on the mesh, so identical chunk data yields identical
    decisions on every rank of a pod — the property the SPMD histogram
    dispatch relies on."""
    if len(col) == 0:
        return {}
    if col.dtype.kind in "iu":
        lo, hi = int(col.min()), int(col.max())
        num_bins = hi - lo + 1
        if 0 < num_bins <= MAX_BINCOUNT_BINS:
            if runtime is None or runtime.data_shards()[0] == 1:
                counts = np.bincount((col - lo).astype(np.int64),
                                     minlength=num_bins)
            else:
                codes, n = runtime.shard_rows((col - lo).astype(np.int32))
                counts = _mesh_bincount(runtime, codes, n, num_bins)
            return {int(lo + i): int(c) for i, c in enumerate(counts) if c}
    # floats, strings, huge integer ranges
    return column_value_counts(col)


def merge_counts(total: Dict, part: Dict) -> None:
    """Accumulate one chunk's value→count map into the running total."""
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def histogram_totals(parent_ds, fields: List[str],
                     max_chunks: Optional[int] = None,
                     runtime=None) -> Dict[str, Dict]:
    """Per-field value→count maps, streamed one chunk at a time through the
    prefetching read pipeline (``iter_chunks``), so a dataset larger than
    host RAM is counted without being materialized.

    This is the device-op sequence shared verbatim by process 0 and SPMD
    workers (parallel/spmd.py ``prep_histogram_job``): per chunk, per
    field, one ``field_counts`` call. With ``max_chunks`` pinned to a
    journaled snapshot, every rank iterates identical chunk boundaries in
    identical order, so the collectives line up."""
    totals: Dict[str, Dict] = {f: {} for f in fields}
    for cols in parent_ds.iter_chunks(list(fields), max_chunks=max_chunks):
        for f in fields:
            merge_counts(totals[f], field_counts(cols[f], runtime))
    return totals


def create_histogram(store: DatasetStore, parent: str, name: str,
                     fields: List[str], existing: bool = False,
                     runtime=None) -> None:
    """Build the histogram dataset (sync core; run under JobManager).

    Multi-process pods dispatch the job to every worker first: the spec
    pins the parent's journaled chunk count so all ranks stream the same
    snapshot.

    ``existing=True`` means the API layer already created the output dataset
    (metadata-first protocol); otherwise it is created here.
    """
    from learningorchestra_tpu_torch.parallel import spmd

    parent_ds = store.get(parent)
    missing = [f for f in fields if f not in parent_ds.metadata.fields]
    if missing:
        raise ValueError(f"fields not in dataset: {missing}")
    ds = store.get(name) if existing else store.create(name, parent=parent)
    pin: Dict[str, int] = {}

    def make_spec():
        # Evaluated after dispatch_job's save: the journaled chunk count
        # is the snapshot every rank streams.
        pin["n_chunks"] = len(parent_ds.journal_files())
        return {"op": "histogram", "parent": parent,
                "fields": list(fields), "n_chunks": pin["n_chunks"]}

    with spmd.dispatch_job(store, (parent,), make_spec, outputs=(name,)):
        totals = histogram_totals(parent_ds, fields,
                                  max_chunks=pin.get("n_chunks"),
                                  runtime=runtime)
    ds.append_rows([{"field": f, "counts": totals[f]} for f in fields])
    store.finish(name)
