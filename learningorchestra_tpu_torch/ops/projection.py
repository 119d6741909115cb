"""Projection service op: column subset of a dataset into a new dataset.

The reference runs a Spark job — load collection, filter out the metadata
row, ``select(*fields)``, append-write to the output collection, then rewrite
metadata with ``finished=True`` (reference projection.py:104-125) — because
its rows live as BSON documents that must be physically rewritten.

Here columns are already independent arrays, so projection is a zero-copy
column gather *per chunk*: the output dataset references the parent's chunk
arrays directly (copy-on-write applies — type coercion replaces whole
columns, never mutates in place). Streaming with incremental commits keeps
projection working on datasets larger than host RAM (the parent's spilled
chunks load one at a time through the chunk read pipeline; the output
spills under the same budget). Commits batch by appended bytes
(``ingest_commit_bytes``) instead of fsyncing the journal once per chunk —
crash recovery still lands on a journaled prefix. The metadata-first /
finished-flip protocol and field validation (fields ⊆ parent.fields,
projection.py:141-167) are preserved exactly.
"""

from __future__ import annotations

from typing import List

from learningorchestra_tpu_torch.catalog.dataset import _arr_bytes
from learningorchestra_tpu_torch.catalog.store import DatasetStore


def create_projection(store: DatasetStore, parent: str, name: str,
                      fields: List[str], existing: bool = False) -> None:
    parent_ds = store.get(parent)
    missing = [f for f in fields if f not in parent_ds.metadata.fields]
    if missing:
        raise ValueError(f"fields not in dataset: {missing}")
    ds = store.get(name) if existing else store.create(name, parent=parent)
    commit_every = store.cfg.ingest_commit_bytes
    pending_bytes = 0
    for cols in parent_ds.iter_chunks(list(fields)):
        out = {f: cols[f] for f in fields}
        ds.append_columns(out)
        if store.cfg.persist:
            pending_bytes += sum(_arr_bytes(a) for a in out.values())
            if not commit_every or pending_bytes >= commit_every:
                store.save(name)
                pending_bytes = 0
    # Any tail under the commit threshold flushes with finish()'s save.
    store.finish(name)
