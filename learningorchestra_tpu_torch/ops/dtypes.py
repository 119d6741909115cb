"""Field-type coercion op (the reference's data_type_handler service).

The reference loops document-by-document doing a Mongo find/update per row,
converting between "number" and "string" with the rules: empty string →
None, numeric string → float, float → int when integral
(reference data_type_handler.py:40-82). Here the same rules run as one
pass per column — whole-column replacement instead of N round trips.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from learningorchestra_tpu_torch.catalog.dataset import stringify_numeric
from learningorchestra_tpu_torch.catalog.store import DatasetStore

VALID_TYPES = ("number", "string")


def _to_number(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind in "iuf":
        return col
    vals = np.empty(len(col), dtype=np.float64)
    any_nan = False
    for i, v in enumerate(col):
        if v is None or v == "":
            vals[i] = np.nan
            any_nan = True
        else:
            try:
                vals[i] = float(v)
            except (TypeError, ValueError):
                raise ValueError(f"value not convertible to number: {v!r}")
    if not any_nan and np.all(vals == np.floor(vals)):
        return vals.astype(np.int64)
    return vals


def _to_string(col: np.ndarray) -> np.ndarray:
    if col.dtype == object:
        return np.array([None if v is None else str(v) for v in col],
                        dtype=object)
    # Integral floats print as ints, NaN → None — the shared value-domain
    # rule (reference data_type_handler.py:63-70).
    return stringify_numeric(col)


def convert_fields(store: DatasetStore, name: str,
                   field_types: Dict[str, str]) -> None:
    """Coerce the given fields of a stored dataset in place (PATCH
    semantics, reference server.py:46-76)."""
    ds = store.get(name)
    for f, t in field_types.items():
        if t not in VALID_TYPES:
            raise ValueError(f"invalid type {t!r}; use one of {VALID_TYPES}")
        if f not in ds.metadata.fields:
            raise ValueError(f"field not in dataset: {f}")
    for f, t in field_types.items():
        col = ds.columns[f]
        ds.set_column(f, _to_number(col) if t == "number" else _to_string(col))
    if store.cfg.persist:
        store.save(name)
