"""The exploration ops — projection, type coercion, histogram — in both
packages on the same Titanic rows (tests/titanic_data.py).

Each package's catalog gets the rows in three appended chunks, so the
streamed ops walk several chunks. Results must be equal: these ops are
exact.
"""

import numpy as np
import pytest

from learningorchestra_tpu.catalog.store import DatasetStore as JaxStore
from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.ops import dtypes as jdt
from learningorchestra_tpu.ops import histogram as jh
from learningorchestra_tpu.ops import projection as jp
from learningorchestra_tpu.parallel.mesh import MeshRuntime
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.ops import dtypes as tdt
from learningorchestra_tpu_torch.ops import histogram as th
from learningorchestra_tpu_torch.ops import projection as tp
from tests.titanic_data import titanic_rows

FIELDS = ["Survived", "Pclass", "Sex", "Age", "Fare"]


def _columns(rows):
    """CSV-like columns: numbers as numbers, Age and text as strings."""
    return {f: (np.array([r[f] for r in rows], dtype=object)
                if isinstance(rows[0][f], str) else
                np.array([r[f] for r in rows]))
            for f in rows[0]}


@pytest.fixture()
def stores(tmp_path):
    cols = _columns(titanic_rows(scale=1.0, seed=7))
    out = {}
    for pkg, S, Store in (("jax", JaxSettings, JaxStore),
                          ("torch", Settings, DatasetStore)):
        cfg = S()
        cfg.store_root = str(tmp_path / pkg / "store")
        cfg.image_root = str(tmp_path / pkg / "images")
        # Commit after every chunk, so projection's commit path runs.
        cfg.ingest_commit_bytes = 0
        store = Store(cfg)
        ds = store.create("titanic")
        for lo in (0, 300, 600):
            ds.append_columns({f: c[lo:lo + 300] for f, c in cols.items()})
        store.finish("titanic")
        out[pkg] = store
    return out


def _assert_columns_equal(a, b):
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_projection_matches_jax(stores):
    jp.create_projection(stores["jax"], "titanic", "proj", FIELDS)
    tp.create_projection(stores["torch"], "titanic", "proj", FIELDS)
    ref, out = stores["jax"].get("proj"), stores["torch"].get("proj")
    assert out.metadata.finished
    assert out.metadata.fields == ref.metadata.fields == FIELDS
    assert out.metadata.to_doc()["parent_filename"] == "titanic"
    assert ref.metadata.to_doc()["parent_filename"] == "titanic"
    for f in FIELDS:
        _assert_columns_equal(out.columns[f], ref.columns[f])


def test_projection_refuses_missing_fields(stores):
    for mod, pkg in ((jp, "jax"), (tp, "torch")):
        with pytest.raises(ValueError,
                           match=r"fields not in dataset: \['x'\]"):
            mod.create_projection(stores[pkg], "titanic", "p2", ["Sex", "x"])


@pytest.mark.parametrize("steps", [
    [{"Age": "number"}, {"Age": "string"}, {"Age": "number"}],
    [{"Pclass": "string", "Fare": "string"},
     {"Pclass": "number", "Fare": "number"}],
    [{"Sex": "string", "Survived": "number"}],
], ids=["age", "pclass-fare", "identity"])
def test_convert_fields_matches_jax(stores, steps):
    """Each coercion leaves the two packages' columns equal; a round trip
    number → string → number gives back the original column."""
    before = {f: stores["torch"].get("titanic").columns[f] for f in FIELDS}
    for types in steps:
        jdt.convert_fields(stores["jax"], "titanic", types)
        tdt.convert_fields(stores["torch"], "titanic", types)
        for f in types:
            _assert_columns_equal(stores["torch"].get("titanic").columns[f],
                                  stores["jax"].get("titanic").columns[f])
    last = steps[-1]
    for f, t in last.items():
        if t == "number" and before[f].dtype != object:
            _assert_columns_equal(stores["torch"].get("titanic").columns[f],
                                  before[f])


@pytest.mark.parametrize("types,match", [
    ({"Sex": "bool"}, "invalid type 'bool'"),
    ({"nope": "number"}, "field not in dataset: nope"),
    ({"Sex": "number"}, "value not convertible to number: 'male'"),
])
def test_convert_fields_errors_match_jax(stores, types, match):
    errors = []
    for mod, pkg in ((jdt, "jax"), (tdt, "torch")):
        with pytest.raises(ValueError, match=match) as info:
            mod.convert_fields(stores[pkg], "titanic", types)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_histogram_matches_jax(stores):
    fields = ["Survived", "Pclass", "Sex", "Age", "Fare", "Embarked"]
    jh.create_histogram(stores["jax"], MeshRuntime(JaxSettings()),
                        "titanic", "hist", fields)
    th.create_histogram(stores["torch"], "titanic", "hist", fields)
    ref, out = stores["jax"].get("hist"), stores["torch"].get("hist")
    assert out.metadata.finished
    assert out.metadata.to_doc()["parent_filename"] == "titanic"
    assert out.num_rows == ref.num_rows == len(fields)
    assert list(out.columns["field"]) == list(ref.columns["field"]) == fields
    for a, b in zip(out.columns["counts"], ref.columns["counts"]):
        assert a == b
    # Integer columns take the bincount; every count is the column's own.
    surv = stores["torch"].get("titanic").columns["Survived"]
    assert out.columns["counts"][0] == {
        int(v): int(c) for v, c in enumerate(np.bincount(surv))}


def test_histogram_integer_ranges_and_empty():
    """bincount for a modest integer range, the value count past
    ``MAX_BINCOUNT_BINS``; both equal the JAX single-device branch."""
    wide = np.array([0, 1 << 20, 5, 5], dtype=np.int64)
    neg = np.array([-3, -3, 2, 7], dtype=np.int64)
    rt = MeshRuntime(JaxSettings())
    for col in (wide, neg, np.array([], dtype=np.int64)):
        assert th.field_counts(col) == jh.field_counts(rt, col)
    assert th.field_counts(neg) == {-3: 2, 2: 1, 7: 1}


def test_histogram_refuses_missing_fields(stores):
    with pytest.raises(ValueError, match="fields not in dataset"):
        th.create_histogram(stores["torch"], "titanic", "h2", ["x"])
