"""fillna(mean)'s fit in the port (``ops/preprocess._one_read_means``):
each fill bit for bit ``float(np.nanmean(c))``, the columns, fitted state
and float warnings the JAX package's ``apply_steps`` gives, on the
calling thread and on the stack's threads, and the ``design.steps``
span's ``fill_one_read``/``fill_full``."""

import threading
import warnings

import numpy as np
import pytest

from learningorchestra_tpu.ops import preprocess as jpreprocess
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.ops import preprocess
from learningorchestra_tpu_torch.utils import tracing

MEAN = [{"op": "fillna", "strategy": "mean"}]


@pytest.fixture(params=["calling", "threads"])
def form(request, monkeypatch):
    """Fit on the calling thread, or on the stack's threads: every column
    of 8 bytes or more is long enough to thread, on 4 cores."""
    if request.param == "threads":
        monkeypatch.setattr(preprocess, "_STACK_TILE_BYTES", 8)
        monkeypatch.setattr(preprocess.os, "sched_getaffinity",
                            lambda pid: set(range(4)))
    return request.param


def _bits(x):
    return np.float64(x).tobytes()


def _fit_both(cols, steps=MEAN):
    """(port's cols, state, counts, warnings), (JAX's cols, state,
    warnings) for the same columns."""
    counts = {}
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tcols, tstate = preprocess.apply_steps(dict(cols), steps,
                                               counts=counts)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jcols, jstate = jpreprocess.apply_steps(dict(cols), steps)
    return ((tcols, tstate, counts, [str(w.message) for w in tw]),
            (jcols, jstate, [str(w.message) for w in jw]))


def _assert_same(cols, one_read):
    (tcols, tstate, counts, twarn), (jcols, jstate, jwarn) = _fit_both(cols)
    assert list(tstate) == list(jstate) == ["0:fillna"]
    tfill, jfill = tstate["0:fillna"], jstate["0:fillna"]
    assert list(tfill) == list(jfill)
    for f in tfill:
        assert _bits(tfill[f]) == _bits(jfill[f]), f
    assert list(tcols) == list(jcols)
    for f in tcols:
        assert tcols[f].dtype == jcols[f].dtype
        assert tcols[f].tobytes() == jcols[f].tobytes(), f
    assert twarn == jwarn
    floats = sum(c.dtype.kind == "f" for c in cols.values())
    assert counts == {"fill_one_read": one_read,
                      "fill_full": floats - one_read}
    return tfill


LENGTHS = [0, 1, 7, 8, 9, 127, 128, 129, 8191, 8193, 1 << 20]


@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_each_fill_is_nanmeans(dtype, n, offset):
    rng = np.random.default_rng(n * 8 + offset)
    base = (rng.normal(size=n + 8) * 10 ** rng.uniform(-3, 4)
            + rng.normal()).astype(dtype)
    c = base[offset:offset + n]
    fill = _assert_same({"c": c}, one_read=int(n > 0))
    if n:
        assert _bits(fill["c"]) == _bits(float(np.nanmean(c)))
    else:
        assert fill["c"] == 0.0


def _special(kind, rng):
    n = 1000
    c = rng.normal(size=n).astype(np.float32)
    if kind == "one_nan":
        c[417] = np.nan
    elif kind == "all_nan":
        c[:] = np.nan
    elif kind == "pos_inf":
        c[3] = np.inf
    elif kind == "neg_inf":
        c[900] = -np.inf
    elif kind == "both_inf":
        c[3], c[900] = np.inf, -np.inf
    elif kind == "overflow":
        c[:] = 3e38                           # each finite, the sum not
    elif kind == "float16":
        c = c.astype(np.float16)
    elif kind == "strided":
        c = rng.normal(size=3 * n).astype(np.float32)[::3]
    elif kind == "unaligned":
        raw = np.zeros(4 * n + 1, np.uint8)
        raw[1:] = c.view(np.uint8)
        c = np.frombuffer(raw.data, np.float32, count=n, offset=1)
        assert not c.flags.aligned
    elif kind == "float64_nan":
        c = c.astype(np.float64)
        c[::9] = np.nan
    else:
        raise AssertionError(kind)
    return c


SPECIAL = ["one_nan", "all_nan", "pos_inf", "neg_inf", "both_inf",
           "overflow", "float16", "strided", "unaligned", "float64_nan"]


@pytest.mark.parametrize("kind", SPECIAL)
def test_columns_one_read_cannot_settle_take_the_full_fit(form, kind):
    rng = np.random.default_rng(len(kind))
    c = _special(kind, rng)
    clean = rng.normal(size=len(c)).astype(np.float32)
    fill = _assert_same({"a": clean, "c": c, "b": clean[::-1].copy()},
                        one_read=2)
    assert _bits(fill["a"]) == _bits(float(np.nanmean(clean)))
    with np.errstate(all="ignore"):
        want = 0.0 if np.isnan(c).all() else float(np.nanmean(c))
    assert _bits(fill["c"]) == _bits(want)


def test_zero_and_value_fills_and_fitted_state_take_todays_code(form):
    rng = np.random.default_rng(2)
    c = rng.normal(size=500)
    c[::7] = np.nan
    cols = {"c": c, "d": rng.normal(size=500).astype(np.float32)}
    for steps in ([{"op": "fillna", "strategy": "zero"}],
                  [{"op": "fillna", "strategy": "value", "value": 2.5}]):
        counts = {}
        tcols, tstate = preprocess.apply_steps(cols, steps, counts=counts)
        jcols, jstate = jpreprocess.apply_steps(cols, steps)
        assert tstate == jstate
        assert all(tcols[f].tobytes() == jcols[f].tobytes() for f in cols)
        assert counts == {"fill_one_read": 0, "fill_full": 2}
    _, state = preprocess.apply_steps(cols, MEAN)
    test = {"c": np.full(9, np.nan), "d": np.ones(9, np.float32)}
    counts = {}
    tcols, tstate = preprocess.apply_steps(test, MEAN, state, counts=counts)
    jcols, jstate = jpreprocess.apply_steps(test, MEAN, state)
    assert tstate == jstate == state
    assert all(tcols[f].tobytes() == jcols[f].tobytes() for f in test)
    assert counts == {"fill_one_read": 0, "fill_full": 0}


def test_long_columns_are_read_on_the_stack_threads(monkeypatch):
    monkeypatch.setattr(preprocess, "_STACK_TILE_BYTES", 4000)
    monkeypatch.setattr(preprocess.os, "sched_getaffinity",
                        lambda pid: set(range(8)))
    seen = []
    inner = preprocess._one_read_means_of

    def spy(cs):
        seen.append((threading.current_thread().name, len(cs)))
        return inner(cs)

    monkeypatch.setattr(preprocess, "_one_read_means_of", spy)
    rng = np.random.default_rng(4)
    cols = {f"l{j}": rng.normal(size=1000).astype(np.float32)
            for j in range(6)}                          # 4,000 bytes each
    cols["short"] = rng.normal(size=999).astype(np.float32)
    _assert_same(cols, one_read=7)
    # Six long columns over at most 4 threads; the short one stays on the
    # calling thread and never reaches the pool.
    assert sorted(n for _, n in seen) == [1, 1, 2, 2]
    assert all(name.startswith("design-stack") for name, _ in seen)


def test_one_core_reads_on_the_calling_thread(monkeypatch):
    monkeypatch.setattr(preprocess, "_STACK_TILE_BYTES", 8)
    monkeypatch.setattr(preprocess.os, "sched_getaffinity",
                        lambda pid: {0})
    monkeypatch.setattr(preprocess, "_stack_executor", None)
    rng = np.random.default_rng(5)
    _assert_same({f"c{j}": rng.normal(size=300) for j in range(3)},
                 one_read=3)


@pytest.mark.parametrize("form_", ["calling", "threads"])
def test_the_callers_float_error_handling_holds_on_the_full_fit(
        monkeypatch, form_):
    if form_ == "threads":
        monkeypatch.setattr(preprocess, "_STACK_TILE_BYTES", 8)
        monkeypatch.setattr(preprocess.os, "sched_getaffinity",
                            lambda pid: set(range(4)))
    big = np.full(64, 3e38, np.float32)       # its float32 sum overflows
    cols = {"ok": np.ones(64, np.float32), "big": big,
            "ok2": np.arange(64, dtype=np.float32)}
    with np.errstate(over="raise"):
        with pytest.raises(FloatingPointError):
            jpreprocess.apply_steps(cols, MEAN)
        with pytest.raises(FloatingPointError):
            preprocess.apply_steps(cols, MEAN)
    with np.errstate(all="ignore"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _, state = preprocess.apply_steps(cols, MEAN)
    assert state["0:fillna"]["big"] == np.inf
    # Under NumPy's default handling, the one warning the full fit gives.
    _assert_same(cols, one_read=2)


def _cfg(root):
    cfg = Settings()
    cfg.store_root = str(root / "store")
    cfg.image_root = str(root / "images")
    cfg.persist = False
    return cfg


def test_the_steps_span_counts_each_fit(tmp_path, form):
    rng = np.random.default_rng(6)
    n = 2000
    holey = rng.normal(size=n)
    holey[::11] = np.nan
    cols = {"a": rng.normal(size=n).astype(np.float32),
            "b": rng.normal(size=n),
            "holey": holey, "void": np.full(n, np.nan),
            "inf": np.where(np.arange(n) == 5, np.inf,
                            rng.normal(size=n)).astype(np.float32),
            "cat": np.array(["x", "y"] * (n // 2), dtype=object),
            "ints": rng.integers(0, 9, size=n),
            "label": rng.integers(0, 2, size=n)}
    store = DatasetStore(_cfg(tmp_path))
    store.create("train", columns=dict(cols), finished=True)
    store.create("test", columns=dict(cols), finished=True)
    tracing.reset()
    tracing.set_capacity(1 << 12)
    try:
        with tracing.trace("design", sampled=True) as ctx:
            _, _, fields, state = preprocess.design_matrix(
                store.get("train"), "label")
            preprocess.design_matrix(store.get("test"), "label",
                                     state=state, feature_fields=fields)
        docs = [d for d in tracing.spans_for(ctx.trace_id)
                if d["name"] == "design.steps"]
    finally:
        tracing.reset()
        tracing.set_capacity(None)
    assert [(d["attrs"]["fill_one_read"], d["attrs"]["fill_full"])
            for d in docs] == [(2, 3), (0, 0)]
    assert docs[0]["attrs"]["rows"] == n
    assert docs[0]["attrs"]["steps"] == ["label_encode", "fillna"]
