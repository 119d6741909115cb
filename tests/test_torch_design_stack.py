"""The port's float32 design stack (``ops/preprocess._stack_design``):
byte for byte ``np.stack`` over every block split, width and column
dtype, an array that owns its data, the ``design.stack`` span's
``blocks``/``threads``, and the port's ``design_matrix`` against the JAX
package's, on the CPU."""

import os

import numpy as np
import pytest

from learningorchestra_tpu.catalog.store import DatasetStore as JaxStore
from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.ops import preprocess as jpreprocess
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.ops import preprocess
from learningorchestra_tpu_torch.utils import tracing

#: Tile bytes that make a block of 64 rows at d = 28.
TILE = 4 * 28 * 64
#: Blocks of fewer rows than this stay on the calling thread, in the tests.
THREAD_ROWS = 64


def _split(monkeypatch, tile=TILE):
    """Split every non-empty design into blocks of ``tile // (4 d)`` rows;
    threads from blocks of ``THREAD_ROWS`` rows up."""
    monkeypatch.setattr(preprocess, "_STACK_TILE_BYTES", tile)
    monkeypatch.setattr(preprocess, "_STACK_SPLIT_BYTES", 0)
    monkeypatch.setattr(preprocess, "_STACK_THREAD_ROWS", THREAD_ROWS)


@pytest.fixture
def small_blocks(monkeypatch):
    _split(monkeypatch)


def _threads(blocks, per):
    if per < THREAD_ROWS:
        return 1
    return min(blocks, preprocess._STACK_MAX_THREADS,
               len(os.sched_getaffinity(0)))


def _reference(cols):
    return np.stack([np.asarray(c, np.float32) for c in cols], axis=1)


def _stack_both(cols, rows):
    """The helper's (X, blocks, threads) and np.stack's array, both cast
    with float64 overflow to inf allowed."""
    with np.errstate(over="ignore"):
        got = preprocess._stack_design(cols, rows)
        want = _reference(cols) if cols else np.zeros((rows, 0), np.float32)
    return got, want


def _assert_same_bytes(X, want):
    assert X.dtype == np.float32 and X.shape == want.shape
    assert X.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()
    assert X.flags.c_contiguous and X.flags.owndata and X.flags.writeable


def _special(n, rng):
    """float32 with a non-default NaN payload, -0.0 and ±inf spread in."""
    c = rng.normal(size=n).astype(np.float32)
    bits = c.view(np.uint32)
    bits[::7] = 0x7FC12345                   # a quiet NaN, payload 0x12345
    bits[3::11] = 0xFFA00001                 # a signalling NaN, sign set
    c[1::13] = -0.0
    c[2::17] = np.inf
    c[5::19] = -np.inf
    return c


def _column(kind, n, rng):
    if kind == "f32":
        return _special(n, rng)
    if kind == "f64":
        # Values that round to float32, NaN, -0.0 and infinities.
        c = rng.normal(size=n) * 1e3 + 1e-9
        c[::5] = np.nan
        c[1::9] = -0.0
        c[2::23] = -np.inf
        c[4::29] = 3.4e39                    # past float32's range: +inf
        return c
    if kind == "i64":
        return rng.integers(-(1 << 40), 1 << 40, size=n)   # rounds to f32
    if kind == "u8":
        return rng.integers(0, 256, size=n).astype(np.uint8)
    if kind == "bool":
        return rng.random(n) < 0.5
    if kind == "f32_strided":
        return _special(3 * n, rng)[::3]     # a non-contiguous view
    if kind == "f64_strided":
        return np.asfortranarray(rng.normal(size=(n, 2)))[:, 1]
    raise AssertionError(kind)


KINDS = ["f32", "f64", "i64", "u8", "bool", "f32_strided", "f64_strided"]


# One block is 64 rows at d = 28 under ``small_blocks``.
@pytest.mark.parametrize("rows", [0, 1, 64, 65, 64 * 5 + 17])
@pytest.mark.parametrize("d", [0, 1, 28])
def test_blocks_match_np_stack(small_blocks, rows, d):
    rng = np.random.default_rng(rows * 31 + d)
    cols = [_column(KINDS[j % len(KINDS)], rows, rng) for j in range(d)]
    (X, blocks, threads), want = _stack_both(cols, rows)
    _assert_same_bytes(X, want)
    if d and rows:
        per = TILE // (4 * d)
        assert blocks == -(-rows // per)
        assert threads == _threads(blocks, per)
    else:
        assert (blocks, threads) == (1, 1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
def test_each_dtype_matches_np_stack(monkeypatch, kind, split):
    if split:
        _split(monkeypatch, tile=4 * 3 * 64)
    rng = np.random.default_rng(len(kind))
    rows = 1003
    cols = [_column(kind, rows, rng), _column("f32", rows, rng),
            _column(kind, rows, rng)]
    (X, blocks, _), want = _stack_both(cols, rows)
    _assert_same_bytes(X, want)
    assert blocks == (16 if split else 1)


@pytest.mark.parametrize("rows", [0, 1, 300])
def test_wide_rows_stay_on_the_calling_thread(small_blocks, rows):
    rng = np.random.default_rng(rows)
    cols = [_column(KINDS[j % len(KINDS)], rows, rng) for j in range(784)]
    (X, blocks, threads), want = _stack_both(cols, rows)
    _assert_same_bytes(X, want)
    # 784 columns: a block of TILE // 3136 = 2 rows, under THREAD_ROWS.
    assert (blocks, threads) == (max(1, -(-rows // 2)), 1)


def test_small_design_is_one_block_on_the_calling_thread():
    rng = np.random.default_rng(0)
    rows = 100_000                              # a 100k-row test design
    cols = [_column("f32", rows, rng) for _ in range(28)]
    (X, blocks, threads), want = _stack_both(cols, rows)
    _assert_same_bytes(X, want)
    assert (blocks, threads) == (1, 1)


def test_a_failing_column_raises_as_np_stack_does(small_blocks):
    rows = 500
    cols = [np.ones(rows, np.float32),
            np.array(["x"] * rows, dtype=object)]
    with pytest.raises(ValueError):
        _reference(cols)
    with pytest.raises(ValueError):
        preprocess._stack_design(cols, rows)
    for bad in ([np.ones(rows), np.ones(rows - 1)],
                [np.ones(rows), np.ones((rows, 2))]):
        with pytest.raises(ValueError):
            preprocess._stack_design(bad, rows)


@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
def test_the_callers_float_error_handling_holds_in_every_block(
        monkeypatch, split):
    if split:
        _split(monkeypatch, tile=4 * 2 * 64)
    c = np.ones(200)
    c[-1] = 1e300                               # overflows float32
    with np.errstate(over="raise"):
        with pytest.raises(FloatingPointError):
            _reference([c, c])
        with pytest.raises(FloatingPointError):
            preprocess._stack_design([c, c], 200)


def test_concurrent_stacks_share_the_threads(monkeypatch):
    """More callers than cores stack at once through the one pool, with
    a short switch interval: every result is its own np.stack."""
    import sys
    import threading

    _split(monkeypatch)
    rng = np.random.default_rng(3)
    inputs = [[_column("f32", 1500 + 7 * k, rng) for _ in range(28)]
              for k in range(12)]
    results = [None] * len(inputs)

    def run(k):
        for _ in range(5):
            results[k] = preprocess._stack_design(inputs[k], 0)[0]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        callers = [threading.Thread(target=run, args=(k,))
                   for k in range(len(inputs))]
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in callers)
    for k, cols in enumerate(inputs):
        _assert_same_bytes(results[k], _reference(cols))


def test_a_forked_child_starts_its_own_threads(monkeypatch):
    """The pool's threads do not survive a fork: a child that stacks a
    split design starts new ones instead of waiting on its parent's."""
    import time
    import warnings

    _split(monkeypatch)
    rng = np.random.default_rng(5)
    cols = [_column("f32", 2000, rng) for _ in range(28)]
    want = _reference(cols)
    assert preprocess._stack_design(cols, 0)[2] > 1 or len(
        os.sched_getaffinity(0)) == 1
    with warnings.catch_warnings():
        # Forking a process that runs threads warns; the child below
        # touches nothing but the stack.
        warnings.simplefilter("ignore", DeprecationWarning)
        pid = os.fork()
    if pid == 0:
        ok = False
        try:
            # The parent's pool records threads the child does not have.
            ok = preprocess._stack_pool is None
            X = preprocess._stack_design(cols, 0)[0]
            ok = ok and X.tobytes() == want.tobytes()
        finally:
            os._exit(0 if ok else 1)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        time.sleep(0.05)
    else:
        os.kill(pid, 9)
        os.waitpid(pid, 0)
        pytest.fail("the forked child's stack did not finish")
    assert os.waitstatus_to_exitcode(status) == 0


def _cfg(cls, root):
    cfg = cls()
    cfg.store_root = str(root / "store")
    cfg.image_root = str(root / "images")
    cfg.persist = False
    return cfg


def _mixed_columns(n, seed):
    """Floats with NaNs, a string column with Nones, ints, a bool, and an
    integer label."""
    rng = np.random.default_rng(seed)
    num = rng.normal(size=n)
    num[rng.random(n) < 0.1] = np.nan
    f32 = rng.normal(size=n).astype(np.float32)
    f32[rng.random(n) < 0.05] = np.nan
    cats = np.array(["a", "b", "c", None], dtype=object)
    return {"num": num, "f32": f32,
            "cat": cats[rng.integers(0, 4, size=n)],
            "intc": rng.integers(0, 9, size=n),
            "flag": rng.random(n) < 0.3,
            "label": rng.integers(0, 3, size=n).astype(np.int64)}


def _fill_columns(n, seed):
    """``_mixed_columns`` with NaN-free float32 and float64 columns (their
    fill fitted by one read), an all-NaN column and columns holding +inf
    and -inf (fitted the full way)."""
    rng = np.random.default_rng(seed)
    cols = _mixed_columns(n, seed)
    inf = rng.normal(size=n).astype(np.float32)
    inf[3] = np.inf
    ninf = rng.normal(size=n)
    ninf[n // 2] = -np.inf
    cols.update({"clean32": rng.normal(size=n).astype(np.float32),
                 "clean64": rng.normal(size=n) * 1e3,
                 "void": np.full(n, np.nan), "inf": inf, "ninf": ninf})
    return cols


@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
@pytest.mark.parametrize("steps", [
    (), [{"op": "label_encode"}, {"op": "fillna", "strategy": "mean"},
         {"op": "standardize"}]], ids=["default", "3step"])
def test_design_matrix_matches_the_jax_package(tmp_path, monkeypatch, split,
                                               steps):
    if split:
        # The stack in blocks on threads, and every float column, of
        # 10,000 bytes or more, fitted on the stack's threads.
        _split(monkeypatch)
        monkeypatch.setattr(preprocess.os, "sched_getaffinity",
                            lambda pid: set(range(4)))
    cols = _fill_columns(2500, 7)
    jstore = JaxStore(_cfg(JaxSettings, tmp_path / "j"))
    tstore = DatasetStore(_cfg(Settings, tmp_path / "t"))
    jstore.create("d", columns=dict(cols), finished=True)
    tstore.create("d", columns=dict(cols), finished=True)
    Xj, yj, ffj, sj = jpreprocess.design_matrix(jstore.get("d"), "label",
                                                steps)
    Xt, yt, fft, st = preprocess.design_matrix(tstore.get("d"), "label",
                                               steps)
    assert fft == ffj
    assert Xt.view(np.uint32).tobytes() == np.asarray(
        Xj, np.float32).view(np.uint32).tobytes()
    np.testing.assert_array_equal(yt, yj)
    assert st == sj
    assert Xt.flags.c_contiguous and Xt.flags.owndata


@pytest.mark.parametrize("split", [False, True], ids=["small", "large"])
def test_the_stack_span_counts_blocks_and_threads(tmp_path, monkeypatch,
                                                  split):
    if split:
        _split(monkeypatch)
    monkeypatch.setattr(preprocess.os, "sched_getaffinity",
                        lambda pid: set(range(4)))
    tracing.reset()
    tracing.set_capacity(1 << 12)
    store = DatasetStore(_cfg(Settings, tmp_path))
    store.create("d", columns=_mixed_columns(3000, 1), finished=True)
    try:
        with tracing.trace("design", sampled=True) as ctx:
            preprocess.design_matrix(store.get("d"), "label")
        stack = [d for d in tracing.spans_for(ctx.trace_id)
                 if d["name"] == "design.stack"]
    finally:
        tracing.reset()
        tracing.set_capacity(None)
    assert len(stack) == 1
    attrs = stack[0]["attrs"]
    assert attrs["rows"] == 3000 and attrs["cols"] == 5
    if split:
        # 5 columns: a block of TILE // 20 = 358 rows, 9 blocks on the
        # 4 cores the process may run on.
        assert attrs["blocks"] == 9 and attrs["threads"] == 4
    else:
        assert attrs["blocks"] == 1 and attrs["threads"] == 1
