"""Preprocessing: declarative steps + the design-matrix builder.

The reference hands arbitrary user Python to ``exec()`` on the service
driver, expecting it to produce assembled Spark feature DataFrames
(reference model_builder.py:134-177) — full pyspark power, but arbitrary
code execution in the server (SURVEY.md §7 flags it as the design flaw to
supersede). Here the default path is a declarative, JSON-serializable step
list covering what the docs' Titanic walkthrough actually does
(drop columns, fill missing, encode strings, cast — docs/model_builder.md):

    steps = [{"op": "drop", "fields": ["Name"]},
             {"op": "fillna", "strategy": "mean"},
             {"op": "label_encode", "fields": ["Sex"]},
             {"op": "standardize"}]

``exec`` preprocessing survives behind ``settings.allow_exec_preprocessing``
(off by default): the code receives pandas DataFrames ``training_df`` /
``testing_df`` and must set ``features_training``, ``labels_training``,
``features_testing`` (numpy arrays) — the same names the reference's
contract expects its Spark DataFrames under (model_builder.py:145-150).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from learningorchestra_tpu_torch.catalog.dataset import Dataset
from learningorchestra_tpu_torch.utils import tracing


class PreprocessError(ValueError):
    pass


def _label_encode(col: np.ndarray, vocab: Optional[Dict] = None):
    """String column → int codes (sklearn LabelEncoder semantics, which the
    reference's tsne/pca services apply to every string column,
    tsne.py:82-86). None encodes as its own category."""
    keyed = np.array(["\0none" if v is None else str(v) for v in col])
    if vocab is None:
        uniq = np.unique(keyed)
        vocab = {v: i for i, v in enumerate(uniq)}
    codes = np.array([vocab.get(v, len(vocab)) for v in keyed],
                     dtype=np.int64)
    return codes, vocab


def apply_steps(columns: Dict[str, np.ndarray],
                steps: Sequence[Dict[str, Any]],
                state: Optional[Dict] = None) -> Tuple[Dict[str, np.ndarray],
                                                       Dict]:
    """Apply a step list. ``state`` carries fitted statistics (vocab, means)
    so the same pipeline applies identically to train and test datasets."""
    cols = dict(columns)
    state = dict(state or {})
    for i, step in enumerate(steps):
        op = step.get("op")
        key = f"{i}:{op}"
        fields = step.get("fields") or [
            f for f in cols
            if (cols[f].dtype == object) == (op in ("label_encode",))]
        if op == "select":
            cols = {f: cols[f] for f in step["fields"]}
        elif op == "drop":
            cols = {f: c for f, c in cols.items()
                    if f not in set(step["fields"])}
        elif op == "label_encode":
            vocabs = state.get(key, {})
            for f in fields:
                if cols[f].dtype != object:
                    continue
                codes, vocab = _label_encode(cols[f], vocabs.get(f))
                vocabs[f] = vocab
                cols[f] = codes
            state[key] = vocabs
        elif op == "fillna":
            strategy = step.get("strategy", "mean")
            fitted = key in state      # applying train-fitted stats to test
            fill = state.get(key, {})
            for f, c in cols.items():
                if c.dtype.kind != "f":
                    continue
                if not fitted and f not in fill:
                    # Fit the statistic for EVERY float column (even ones
                    # with no NaN here) so the test pass never computes its
                    # own — fit-on-train, apply-to-test.
                    if strategy == "mean":
                        fill[f] = (0.0 if np.isnan(c).all()
                                   else float(np.nanmean(c)))
                    elif strategy == "zero":
                        fill[f] = 0.0
                    elif strategy == "value":
                        fill[f] = step["value"]
                    else:
                        raise PreprocessError(
                            f"unknown fillna strategy {strategy!r}")
                if f in fill and np.isnan(c).any():
                    cols[f] = np.where(np.isnan(c), fill[f], c)
            state[key] = fill
        elif op == "cast":
            dtype = step.get("dtype", "float32")
            for f in step["fields"]:
                cols[f] = cols[f].astype(dtype)
        elif op == "standardize":
            stats = state.get(key)
            tgt = [f for f in cols if cols[f].dtype.kind in "if"]
            if stats is None:
                stats = {}
                for f in tgt:
                    c = cols[f].astype(np.float64)
                    finite = np.isfinite(c)
                    if finite.any():
                        mu = float(c[finite].mean())
                        sd = float(c[finite].std())
                    else:
                        # All-NaN column: identity stats instead of NaN
                        # stats, which would poison the whole design
                        # matrix (NaN is truthy, so `nanstd(c) or 1.0`
                        # kept the NaN — round-1 review finding).
                        mu, sd = 0.0, 1.0
                    if not np.isfinite(sd) or sd == 0.0:
                        sd = 1.0
                    stats[f] = (mu, sd)
            for f in tgt:
                if f in stats:
                    mu, sd = stats[f]
                    cols[f] = (cols[f].astype(np.float64) - mu) / (sd or 1.0)
            state[key] = stats
        else:
            raise PreprocessError(f"unknown preprocessing op: {op!r}")
    return cols, state


def design_matrix(ds: Dataset, label: str,
                  steps: Sequence[Dict[str, Any]] = (),
                  state: Optional[Dict] = None,
                  feature_fields: Optional[List[str]] = None):
    """Dataset → (X float32, y int32 or None, feature names, fitted state).

    Default pipeline when ``steps`` is empty: label-encode every string
    column, mean-fill NaNs — enough to train on raw ingested CSVs the way
    the docs' Titanic example preprocesses by hand.
    """
    cols = dict(ds.columns)
    rows = ds.num_rows
    y = None
    label_state_key = "__label_vocab__"
    state = dict(state or {})
    if not steps:
        steps = [{"op": "label_encode"}, {"op": "fillna", "strategy": "mean"}]
    with tracing.span("design.steps", rows=rows,
                      steps=[st.get("op") for st in steps]):
        if label in cols:
            lab = cols.pop(label)
            if lab.dtype == object:
                codes, vocab = _label_encode(lab, state.get(label_state_key))
                state[label_state_key] = vocab
                y = codes.astype(np.int32)
            else:
                y = np.asarray(lab)
                y = np.where(np.isnan(y.astype(np.float64)), -1, y).astype(
                    np.int32) if y.dtype.kind == "f" else y.astype(np.int32)
        cols, state = apply_steps(cols, steps, state)
    if feature_fields is None:
        feature_fields = [f for f in cols if cols[f].dtype.kind in "ifub"]
    attrs = {"rows": rows, "cols": len(feature_fields)}
    with tracing.span("design.stack", attrs):
        X, attrs["blocks"], attrs["threads"] = _stack_design(
            [cols[f] for f in feature_fields], rows)
    return X, y, feature_fields, state


# -- the float32 design stack ------------------------------------------------
#
# ``np.stack(columns, axis=1)`` writes the (rows, d) output one column at a
# time: d strided passes, 4 bytes every 4·d, each pass touching every cache
# line of the output, and the fresh output's pages faulted on one thread.
# ``_stack_design`` builds the same bytes a row block at a time: the block's
# columns are copied (and cast, by NumPy's own cast) into a contiguous
# (d, B) tile, and one transposed copy writes the tile into the block's
# output rows. Where each column's share of a block is long, the blocks
# are spread over a few threads, so the copies and the output's
# first-touch page faults run in parallel: NumPy releases the interpreter
# lock inside a copy, and a long copy keeps the lock from setting the pace.
# On an H100 host's 8 cores: 11M × 28 float32 columns, ``np.stack`` 4.30 s,
# this 0.44 s (147 blocks on 4 threads; 8 threads were no faster);
# 60,000 × 784, ``np.stack`` 0.33 s, this 0.19 s (23 blocks of 2,674 rows
# on the calling thread: on 4–8 threads, copies of a few KB, where the
# lock does set the pace, took 0.20–0.81 s).

#: Bytes of one block's (d, B) staging tile.
_STACK_TILE_BYTES = 1 << 23
#: Designs of at most this many bytes are one block on the calling thread.
_STACK_SPLIT_BYTES = 1 << 26
#: Blocks of fewer rows (wide rows) stay on the calling thread.
_STACK_THREAD_ROWS = 1 << 14
#: The most threads one stack uses.
_STACK_MAX_THREADS = 4

_stack_pool: Optional[ThreadPoolExecutor] = None
_stack_pool_lock = threading.Lock()


def _stack_executor() -> ThreadPoolExecutor:
    """The module's stack threads, started on first use, never at
    import."""
    global _stack_pool
    with _stack_pool_lock:
        if _stack_pool is None:
            _stack_pool = ThreadPoolExecutor(
                max_workers=_STACK_MAX_THREADS,
                thread_name_prefix="design-stack")
        return _stack_pool


def _forget_stack_pool() -> None:
    """A forked child has none of its parent's threads: it starts its own
    on first use."""
    global _stack_pool, _stack_pool_lock
    _stack_pool, _stack_pool_lock = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_stack_pool)


def _stack_blocks(cols: List[np.ndarray], out: np.ndarray,
                  starts: Sequence[int], block: int,
                  err: Dict[str, str]) -> None:
    """Fill ``out``'s rows ``[s, s + block)`` for each ``s`` in ``starts``
    through one (d, block) staging tile, casting under the caller's
    floating-point error handling ``err`` (``np.errstate`` is per
    thread)."""
    n, d = out.shape
    buf = np.empty(d * block, np.float32)
    with np.errstate(**err):
        for r0 in starts:
            r1 = min(n, r0 + block)
            tile = buf[:d * (r1 - r0)].reshape(d, r1 - r0)
            for j, c in enumerate(cols):
                tile[j] = c[r0:r1]
            out[r0:r1] = tile.T


def _stack_design(columns: Sequence[Any],
                  rows: int) -> Tuple[np.ndarray, int, int]:
    """``(X, blocks, threads)``: X is byte for byte
    ``np.stack([np.asarray(c, np.float32) for c in columns], axis=1)``
    (``(rows, 0)`` zeros without columns), C-contiguous, writable and
    owning its data. The form follows from the shape and the cores
    alone: a design of at most ``_STACK_SPLIT_BYTES`` is one block on the
    calling thread; a larger one is split into blocks of
    ``_STACK_TILE_BYTES`` of tile, spread over as many threads as the
    process may run on, at most ``_STACK_MAX_THREADS``, where a block
    holds at least ``_STACK_THREAD_ROWS`` rows, else done on the calling
    thread."""
    if not columns:
        return np.zeros((rows, 0), np.float32), 1, 1
    cols = [np.asarray(c) for c in columns]
    n, d = len(cols[0]), len(cols)
    if any(c.shape != (n,) for c in cols):
        raise ValueError("design columns must be 1-D and of one length")
    out = np.empty((n, d), np.float32)
    err = np.geterr()
    if n * d * 4 <= _STACK_SPLIT_BYTES:
        _stack_blocks(cols, out, (0,), max(n, 1), err)
        return out, 1, 1
    block = max(1, _STACK_TILE_BYTES // (4 * d))
    starts = range(0, n, block)
    threads = 1 if block < _STACK_THREAD_ROWS else min(
        _STACK_MAX_THREADS, len(os.sched_getaffinity(0)), len(starts))
    if threads == 1:
        _stack_blocks(cols, out, starts, block, err)
    else:
        # Thread t takes blocks t, t + threads, ...: neighbours in turn,
        # so the threads finish together.
        pool = _stack_executor()
        for fut in [pool.submit(_stack_blocks, cols, out,
                                starts[t::threads], block, err)
                    for t in range(threads)]:
            fut.result()
    return out, len(starts), threads


# -- shard-local streamed design path ----------------------------------------
#
# The resident ``design_matrix`` consolidates the full dataset in host RAM
# before sharding — on a pod that multiplies host-RAM cost by process count,
# where the reference's executors each hold only their partitions
# (model_builder.py:200). The streamed path splits the work:
#
#   1. ``_fit_design_state`` — fit every statistic the pipeline needs
#      (label vocab, label-encode vocabs, fillna means, standardize stats)
#      with STREAMING passes over the pinned snapshot. Passes are FUSED:
#      consecutive fitting steps whose statistics do not read a prior
#      fitting step's *output* share one pass (see ``_fusion_groups``), and standardize fits in a single pass via
#      per-block two-pass moments merged with Chan's parallel update —
#      so the default label_encode+fillna+standardize pipeline costs 2
#      dataset scans where the step-at-a-time fit cost ~5. The label
#      vocab (read from the raw label column, which no step ever sees)
#      folds into the first pass. The unfused step-at-a-time fit is kept
#      as ``_fit_design_state_unfused`` — the semantics oracle the fused
#      path is regression-tested against.
#   2. ``ChunkedDesign`` — once fitted, every step is row-local, so any
#      row range of the design matrix can be materialized independently.
#      The mesh runtime builds each device shard from exactly its own row
#      range (``mesh.shard_chunked``), so per-process peak host memory is
#      O(local shard + one read block), never O(dataset).

_DEFAULT_STEPS = ({"op": "label_encode"}, {"op": "fillna", "strategy": "mean"})

#: Row-block size for streamed fitting passes; bounds per-pass host memory.
_FIT_BLOCK_ROWS = 1 << 18


def _iter_blocks(snap, n_rows: int, fields=None):
    """Stream the pinned row prefix ``[0, n_rows)`` in bounded blocks over
    ONE chunk snapshot (``Dataset.snapshot``/``pin_snapshot`` reader) with
    consolidation's unified dtypes. Reading every fitting pass through the
    same snapshot is what makes a concurrent ``set_column`` rewrite
    invisible to an in-flight streamed build — each pass would otherwise
    open its own chunk view and could mix pre-/post-rewrite rows."""
    got = 0
    if n_rows <= 0:
        return
    for _off, k, cols in snap.scan(fields, block_rows=_FIT_BLOCK_ROWS):
        if got + k > n_rows:
            take = n_rows - got
            cols = {f: a[:take] for f, a in cols.items()}
            k = take
        if k:
            yield cols
        got += k
        if got >= n_rows:
            return


def _apply_prefix_blocks(snap, n_rows: int, label: str,
                         prefix_steps, state):
    """Stream blocks with the (already fully fitted) step prefix applied —
    what the next fitting step's statistics are computed over."""
    for cols in _iter_blocks(snap, n_rows):
        cols.pop(label, None)
        out, _ = apply_steps(cols, prefix_steps, state)
        yield out


def _encode_label_block(lab: np.ndarray, state: Dict) -> np.ndarray:
    """One block of the label column → int32 codes, mirroring the resident
    ``design_matrix`` label handling exactly (vocab must be pre-fitted)."""
    if lab.dtype == object:
        codes, _ = _label_encode(lab, state["__label_vocab__"])
        return codes.astype(np.int32)
    y = np.asarray(lab)
    if y.dtype.kind == "f":
        return np.where(np.isnan(y.astype(np.float64)), -1, y).astype(
            np.int32)
    return y.astype(np.int32)


def _fit_label_vocab(snap, label: str, n_rows: int) -> Dict[str, int]:
    """Streaming label-vocab fit: sorted distinct keyed values — exactly
    ``_label_encode``'s np.unique order over the full column."""
    uniq: set = set()
    for cols in _iter_blocks(snap, n_rows, [label]):
        uniq.update("\0none" if v is None else str(v) for v in cols[label])
    return {v: i for i, v in enumerate(sorted(uniq))}


def _fit_design_state_unfused(snap, fields, label: str, steps,
                              n_rows: int) -> Dict:
    """Step-at-a-time streaming fit — one pass per fitting step (plus two
    for standardize, plus one for the label vocab). Superseded by the
    fused :func:`_fit_design_state` for the live path; kept as the
    semantics oracle its regression tests compare against.

    Semantics match the resident fit per step: label vocab = sorted
    distinct keyed values (np.unique's order), fillna means = nanmean,
    standardize = two-pass mean/Σ(x−μ)² over finite values (the same
    two-pass form the resident path uses — the one-pass E[x²]−E[x]² form
    catastrophically cancels, see models/logistic._device_stats)."""
    state: Dict[str, Any] = {}
    if label in fields and n_rows:
        probe = snap.read([label], 0, 1)[label]
        if probe.dtype == object:
            state["__label_vocab__"] = _fit_label_vocab(snap, label, n_rows)
    for i, step in enumerate(steps):
        op = step.get("op")
        key = f"{i}:{op}"
        prefix = steps[:i]
        if op == "label_encode":
            want = set(step.get("fields") or ())
            vocab_sets: Dict[str, set] = {}
            for cols in _apply_prefix_blocks(snap, n_rows, label, prefix,
                                             state):
                for f, c in cols.items():
                    if c.dtype == object and (not want or f in want):
                        vocab_sets.setdefault(f, set()).update(
                            "\0none" if v is None else str(v) for v in c)
            state[key] = {f: {v: j for j, v in enumerate(sorted(s))}
                          for f, s in vocab_sets.items()}
        elif op == "fillna":
            strategy = step.get("strategy", "mean")
            if strategy == "mean":
                sums: Dict[str, float] = {}
                cnts: Dict[str, int] = {}
                for cols in _apply_prefix_blocks(snap, n_rows, label, prefix,
                                                 state):
                    for f, c in cols.items():
                        if c.dtype.kind != "f":
                            continue
                        m = ~np.isnan(c)
                        sums[f] = sums.get(f, 0.0) + float(
                            c[m].sum(dtype=np.float64))
                        cnts[f] = cnts.get(f, 0) + int(m.sum())
                state[key] = {f: (sums[f] / cnts[f] if cnts[f] else 0.0)
                              for f in sums}
            elif strategy in ("zero", "value"):
                val = 0.0 if strategy == "zero" else step["value"]
                fill = {}
                for cols in _apply_prefix_blocks(snap, n_rows, label, prefix,
                                                 state):
                    fill.update({f: val for f, c in cols.items()
                                 if c.dtype.kind == "f" and f not in fill})
                    break       # dtypes are globally unified; one block
                state[key] = fill
            else:
                raise PreprocessError(
                    f"unknown fillna strategy {strategy!r}")
        elif op == "standardize":
            sums, cnts = {}, {}
            for cols in _apply_prefix_blocks(snap, n_rows, label, prefix,
                                             state):
                for f, c in cols.items():
                    if c.dtype.kind not in "if":
                        continue
                    c64 = c.astype(np.float64)
                    fin = np.isfinite(c64)
                    sums[f] = sums.get(f, 0.0) + float(c64[fin].sum())
                    cnts[f] = cnts.get(f, 0) + int(fin.sum())
            mus = {f: (sums[f] / cnts[f] if cnts[f] else 0.0) for f in sums}
            sq = {f: 0.0 for f in sums}
            for cols in _apply_prefix_blocks(snap, n_rows, label, prefix,
                                             state):
                for f, c in cols.items():
                    if f not in sq:
                        continue
                    c64 = c.astype(np.float64)
                    fin = np.isfinite(c64)
                    d = c64[fin] - mus[f]
                    sq[f] += float((d * d).sum())
            stats = {}
            for f in sums:
                if cnts[f]:
                    mu = mus[f]
                    sd = float(np.sqrt(sq[f] / cnts[f]))
                else:
                    mu, sd = 0.0, 1.0
                if not np.isfinite(sd) or sd == 0.0:
                    sd = 1.0
                stats[f] = (mu, sd)
            state[key] = stats
        # select / drop / cast fit nothing
    return state


#: Ops whose fit reads data (everything else — select/drop/cast — fits
#: nothing but changes column structure/dtypes, so it is a conservative
#: fusion BARRIER: a fitting step never shares a pass across one).
_FITTING_OPS = ("label_encode", "fillna", "standardize")

#: ``_AFFECTS[a]`` = later fitting ops whose *statistics read values op a
#: changes* — the dependency that forbids sharing a streaming pass:
#: - label_encode turns object columns into int64 codes: a later
#:   standardize includes those new int columns in its stats; a later
#:   default-fields label_encode would no longer see them as objects.
#: - fillna rewrites float values (NaN → fill): standardize's moments and
#:   a later fillna's nanmean read them.
#: - standardize rewrites every numeric column (and promotes int →
#:   float64, which a later fillna would then see).
#: Everything NOT listed is independent by dtype partition: label_encode
#: reads only object columns, which fillna/standardize never touch.
_AFFECTS = {
    "label_encode": {"label_encode", "standardize"},
    "fillna": {"fillna", "standardize"},
    "standardize": {"fillna", "standardize"},
}


def _fusion_groups(steps) -> List[List[int]]:
    """Partition the fitting-step indices into maximal groups that share
    one streaming pass: a step joins the current group unless a step
    already in it affects this step's stat inputs (``_AFFECTS``), and
    non-fitting steps close the group (structure/dtype barriers). The
    default [label_encode, fillna, standardize] pipeline yields
    [[0, 1], [2]] — two passes."""
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_ops: set = set()
    for i, step in enumerate(steps):
        op = step.get("op")
        if op not in _FITTING_OPS:
            if cur:
                groups.append(cur)
                cur, cur_ops = [], set()
            continue
        if cur and any(op in _AFFECTS[o] for o in cur_ops):
            groups.append(cur)
            cur, cur_ops = [], set()
        cur.append(i)
        cur_ops.add(op)
    if cur:
        groups.append(cur)
    return groups


class _VocabAcc:
    """label_encode: per-field sorted distinct keyed values."""

    def __init__(self, step):
        self.want = set(step.get("fields") or ())
        self.sets: Dict[str, set] = {}

    def update(self, cols) -> None:
        for f, c in cols.items():
            if c.dtype == object and (not self.want or f in self.want):
                self.sets.setdefault(f, set()).update(
                    "\0none" if v is None else str(v) for v in c)

    def finalize(self):
        return {f: {v: j for j, v in enumerate(sorted(s))}
                for f, s in self.sets.items()}


class _FillMeanAcc:
    """fillna(mean): streaming nanmean per float column."""

    def __init__(self, step):
        self.sums: Dict[str, float] = {}
        self.cnts: Dict[str, int] = {}

    def update(self, cols) -> None:
        for f, c in cols.items():
            if c.dtype.kind != "f":
                continue
            m = ~np.isnan(c)
            self.sums[f] = self.sums.get(f, 0.0) + float(
                c[m].sum(dtype=np.float64))
            self.cnts[f] = self.cnts.get(f, 0) + int(m.sum())

    def finalize(self):
        return {f: (self.sums[f] / self.cnts[f] if self.cnts[f] else 0.0)
                for f in self.sums}


class _FillConstAcc:
    """fillna(zero|value): constant per float column — dtypes are
    globally unified, so the first block names every float column."""

    def __init__(self, step):
        strategy = step.get("strategy")
        self.val = 0.0 if strategy == "zero" else step["value"]
        self.fill: Dict[str, Any] = {}
        self._done = False

    def update(self, cols) -> None:
        if self._done:
            return
        self.fill.update({f: self.val for f, c in cols.items()
                          if c.dtype.kind == "f" and f not in self.fill})
        self._done = True

    def finalize(self):
        return self.fill


class _StdAcc:
    """standardize in ONE pass: per block, exact two-pass moments over
    its in-memory rows; blocks merge with Chan's parallel update
    (numerically stable — never forms E[x²]−E[x]², which catastrophically
    cancels; see models/logistic._device_stats). Agrees with the two-pass
    global fit to fp-accumulation order."""

    def __init__(self, step):
        self.stats: Dict[str, tuple] = {}   # f -> (count, mean, M2)

    def update(self, cols) -> None:
        for f, c in cols.items():
            if c.dtype.kind not in "if":
                continue
            na, ma, m2a = self.stats.get(f, (0, 0.0, 0.0))
            c64 = c.astype(np.float64)
            fin = np.isfinite(c64)
            nb = int(fin.sum())
            if nb == 0:
                self.stats.setdefault(f, (na, ma, m2a))
                continue
            v = c64[fin]
            mb = float(v.mean())
            db = v - mb
            m2b = float((db * db).sum())
            n = na + nb
            delta = mb - ma
            self.stats[f] = (n, ma + delta * nb / n,
                             m2a + m2b + delta * delta * na * nb / n)

    def finalize(self):
        out = {}
        for f, (n, mu, m2) in self.stats.items():
            if n:
                sd = float(np.sqrt(m2 / n))
            else:
                mu, sd = 0.0, 1.0
            if not np.isfinite(sd) or sd == 0.0:
                sd = 1.0
            out[f] = (mu, sd)
        return out


def _make_acc(step):
    op = step.get("op")
    if op == "label_encode":
        return _VocabAcc(step)
    if op == "fillna":
        strategy = step.get("strategy", "mean")
        if strategy == "mean":
            return _FillMeanAcc(step)
        if strategy in ("zero", "value"):
            return _FillConstAcc(step)
        raise PreprocessError(f"unknown fillna strategy {strategy!r}")
    if op == "standardize":
        return _StdAcc(step)
    raise PreprocessError(f"op {op!r} fits nothing")  # unreachable


def _design_ckpt_payload(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Fitted-state dict → the checkpoint store's array payload (JSON
    bytes as uint8 — the store is npz-shaped). Tuples round-trip as
    lists, which ``apply_steps`` unpacks identically."""
    import json as _json

    blob = _json.dumps(state).encode("utf-8")
    return {"state": np.frombuffer(blob, dtype=np.uint8)}


def _design_ckpt_state(arrays) -> Optional[Dict[str, Any]]:
    import json as _json

    try:
        return _json.loads(arrays["state"].tobytes().decode("utf-8"))
    except (KeyError, ValueError, UnicodeDecodeError):
        return None


def _fit_design_state(snap, fields, label: str, steps, n_rows: int,
                      profile: Optional[Dict] = None,
                      ckpt=None) -> Dict:
    """Fused streaming fit over ONE pinned chunk snapshot; returns the
    fitted state (same contract and — to fp-accumulation order — same
    values as :func:`_fit_design_state_unfused`).

    Independent fitting steps share a pass (``_fusion_groups``); each
    group streams blocks with the group's fully-fitted step prefix
    applied and feeds every member's accumulator from the same block.
    The label vocab (raw label column — no step ever sees it) rides the
    first pass. ``profile``, when given, receives ``fit_passes`` — the
    number of full dataset scans the fit cost, also recorded on
    ``op_timer`` as ``streamed_fit.passes`` — plus ``fit_cache_hits`` /
    ``fit_cache_misses``, the chunk-cache traffic of those scans: the
    scans run through the prefetching read pipeline, so on a spilled
    dataset pass 2+ should be (nearly) all hits and *physical* disk
    reads stay at ~1 scan regardless of the pass count."""
    from learningorchestra_tpu_torch.catalog import readpipe
    from learningorchestra_tpu_torch.utils.profiling import op_timer

    rp0 = readpipe.snapshot()
    state: Dict[str, Any] = {}
    need_vocab = False
    if label in fields and n_rows:
        probe = snap.read([label], 0, 1)[label]
        need_vocab = probe.dtype == object
    label_uniq: set = set()
    groups = _fusion_groups(steps)
    done_groups = 0
    if ckpt is not None and ckpt.enabled:
        # Pass-boundary checkpoints (LO_TPU_FIT_CKPT_ROUNDS > 0): the
        # partial fitted state persists after each fusion group's scan,
        # keyed on the pinned snapshot's row count — every pass of one
        # fit (and of its resume) reads the same pinned rows, so the
        # resumed state is exactly what the interrupted fit had.
        ckpt.snapshot = f"rows={n_rows}"
        loaded = ckpt.load()
        if loaded is not None:
            g_done, arrays, cmeta = loaded
            blob = _design_ckpt_state(arrays)
            if blob is not None and 0 < g_done <= len(groups):
                state = blob
                done_groups = g_done
                if "__label_vocab__" in state:
                    need_vocab = False
                from learningorchestra_tpu_torch import jobs
                from learningorchestra_tpu_torch.utils import fitckpt

                fitckpt.count_resume()
                jobs.record_job_resume(ckpt.family, {
                    "passes": int(g_done),
                    "of": len(groups) + (1 if need_vocab else 0),
                    "mesh_epoch": cmeta.get("mesh_epoch")})
            else:
                ckpt.clear()
    passes = 0
    for gi, group in enumerate(groups):
        if gi < done_groups:
            continue                       # resumed past this pass
        prefix = steps[:group[0]]
        accs = {i: _make_acc(steps[i]) for i in group}
        take_label = need_vocab and gi == 0
        passes += 1
        for cols in _iter_blocks(snap, n_rows):
            lab = cols.pop(label, None)
            if take_label and lab is not None:
                label_uniq.update(
                    "\0none" if v is None else str(v) for v in lab)
            out, _ = apply_steps(cols, prefix, state)
            for acc in accs.values():
                acc.update(out)
        for i, acc in accs.items():
            state[f"{i}:{steps[i].get('op')}"] = acc.finalize()
        if take_label:
            state["__label_vocab__"] = {
                v: j for j, v in enumerate(sorted(label_uniq))}
            need_vocab = False
        if ckpt is not None and ckpt.enabled:
            from learningorchestra_tpu_torch import jobs

            jobs.heartbeat()
            if gi + 1 < len(groups) or need_vocab:
                ckpt.save(gi + 1, _design_ckpt_payload(state))
    if need_vocab:
        # No fitting step to ride along with: one label-column scan.
        passes += 1
        state["__label_vocab__"] = _fit_label_vocab(snap, label, n_rows)
    op_timer.record("streamed_fit.passes", float(passes))
    if profile is not None:
        profile["fit_passes"] = passes
        rp1 = readpipe.snapshot()
        profile["fit_cache_hits"] = rp1["cache_hits"] - rp0["cache_hits"]
        profile["fit_cache_misses"] = (rp1["cache_misses"]
                                       - rp0["cache_misses"])
    return state


class ChunkedDesign:
    """Lazily-materialized (n, d) float32 design matrix over the chunk
    store — quacks enough like an ndarray (shape/len/dtype) for the
    trainer surface while materializing rows only on demand.

    ``rows(start, stop)`` reads just the chunks overlapping the range and
    applies the FITTED pipeline, which is row-local by construction.
    ``MeshRuntime.shard_rows`` recognizes this type and builds each device
    shard from exactly its own row range, so a pod process's peak host
    memory is its local shard — the reference's executor data residency
    (model_builder.py:200) rather than N copies of the full matrix. Treat
    as immutable: it holds ONE pinned chunk snapshot
    (``Dataset.pin_snapshot``) for its whole lifetime, so appends never
    shift its rows and a concurrent ``set_column`` generation rewrite can
    never mix pre-/post-rewrite values across fitting passes or device
    shards (every read — state fitting included — goes through the same
    snapshot the matrix was defined over)."""

    def __init__(self, ds: Dataset, label: str, steps, state,
                 feature_fields, n_rows: int, snap=None):
        self.ds = ds
        self._snap = snap if snap is not None else ds.pin_snapshot()
        self.label = label
        self.steps = [dict(s) for s in steps]
        self.state = state
        self.feature_fields = list(feature_fields)
        self.shape = (int(n_rows), len(self.feature_fields))
        self.dtype = np.dtype(np.float32)
        # Only the columns the pipeline actually touches are read per
        # block: the features plus every explicitly-referenced step field.
        need = set(self.feature_fields)
        for s in self.steps:
            need.update(s.get("fields") or ())
        self._input_fields = [f for f in ds.metadata.fields if f in need]

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def nbytes(self) -> int:
        return self.shape[0] * self.shape[1] * 4

    @property
    def shard_map(self):
        """The backing dataset's ingest shard map (owner host → row
        range), surfaced so ``mesh.shard_chunked`` can plan host-local
        placement for this design's feed; None when the dataset was not
        range-partition ingested. Design rows map 1:1 onto dataset rows
        (pipelines are row-wise), so the dataset's row ownership IS the
        design's."""
        return self.ds.shard_map

    def rows(self, start: int, stop: int) -> np.ndarray:
        start = max(0, int(start))
        stop = min(int(stop), self.shape[0])
        if not self.feature_fields:
            return np.zeros((max(stop - start, 0), 0), np.float32)
        cols = self._snap.read(self._input_fields, start, stop)
        cols.pop(self.label, None)
        cols, _ = apply_steps(cols, self.steps, self.state)
        return _stack_design([cols[f] for f in self.feature_fields],
                             stop - start)[0]

    def sample_rows(self, max_rows: int = 1 << 18) -> np.ndarray:
        """Evenly-strided row sample for statistics that genuinely need
        host rows (e.g. tree quantile edges — approximate sketches are the
        norm for histogram GBTs)."""
        n = self.shape[0]
        if n <= max_rows:
            return self.rows(0, n)
        blocks = 64
        per = max(1, max_rows // blocks)
        starts = np.linspace(0, n - per, blocks).astype(np.int64)
        return np.concatenate(
            [self.rows(int(s), int(s) + per) for s in starts], axis=0)


def design_matrix_streamed(ds: Dataset, label: str,
                           steps: Sequence[Dict[str, Any]] = (),
                           state: Optional[Dict] = None,
                           feature_fields: Optional[List[str]] = None,
                           n_rows: Optional[int] = None,
                           need_y: bool = True,
                           profile: Optional[Dict] = None,
                           ckpt=None):
    """Streamed analogue of ``design_matrix``: same return contract
    ``(X, y, feature_fields, state)`` but X is a :class:`ChunkedDesign`
    and nothing consolidates the dataset. ``state=None`` fits it with
    (fused) streaming passes; a provided state (the test set /
    SPMD-worker path) is applied as-is. ``n_rows`` pins the row snapshot
    (SPMD workers pin to the dispatched spec's counts). ``need_y=False``
    (the predict paths, which discard y) skips the label-column scan
    entirely. ``profile``, when given, receives the fit's
    ``fit_passes`` scan count (job profiling metadata).

    Every read — fitting passes, label encode, feature-field sampling,
    and the returned matrix's lazy row reads — goes through ONE pinned
    chunk snapshot, held for the :class:`ChunkedDesign`'s lifetime."""
    snap = ds.pin_snapshot()
    total = snap.n_rows
    n_rows = total if n_rows is None else min(int(n_rows), total)
    steps = [dict(s) for s in steps] or [dict(s) for s in _DEFAULT_STEPS]
    if state is None:
        state = _fit_design_state(snap, ds.metadata.fields, label, steps,
                                  n_rows, profile=profile, ckpt=ckpt)
    else:
        state = dict(state)
    y = None
    if need_y and label in ds.metadata.fields:
        if (n_rows and "__label_vocab__" not in state
                and snap.read([label], 0, 1)[label].dtype == object):
            # Apply-with-given-state path on an object label whose vocab
            # was never fitted (possible only if the train set lacked the
            # label column): fit it here, as the resident path would.
            state["__label_vocab__"] = _fit_label_vocab(snap, label, n_rows)
        parts = [_encode_label_block(cols[label], state)
                 for cols in _iter_blocks(snap, n_rows, [label])]
        y = (np.concatenate(parts) if parts
             else np.empty(0, dtype=np.int32))
    if feature_fields is None:
        sample = snap.read(None, 0, min(n_rows, 1024))
        sample.pop(label, None)
        sampled, _ = apply_steps(sample, steps, state)
        feature_fields = [f for f in sampled
                          if sampled[f].dtype.kind in "ifub"]
    X = ChunkedDesign(ds, label, steps, state, feature_fields, n_rows,
                      snap=snap)
    return X, y, list(feature_fields), state


def exec_preprocess(code: str, train_ds: Dataset, test_ds: Dataset,
                    label: str, cfg=None):
    """Flag-gated exec path (reference model_builder.py:145-150), run in a
    resource-jailed child process.

    The reference exec()s user code inside the service process; here the
    code runs in a separate interpreter under POSIX rlimits (CPU seconds,
    address space, no cores — ops/exec_jail.py) with a wall-clock
    timeout, so an infinite loop, memory bomb, or segfaulting extension
    fails that one job instead of the server. A resource jail, not a
    security boundary — the gate stays ``allow_exec_preprocessing``.
    """
    import pickle
    import subprocess
    import sys

    from learningorchestra_tpu_torch.config import settings as global_settings

    cfg = cfg or global_settings
    req = {
        "code": code,
        "train_cols": {f: train_ds.columns[f]
                       for f in train_ds.metadata.fields},
        "test_cols": {f: test_ds.columns[f]
                      for f in test_ds.metadata.fields},
        "label": label,
        "cpu_s": int(cfg.exec_cpu_seconds),
        "mem_mb": int(cfg.exec_memory_mb),
    }
    # The child is a FRESH interpreter that must import this same package.
    # When the parent runs from a source checkout (sys.path manipulation
    # rather than pip install), the child wouldn't find it — prepend the
    # package's parent directory so the jail always loads the code the
    # server is running. The jail imports numpy and pandas only.
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    try:
        proc = subprocess.run(
            [sys.executable, "-m",
             "learningorchestra_tpu_torch.ops.exec_jail"],
            input=pickle.dumps(req, protocol=pickle.HIGHEST_PROTOCOL),
            capture_output=True, env=env,
            timeout=cfg.exec_timeout_seconds or None)
    except subprocess.TimeoutExpired:
        raise PreprocessError(
            f"preprocessor code exceeded the {cfg.exec_timeout_seconds}s "
            "wall-clock limit") from None
    if proc.returncode != 0 or not proc.stdout:
        tail = proc.stderr.decode("utf-8", "replace").strip()[-500:]
        raise PreprocessError(
            "preprocessor process died "
            f"(exit {proc.returncode}): {tail or 'no output'}")
    # The reply is npz, NEVER pickle: the child shares its process with
    # user code, which can always find the reply pipe, so nothing the
    # parent runs on these bytes may execute. allow_pickle=False makes a
    # forged reply at worst wrong arrays (user code defines the arrays
    # anyway) or a clean decode failure.
    import io

    # NpzFile decodes LAZILY (np.load only parses the zip directory), so
    # every per-entry access — including a forged pickled-object entry or
    # a missing key — must happen inside this try for the fail-clean
    # contract to hold.
    try:
        with np.load(io.BytesIO(proc.stdout), allow_pickle=False) as npz:
            out = {k: npz[k] for k in npz.files}
        if "error" not in out:
            X_train = np.asarray(out["X_train"], np.float32)
            y_train = np.asarray(out["y_train"], np.int32)
            X_test = np.asarray(out["X_test"], np.float32)
            y_test = (np.asarray(out["y_test"], np.int32)
                      if "y_test" in out else None)
    except Exception:  # noqa: BLE001 — any corrupt reply is a job failure
        raise PreprocessError(
            "preprocessor reply was corrupt (user code wrote to the "
            "reply channel?)") from None
    if "error" in out:
        raise PreprocessError(str(out["error"][()]))
    return X_train, y_train, X_test, y_test
