"""Warmed online predict programs (the serving tier's device side).

The batch predict path (``ModelBuilder.predict``) moves a saved model's
params to the device per call — fine for dataset jobs, too slow for
request/response serving, where the whole latency budget is
milliseconds. Here every trained model is loaded ONCE: its params go to
the device at load, and its predict function runs once at every padded
batch size of the bucket ladder (1/8/64/…/max_batch) before the model
serves, so no request pays a first-call cost.

Design points (the JAX package's ``models/aot.py``, on PyTorch):

- **Warm-up, not AOT compile**: PyTorch runs eagerly; the counterpart of
  the JAX package's ``jit(...).lower(...).compile()`` per bucket is one
  run of every bucket at load. It loads the CUDA kernel libraries, which
  ``ops/_cuda_build.py`` builds at first use, and warms the caching
  allocator for every bucket's shapes. ``compile_wall_s`` is its wall
  time.
- **Bucketed padding**: a micro-batch is padded with zero rows up to the
  next bucket and the padding is sliced off the output. Every family's
  predict is row-local and row-invariant (the reductions run in a fixed
  order, ``models/base.py``), so a row's probabilities are the same
  bytes in every bucket and in a one-row batch predict.
- **Replicas**: ``serve_replicas`` copies of the params, one per CUDA
  device, clamped to ``torch.cuda.device_count()`` (1 on one card; a
  caller that asks for the CPU gets 1).
- **No buffer donation**: PyTorch has none; each dispatch allocates its
  padded input and output from the caching allocator, which the warm-up
  has already sized.
- **Versioned cache**: entries are keyed by model name and the manifest's
  (mtime_ns, size) version token. Re-saving a model under the same name,
  or deleting it, invalidates on the next lookup.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from learningorchestra_tpu_torch.config import (
    Settings, settings as global_settings)
from learningorchestra_tpu_torch.models.persistence import ModelRegistry
from learningorchestra_tpu_torch.models.registry import ONLINE_KINDS
from learningorchestra_tpu_torch.parallel.runtime import resolve_device
from learningorchestra_tpu_torch.utils import failpoints, resources

#: Chaos seam before a model's load and bucket-ladder warm-up: raise-mode
#: proves a failed cold load surfaces as the request's error (never a
#: half-cached entry); slow/hang-mode that a stalled load blocks only the
#: loading model's requests (per-name lock).
FP_PRE_COMPILE = failpoints.declare("serving.aot.pre_compile")


def resolve_replicas(cfg: Settings, device: torch.device) -> int:
    """How many device replicas the online predict plane runs
    (``serve_replicas``): 1, the default, is one device; 0 means one per
    CUDA device; any other N clamps to ``torch.cuda.device_count()``. A
    CPU device has one replica."""
    n = int(cfg.serve_replicas)
    if n == 1 or device.type != "cuda":
        return 1
    avail = max(1, torch.cuda.device_count())
    return avail if n <= 0 else min(n, avail)


def predict_buckets(max_batch: int) -> Tuple[int, ...]:
    """The padded-batch-size ladder: powers of 8 up to ``max_batch``,
    which is always itself a bucket (1, 8, 64, 256 for the default 256).
    Geometric spacing bounds both the warm-up count (log_8) and the
    worst-case padding waste (<8x, and real micro-batches cluster near
    the coalesced size anyway)."""
    max_batch = max(1, int(max_batch))
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 8
    out.append(max_batch)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _numeric_column(field: str, values: List[Any]) -> np.ndarray:
    """Column-ize one numeric field of inline rows (None → NaN so fitted
    fillna stats apply). Strings are rejected rather than silently
    fitted a fresh vocab: the model has no encoding for this field, and
    letting ``apply_steps`` invent one would both answer garbage and
    write into the SHARED fitted state from a request thread."""
    try:
        return np.array([np.nan if v is None else float(v)
                         for v in values], dtype=np.float64)
    except (TypeError, ValueError):
        raise ValueError(
            f"field {field!r} is numeric for this model; got "
            "non-numeric values") from None


def design_from_rows(rows: Sequence[Any], pp: Dict[str, Any]) -> np.ndarray:
    """Inline JSON feature rows → the model's design matrix, with its
    train-time preprocessing state applied.

    Two row forms:

    - list of objects ``{field: value}`` — raw source fields; the fitted
      pipeline (label-encode vocabs, fillna statistics, standardize
      stats) applies exactly as ``ModelBuilder.predict`` applies it to a
      stored dataset. A field the fitted vocab knows is forced to the
      object dtype (so numbers sent for a train-time string column still
      hit the vocab), everything else is numeric.
    - list of lists — already-assembled design rows in
      ``feature_fields`` order (the zero-copy fast path for callers that
      preprocess client-side).
    - a 2-D ``np.ndarray`` — rows already decoded from a binary columnar
      request body (serving/rowchannel.py): same width/finiteness
      validation as list rows with ZERO per-row decode — the buffer the
      socket delivered is the design matrix.
    """
    from learningorchestra_tpu_torch.ops.preprocess import apply_steps

    if isinstance(rows, np.ndarray):
        feature_fields = list(pp["feature_fields"])
        if rows.ndim != 2 or rows.shape[0] == 0:
            raise ValueError(
                "columnar rows must be a non-empty 2-D matrix")
        if rows.shape[1] != len(feature_fields):
            raise ValueError(
                f"columnar rows must be shaped (n, {len(feature_fields)}) "
                f"matching feature_fields {feature_fields}")
        X = np.asarray(rows, dtype=np.float32)
        return _finite_design(np.ascontiguousarray(X), feature_fields)
    if not isinstance(rows, (list, tuple)) or not rows:
        raise ValueError("rows must be a non-empty JSON array")
    feature_fields = list(pp["feature_fields"])
    if not isinstance(rows[0], dict):
        try:
            X = np.asarray(rows, dtype=np.float32)
        except (TypeError, ValueError):
            # Non-numeric elements (dicts mixed into list rows, strings,
            # nested objects) must 406 like every other malformed body,
            # not surface numpy's TypeError as a 500.
            raise ValueError(
                "list rows must contain only numeric values") from None
        if X.ndim != 2 or X.shape[1] != len(feature_fields):
            raise ValueError(
                f"list rows must be shaped (n, {len(feature_fields)}) "
                f"matching feature_fields {feature_fields}")
        return _finite_design(np.ascontiguousarray(X), feature_fields)

    if not all(isinstance(r, dict) for r in rows):
        raise ValueError("rows must be all objects or all lists")
    # Empty steps means the default pipeline — ``design_matrix`` defaults
    # it internally, so persisted manifests carry [] and the fitted state
    # keys ("0:label_encode", …) only line up once we default the same
    # way.
    from learningorchestra_tpu_torch.ops.preprocess import _DEFAULT_STEPS

    steps = pp["steps"] or list(_DEFAULT_STEPS)
    # The fitted state is shared READ-ONLY across concurrent requests —
    # no per-request copy (a deepcopy of a 100k-entry vocab would
    # dominate single-row predicts). Safe because the column coercion
    # below guarantees apply_steps never has a statistic to fit: fields
    # the fitted vocabs know arrive as object/string columns, every
    # other field arrives numeric-or-406, and every fitted step carries
    # its state key, so all step branches reduce to pure application.
    state = pp["state"]
    vocab_fields = set()
    for key, val in state.items():
        if ":label_encode" in str(key) and isinstance(val, dict):
            vocab_fields.update(val.keys())
    fields: List[str] = []
    for r in rows:
        for f in r:
            if f not in fields:
                fields.append(f)
    label = pp.get("label")
    # Only the columns the design needs: feature fields plus any field
    # the fitted vocabs encode. Extra payload fields (a Name column, a
    # request id) are ignored, matching the batch path's tolerance of
    # non-feature columns — rejecting them would 406 every client that
    # sends its full raw record.
    needed = set(feature_fields) | vocab_fields
    cols: Dict[str, np.ndarray] = {}
    for f in fields:
        if f == label or f not in needed:
            continue                      # label / non-feature payload
        values = [r.get(f) for r in rows]
        if f in vocab_fields:
            # Train-time string column: route through the fitted vocab
            # (unknown values encode to len(vocab), same as the batch
            # path's apply-to-test semantics).
            cols[f] = np.array(
                [None if v is None else str(v) for v in values],
                dtype=object)
        else:
            cols[f] = _numeric_column(f, values)
    out, _ = apply_steps(cols, steps, state)
    missing = [f for f in feature_fields if f not in out]
    if missing:
        raise ValueError(
            f"rows missing model feature fields: {missing}")
    return _finite_design(np.stack(
        [np.asarray(out[f], np.float32) for f in feature_fields], axis=1),
        feature_fields)


def _finite_design(X: np.ndarray, feature_fields: List[str]) -> np.ndarray:
    """Reject rows whose design values are non-finite AFTER the fitted
    pipeline ran — e.g. a null sent for a field that had no missing
    values at train time, so no fill statistic was ever fitted. The
    batch path would silently propagate the NaN into NaN probabilities
    (caught live during verification); online serving answers an
    explicit 406 naming the field instead."""
    finite = np.isfinite(X)
    if not finite.all():
        bad = ~finite
        bad_rows = np.where(bad.any(axis=1))[0]
        bad_fields = [feature_fields[j]
                      for j in np.where(bad.any(axis=0))[0]]
        raise ValueError(
            f"rows {bad_rows[:5].tolist()} have non-finite features "
            f"after preprocessing (fields {bad_fields}); the model was "
            "fitted with no fill statistic for them — send finite "
            "values or refit with NaNs present")
    return X


def _replica_devices(device: torch.device, n: int) -> List[torch.device]:
    """Replica i's device: the given device for one replica, else CUDA
    devices 0 … n-1."""
    if n == 1:
        return [device]
    return [torch.device("cuda", i) for i in range(n)]


class AotModel:
    """One loaded trained model, its params on the device, its bucket
    ladder warmed.

    The warm-up happens once, in ``__init__`` (model load) — never on
    the request path. ``predict`` pads a host batch up to its bucket,
    runs the model's predict function on the serving device, and slices
    the padding back off.
    """

    def __init__(self, name: str, version: Tuple[int, int],
                 manifest: Dict[str, Any], model,
                 buckets: Sequence[int], replicas: int = 1,
                 device: str = "cuda"):
        if manifest["kind"] not in ONLINE_KINDS:
            raise ValueError(
                f"model kind {manifest['kind']!r} is not servable online "
                f"(supported: {list(ONLINE_KINDS)})")
        pp = manifest.get("preprocess")
        if pp is None:
            raise ValueError(
                f"model {name} was exec-preprocessed; it carries no "
                "reproducible preprocessing state to apply to request rows")
        self.name = name
        self.version = version
        self.manifest = manifest
        self.preprocess = pp
        self.kind = manifest["kind"]
        self.buckets = tuple(buckets)
        self.n_features = len(pp["feature_fields"])
        #: Swap-epoch token stamped by the cache on insert: strictly
        #: increasing per model name across rebuilds, so any response
        #: evaluated through this entry is attributable to exactly one
        #: version-swap generation. 0 until the cache stamps it.
        self.swap_epoch = 0
        dev = resolve_device(str(device))
        if dev.type == "cuda":
            replicas = min(int(replicas), torch.cuda.device_count())
        else:
            replicas = 1
        self.n_replicas = max(1, int(replicas))
        self._devices = _replica_devices(dev, self.n_replicas)
        #: Bytes of one params copy, and the total over the replicas.
        self.params_bytes_per_replica = int(sum(
            v.numel() * v.element_size() for v in model.params.values()))
        self.params_bytes = self.params_bytes_per_replica * self.n_replicas
        self._params_r = [{k: v.to(d) for k, v in model.params.items()}
                          for d in self._devices]
        self._fn = model.predict_proba_fn
        c0 = resources.compile_seconds()
        t0 = time.monotonic()
        for r in range(self.n_replicas):
            for b in self.buckets:
                self.predict_padded(
                    np.zeros((b, self.n_features), np.float32), r)
        #: Wall seconds the warm-up of the whole ladder (all replicas)
        #: took — the counterpart of the JAX package's compile time,
        #: surfaced per load so a hot swap's cost is attributable.
        self.compile_wall_s = round(time.monotonic() - t0, 6)
        # One compile per warmed bucket (utils/resources.py); a kernel
        # build the warm-up triggered counts as its own compile, so its
        # seconds are not counted twice.
        resources.note_compile(
            max(0.0, self.compile_wall_s
                - (resources.compile_seconds() - c0)),
            n=len(self.buckets) * self.n_replicas)

    def predict_padded(self, X: np.ndarray, replica: int = 0) -> np.ndarray:
        """One device dispatch for a host batch of ≤ max-bucket rows:
        pad → the predict function on the replica's device → host probs
        sliced to the true count. This is the ONLY device entry of the
        online tier; replica ``replica``'s dispatcher thread owns that
        replica's device. Kernels launch on the calling thread's current
        stream, so a dispatch and a fit running beside it are ordered."""
        n = len(X)
        bucket = bucket_for(n, self.buckets)
        if n < bucket:
            X = np.concatenate(
                [X, np.zeros((bucket - n, self.n_features), np.float32)],
                axis=0)
        x = torch.from_numpy(np.ascontiguousarray(X, np.float32))
        with torch.no_grad():
            probs = self._fn(self._params_r[replica],
                             x.to(self._devices[replica]))
        return probs.cpu().numpy()[:n]

    def predict(self, X: np.ndarray, replica: int = 0) -> np.ndarray:
        """Probabilities for any host batch on the given replica's
        device; rows beyond the largest bucket run as successive
        max-bucket dispatches. Bit-identical across buckets and replicas:
        every family's predict is row-invariant (models/base.py)."""
        max_b = self.buckets[-1]
        if len(X) <= max_b:
            return self.predict_padded(X, replica)
        return np.concatenate(
            [self.predict_padded(X[i:i + max_b], replica)
             for i in range(0, len(X), max_b)], axis=0)


class AotCache:
    """Persistent in-process cache of loaded, warmed models, keyed by
    model name and version — the manifest file's (mtime_ns, size) — so a
    re-save under the same name reloads and a delete raises
    ``ModelNotFound`` on the next lookup. ``device`` is ``"cuda"`` unless
    the caller passes ``"cpu"``; without a CUDA device the default
    raises."""

    def __init__(self, registry: ModelRegistry,
                 cfg: Optional[Settings] = None, device: str = "cuda"):
        self.registry = registry
        self.cfg = cfg or global_settings
        self.device = resolve_device(device)
        self.buckets = predict_buckets(self.cfg.serve_max_batch)
        #: Device replicas every entry is loaded on — resolved ONCE so
        #: every model in this cache has the same replica topology (the
        #: dispatcher sets in serving/batcher.py are sized off it).
        self.replicas = resolve_replicas(self.cfg, self.device)
        self._lock = threading.Lock()
        self._models: Dict[str, AotModel] = {}
        self._name_locks: Dict[str, threading.Lock] = {}
        #: Per-name swap epoch: bumped each time a (re)built entry is
        #: inserted, stamped onto the entry. One AotModel holds every
        #: replica's params and the name maps to exactly one entry, so
        #: every replica of a model serves the same version — the epoch
        #: is the observable token of which swap a response came from.
        self._epochs: Dict[str, int] = {}
        self._compiles = 0
        self._evictions = 0
        self._hits = 0
        self._compile_wall_s = 0.0

    def entry(self, name: str) -> AotModel:
        """The loaded, warmed model, (re)built when absent or stale.
        The manifest stat per lookup (``ModelRegistry.version``) is the
        staleness probe — ~µs, paid once per request, and what lets a
        hot-swapped model serve its new version without a restart.

        Loading runs under a PER-NAME lock, never the global one: a cold
        load or hot swap of one model must not head-of-line-block every
        other model's handlers and dispatchers."""
        version = self.registry.version(name)
        with self._lock:
            ent = self._models.get(name)
            if ent is not None and ent.version == version:
                self._hits += 1
            else:
                ent = None
                name_lock = self._name_locks.setdefault(
                    name, threading.Lock())
        if ent is not None:
            # Counted outside the cache lock: a cache hit per served
            # request is the hit leg of the compile accounting.
            resources.note_cache_hit()
            return ent
        with name_lock:
            # Re-read the token under the name lock: a save() completing
            # while we waited means load() below returns the NEW content
            # — tagging it with the pre-wait token would force a
            # redundant reload on the next request.
            version = self.registry.version(name)
            with self._lock:                 # another thread built it?
                ent = self._models.get(name)
                if ent is not None and ent.version == version:
                    return ent
                stale = ent is not None
            # Double-read the token AROUND the load and retry until it
            # is stable: version() is lock-free while load() waits out
            # any in-flight save() on the registry lock, so a lone
            # pre-load read can pair a pre-save token with post-save
            # content. Tokens are strictly increasing across saves (no
            # ABA), so token-before == token-after proves the loaded
            # snapshot corresponds to that token.
            failpoints.fire(FP_PRE_COMPILE)
            while True:
                manifest, model = self.registry.load(name)
                after = self.registry.version(name)
                if after == version:
                    break
                version = after
            ent = AotModel(name, version, manifest, model, self.buckets,
                           replicas=self.replicas, device=str(self.device))
            # Deleted while we loaded? Re-probe before caching, so a
            # DELETE's invalidate() cannot be undone by this insert
            # (ModelNotFound propagates as the request's 404).
            self.registry.version(name)
            with self._lock:
                if stale:
                    self._evictions += 1
                # Stamp the swap epoch under the same lock that makes
                # the entry visible: readers that observe the new entry
                # observe its (strictly increasing) epoch atomically.
                ent.swap_epoch = self._epochs.get(name, 0) + 1
                self._epochs[name] = ent.swap_epoch
                self._models[name] = ent
                self._compiles += len(self.buckets) * ent.n_replicas
                self._compile_wall_s = round(
                    self._compile_wall_s + ent.compile_wall_s, 6)
            return ent

    def invalidate(self, name: Optional[str] = None) -> None:
        with self._lock:
            if name is None:
                self._evictions += len(self._models)
                self._models.clear()
            elif self._models.pop(name, None) is not None:
                self._evictions += 1

    def snapshot(self) -> Dict[str, Any]:
        """The ``aot`` section of ``/metrics``: the JAX package's keys,
        with ``compile_wall_s`` (warm-up wall time) in place of its XLA
        ``compile_s``; ``programs_compiled`` counts warmed buckets."""
        with self._lock:
            return {"models_loaded": len(self._models),
                    "programs_compiled": self._compiles,
                    "compile_wall_s": round(self._compile_wall_s, 6),
                    "hits": self._hits,
                    "evictions": self._evictions,
                    "buckets": list(self.buckets),
                    "replicas": self.replicas,
                    "device": str(self.device),
                    "params_bytes": sum(
                        m.params_bytes for m in self._models.values()),
                    # Completed hot swaps: epoch 1 is the cold load, so
                    # each name contributes (epoch - 1) swaps.
                    "swaps": sum(e - 1 for e in self._epochs.values())}
