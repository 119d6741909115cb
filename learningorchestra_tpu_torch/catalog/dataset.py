"""Named-dataset model: columnar data + the metadata/lineage contract.

The reference's universal data plane is "one Mongo collection per file" where
document ``_id: 0`` is a metadata doc ``{filename, url|parent_filename,
time_created, finished, fields}`` and rows are ``_id: 1..N`` in CSV order
(reference database.py:157-168,205-213; docs/database_api.md:3-77). The
``finished`` flag flipping false→true is the system-wide async-completion
signal the client polls (database.py:177-181), and ``parent_filename``
records lineage for derived datasets.

This module keeps that *contract* — names, metadata-doc shape, finished-flag
semantics, row ``_id`` numbering — over a TPU-friendly *mechanism*: columns
are contiguous numpy arrays (zero-copy into ``jax.numpy``/device shards)
instead of per-row BSON documents.

Out-of-core: the reference's data plane is disk-backed Mongo and handles
collections larger than RAM (reference database.py:133-216). Here each
append becomes an immutable *chunk* that can live in host RAM, in a parquet
chunk file on disk, or both. Under a configured RAM budget
(``Settings.ram_budget_mb``) chunks are flushed to disk and evicted, and
streaming consumers (`iter_chunks`) process the dataset one chunk at a time
— ingest → histogram → projection run on datasets larger than host memory.
Chunk files are written via tmp+rename and recorded in an fsynced
``journal.jsonl``, making every chunk commit O(chunk) and crash-consistent
(a recovered dataset is always a journaled prefix of the appends).

Upgrade over the reference: a mid-flight crash in the reference leaves
``finished: false`` forever and clients poll infinitely (SURVEY.md §5); here
metadata carries an ``error`` field that job runners set on failure so
clients can fail fast.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import weakref
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from learningorchestra_tpu_torch.catalog import readpipe
from learningorchestra_tpu_torch.utils import failpoints, tracing

#: Columns are numpy arrays: numeric dtypes or ``object`` for strings/mixed.
Columns = Dict[str, np.ndarray]

#: Deterministic fault-injection sites (utils/failpoints.py). Each names
#: the exact I/O boundary a crash/torn-write test targets; zero overhead
#: unless armed via LO_TPU_FAILPOINTS.
FP_WRITE_CHUNK_PRE_RENAME = failpoints.declare(
    "catalog.write_chunk.pre_rename")
FP_JOURNAL_MID_APPEND = failpoints.declare("catalog.journal.mid_append")
FP_JOURNAL_PRE_SWAP = failpoints.declare("catalog.journal.pre_swap")
FP_CHUNK_PRE_READ = failpoints.declare("catalog.chunk.pre_read")


class ChunkCorrupt(RuntimeError):
    """A journaled chunk file failed its checksum (or vanished) and could
    not be repaired from the replica mirror — the precise,
    catalog-surface error that replaces an opaque parquet/arrow parse
    traceback deep inside a consumer."""

    def __init__(self, path: str, expected: Optional[int],
                 actual: Optional[int]):
        self.path = path
        self.expected = expected
        self.actual = actual
        what = ("is missing" if actual is None else
                f"checksum mismatch (journal crc32={expected}, "
                f"file crc32={actual})")
        super().__init__(
            f"chunk file {path} {what}; the dataset's journaled data is "
            "corrupt and no valid replica copy was available to repair "
            "from (see DatasetStore.scrub / docs/fault_tolerance.md)")


def crc32_file(path: str) -> int:
    """Streaming CRC32 of a file's bytes — the per-chunk integrity
    checksum recorded in the journal and verified on read/scrub."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


@dataclass
class Metadata:
    """The ``_id: 0`` metadata document of a dataset."""

    name: str
    url: Optional[str] = None           # source URL for ingested datasets
    parent: Optional[str] = None        # lineage: parent dataset name
    time_created: str = ""
    finished: bool = False
    fields: List[str] = field(default_factory=list)
    error: Optional[str] = None         # set when an async job failed
    extra: Dict[str, Any] = field(default_factory=dict)  # e.g. model metrics

    def __post_init__(self):
        if not self.time_created:
            # Same human-readable stamp style as the reference
            # (database.py:206: time.strftime("%Y-%m-%d %H:%M:%S")).
            self.time_created = time.strftime("%Y-%m-%d %H:%M:%S")

    def to_doc(self) -> Dict[str, Any]:
        """Render as the reference-shaped metadata document (``_id: 0``)."""
        doc: Dict[str, Any] = {"_id": 0, "filename": self.name}
        if self.url is not None:
            doc["url"] = self.url
        if self.parent is not None:
            doc["parent_filename"] = self.parent
        doc["time_created"] = self.time_created
        doc["finished"] = self.finished
        doc["fields"] = list(self.fields)
        if self.error is not None:
            doc["error"] = self.error
        doc.update(self.extra)
        return doc

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "Metadata":
        known = {"_id", "filename", "url", "parent_filename", "time_created",
                 "finished", "fields", "error"}
        return cls(
            name=doc["filename"],
            url=doc.get("url"),
            parent=doc.get("parent_filename"),
            time_created=doc.get("time_created", ""),
            finished=bool(doc.get("finished", False)),
            fields=list(doc.get("fields", [])),
            error=doc.get("error"),
            extra={k: v for k, v in doc.items() if k not in known},
        )


def _arr_bytes(a: np.ndarray) -> int:
    if a.dtype == object:
        # Estimate: pointer + small-string payload per element. Exact
        # accounting would walk every object; the budget is a soft bound.
        return len(a) * 64
    return int(a.nbytes)


class _Chunk:
    """One appended block of rows; in host RAM, in a parquet file, or both.

    In-RAM data is either materialized numpy columns (``cols``) or a
    ``pyarrow.RecordBatch`` (``arrow``) straight from the native parser —
    the ingest fast path that defers creating Python string objects until
    a reader actually needs them. Both drop to ``None`` when the chunk is
    evicted under a RAM budget; ``path`` is set once the chunk is durably
    flushed. Chunk files are immutable (written tmp+rename, never
    modified), so a disk-backed chunk can be re-read without coordination:
    readers snapshot ``cols``/``arrow`` into a local before testing it,
    and fall back to the file.

    ``src_off`` records the source-stream byte offset just past this
    chunk's last row (ingest chunks only) — journaled so an interrupted
    ingest can resume from the last committed byte (catalog/ingest.py
    ``resume_ingest``).
    """

    __slots__ = ("cols", "arrow", "path", "n_rows", "dtypes", "data_bytes",
                 "src_off", "_evictable", "crc32", "verify", "_verified")

    def __init__(self, cols: Columns):
        self.cols: Optional[Columns] = cols
        self.arrow = None
        self.path: Optional[str] = None
        self.n_rows = len(next(iter(cols.values())))
        self.dtypes: Dict[str, np.dtype] = {f: a.dtype
                                            for f, a in cols.items()}
        self.data_bytes = sum(_arr_bytes(a) for a in cols.values())
        self.src_off: Optional[int] = None
        self._evictable: Optional[bool] = None
        #: Journaled CRC32 of the chunk file's bytes (None for chunks
        #: never flushed, or restored from pre-checksum journals).
        self.crc32: Optional[int] = None
        #: Integrity callback (Dataset._verify_chunk) run before the
        #: first disk read of this chunk; None for purely in-memory use.
        self.verify: Optional[Callable] = None
        self._verified = False

    @classmethod
    def from_arrow(cls, batch, src_off: Optional[int] = None) -> "_Chunk":
        """Chunk backed by a pyarrow RecordBatch (ingest fast path)."""
        import pyarrow as pa

        c = cls.__new__(cls)
        c.cols = None
        c.arrow = batch
        c.path = None
        c.crc32 = None
        c.verify = None
        c._verified = False
        c.n_rows = batch.num_rows
        c.dtypes = {}
        for fld in batch.schema:
            if pa.types.is_string(fld.type) or pa.types.is_large_string(
                    fld.type):
                c.dtypes[fld.name] = np.dtype(object)
            else:
                c.dtypes[fld.name] = np.dtype(fld.type.to_pandas_dtype())
        c.data_bytes = int(batch.nbytes)
        c.src_off = src_off
        # Arrow batches hold only numbers/strings/nulls — exactly the
        # parquet value domain, so a disk round-trip is always faithful.
        c._evictable = True
        return c

    @classmethod
    def on_disk(cls, path: str, n_rows: int, dtypes: Dict[str, np.dtype],
                data_bytes: int, src_off: Optional[int] = None,
                crc32: Optional[int] = None) -> "_Chunk":
        """Handle for a journaled chunk file — no data read (lazy load)."""
        c = cls.__new__(cls)
        c.cols = None
        c.arrow = None
        c.path = path
        c.n_rows = n_rows
        c.dtypes = dict(dtypes)
        c.data_bytes = data_bytes
        c.src_off = src_off
        c._evictable = True
        c.crc32 = crc32
        c.verify = None
        c._verified = False
        return c

    @property
    def in_memory(self) -> bool:
        return self.cols is not None or self.arrow is not None

    @property
    def evictable(self) -> bool:
        """Whether a disk round-trip reproduces this chunk's values exactly.

        Parquet stores object columns as nullable strings, so a chunk whose
        object columns hold anything but str/None (e.g. float scores with
        None gaps from ``append_rows``) would come back with its numbers
        silently stringified — such chunks stay resident instead of
        evicting. (Cross-restart persistence still stringifies them; the
        guarantee here is no value drift *within* a process.)"""
        if self._evictable is None:
            cols = self.cols
            ok = True
            if cols is not None:
                for a in cols.values():
                    if a.dtype == object and not is_stringy(a):
                        ok = False
                        break
            self._evictable = ok
        return self._evictable

    def materialize(self, fields: Optional[List[str]] = None) -> Columns:
        """Column data for this chunk (optionally a field subset). Disk
        reads are never cached back onto the chunk object (streaming
        consumers stay bounded per dataset); they DO go through the
        byte-budgeted process-wide LRU chunk cache (catalog/readpipe.py),
        whose CRC-pinned keys and budget keep that sharing safe and
        bounded.

        Disk reads coerce to the chunk's *current* ``dtypes``: consolidation
        may have re-pointed an already-flushed chunk at dtype-promoted (or
        stringified) views before a budget eviction dropped them, leaving
        the journaled file with the pre-promotion dtype. Re-applying the
        ``_concat`` promotion rule here keeps streamed values identical to
        what consolidation yields (no in-process drift)."""
        cols = self.cols
        if cols is None:
            arrow = self.arrow
            if arrow is not None:
                # Arrow → numpy: strings become object arrays with None
                # for nulls (the catalog column domain), numerics stay
                # their dtypes. Not cached back: readers of an unevicted
                # arrow chunk are transient (consolidation caches its own
                # result).
                data = {name: col.to_numpy(zero_copy_only=False)
                        for name, col in zip(arrow.schema.names,
                                             arrow.columns)
                        if fields is None or name in fields}
                return ({f: data[f] for f in fields} if fields is not None
                        else data)
            # Warm-path: the byte-budgeted LRU chunk cache (readpipe)
            # keyed by (path, journal CRC32, field selection) — the raw
            # decoded read, shared across passes/datasets. A hit skips
            # the file read AND its first-read verification (the cached
            # bytes were verified when they were read); the dtype
            # coercion below still runs per call against the chunk's
            # CURRENT dtypes, so cached data can never drift from what a
            # fresh read would yield.
            fkey = None if fields is None else tuple(fields)
            data = readpipe.cache_get(self.path, self.crc32, fkey)
            if data is None:
                if not self._verified and self.verify is not None:
                    # First disk read: checksum the file (repairing from
                    # the replica on mismatch) before handing bytes to
                    # the arrow reader — corruption surfaces as
                    # ChunkCorrupt here, not as a parse traceback deep
                    # inside a fit.
                    self.verify(self)
                data = read_chunk_file(self.path, fields)
                readpipe.cache_put(
                    self.path, self.crc32, fkey, data,
                    sum(_arr_bytes(a) for a in data.values()))
            for f, a in data.items():
                want = self.dtypes.get(f)
                if want is not None and a.dtype != want:
                    data[f] = (stringify_numeric(a)
                               if (want == object and a.dtype != object)
                               else a.astype(want))
            return data
        if fields is not None:
            return {f: cols[f] for f in fields}
        return cols


class Dataset:
    """A named columnar dataset with reference-compatible row addressing.

    Rows are addressed ``_id = 1..N`` in insertion order; ``_id = 0`` is the
    metadata document. Appends are amortized O(1) via chunked column buffers
    so streaming CSV ingestion never re-copies the whole table per chunk.
    """

    def __init__(self, metadata: Metadata, columns: Optional[Columns] = None):
        self.metadata = metadata
        # Guards _chunks/_consolidated: ingestion appends from a job thread
        # while readers poll/consolidate the same dataset.
        self._data_lock = threading.Lock()
        self._chunks: List[_Chunk] = []
        self._consolidated: Optional[Columns] = None
        self._chunk_dir: Optional[str] = None
        self._journal_path: Optional[str] = None
        self._ram_budget: Optional[int] = None
        #: Prefetch window for streaming reads (iter_chunks / snapshot
        #: scans); None = the process default (LO_TPU_PREFETCH_CHUNKS).
        self._prefetch: Optional[int] = None
        #: Chunk files are named ``GGG-NNNNN.parquet``: the generation bumps
        #: on every rewrite (set_column) so filenames never collide across
        #: rewrites — old-generation files stay valid until the new journal
        #: is atomically swapped in, then get garbage-collected.
        self._gen = 0
        self._next_chunk_id = 0
        self._journal_records = 0
        #: Streaming readers (iter_chunks) holding a chunk snapshot; chunk
        #: file GC defers while any are active.
        self._active_readers = 0
        self._pending_gc = False
        #: Derived-artifact cache (design matrices): {key: (snapshot_id,
        #: value)}, valid only while the consolidation snapshot it was
        #: built from is current. See ``memo``.
        self._memo: Dict[Any, tuple] = {}
        #: Set when the chunk list was rebuilt in place (set_column) while
        #: on-disk chunk state existed: flushed chunk files no longer
        #: describe the data and the store must rewrite a fresh generation
        #: on the next save.
        self._rewrite_needed = False
        #: ``hook(chunk_basename, expected_crc) -> bool`` — attempts to
        #: restore a corrupt/missing chunk file (DatasetStore wires this
        #: to its replica mirror). None = no repair tier; corruption
        #: raises ChunkCorrupt directly.
        self._repair_hook: Optional[Callable[[str, Optional[int]], bool]] \
            = None
        if columns:
            self.append_columns(columns)

    # -- storage wiring (set by DatasetStore) --------------------------------

    def attach_storage(self, chunk_dir: str, journal_path: str,
                       ram_budget_bytes: Optional[int] = None,
                       prefetch_chunks: Optional[int] = None) -> None:
        """Wire the on-disk chunk tier: where flushed/evicted chunks go and
        how much column data may stay resident in host RAM.
        ``prefetch_chunks`` pins this dataset's streaming-read prefetch
        window (None = the process default)."""
        with self._data_lock:
            self._chunk_dir = chunk_dir
            self._journal_path = journal_path
            self._ram_budget = ram_budget_bytes or None
            if prefetch_chunks is not None:
                self._prefetch = prefetch_chunks
            self._maybe_evict_locked()

    def set_repair_hook(self, hook: Optional[Callable]) -> None:
        """Wire the corruption-repair tier (``hook(basename, crc) ->
        repaired?``) — called by DatasetStore with its replica mirror."""
        self._repair_hook = hook

    def _verify_chunk(self, chunk: "_Chunk") -> None:
        """Checksum one on-disk chunk before its bytes are trusted.

        Fires the ``catalog.chunk.pre_read`` failpoint (the bit-rot
        injection site), then compares the file's CRC32 against the
        journaled value. On mismatch — or a missing file — the repair
        hook (replica mirror) gets one shot at restoring it; if the file
        still doesn't verify, raises :class:`ChunkCorrupt`. Chunks from
        pre-checksum journals (``crc32`` is None) have nothing to verify
        and pass. Idempotent and safe to race: repair lands via
        tmp+rename, and the worst case is two threads both verifying.
        """
        failpoints.fire(FP_CHUNK_PRE_READ, path=chunk.path)
        expected = chunk.crc32
        if expected is None:
            chunk._verified = os.path.isfile(chunk.path)
            if not chunk._verified:
                if self._repair_hook is not None and self._repair_hook(
                        os.path.basename(chunk.path), None):
                    chunk._verified = True
                    return
                raise ChunkCorrupt(chunk.path, None, None)
            return
        actual = (crc32_file(chunk.path) if os.path.isfile(chunk.path)
                  else None)
        if actual == expected:
            chunk._verified = True
            return
        if self._repair_hook is not None and self._repair_hook(
                os.path.basename(chunk.path), expected):
            if os.path.isfile(chunk.path) \
                    and crc32_file(chunk.path) == expected:
                chunk._verified = True
                return
        raise ChunkCorrupt(chunk.path, expected, actual)

    @property
    def mem_bytes(self) -> int:
        """Estimated bytes of chunk data resident in host RAM."""
        with self._data_lock:
            return sum(c.data_bytes for c in self._chunks if c.in_memory)

    @property
    def data_bytes(self) -> int:
        """Estimated total bytes of column data (resident or spilled)."""
        with self._data_lock:
            return sum(c.data_bytes for c in self._chunks)

    # -- writes -------------------------------------------------------------

    def append_columns(self, columns: Columns,
                       src_off: Optional[int] = None) -> None:
        """Append a chunk of rows given as equal-length column arrays.
        ``src_off`` (ingest chunks) journals the source byte offset after
        this chunk's last row for resume."""
        if not columns:
            return
        lengths = {len(v) for v in columns.values()}
        if len(lengths) != 1:
            raise ValueError(f"ragged column chunk: {lengths}")
        cols = {k: np.asarray(v) for k, v in columns.items()}
        if not self.metadata.fields:
            self.metadata.fields = list(cols.keys())
        elif list(cols.keys()) != self.metadata.fields:
            missing = set(self.metadata.fields) - set(cols.keys())
            extra = set(cols.keys()) - set(self.metadata.fields)
            if missing or extra:
                raise ValueError(
                    f"chunk fields mismatch: missing={missing} extra={extra}")
            cols = {k: cols[k] for k in self.metadata.fields}  # reorder
        with self._data_lock:
            chunk = _Chunk(cols)
            chunk.src_off = src_off
            self._chunks.append(chunk)
            self._consolidated = None
            self._maybe_evict_locked()

    def append_arrow(self, batch, src_off: Optional[int] = None) -> None:
        """Append a chunk of rows as a ``pyarrow.RecordBatch`` (the native
        ingest fast path — no Python-object materialization). ``src_off``
        is the source-stream byte offset after this chunk's last row,
        journaled for ingest resume."""
        if batch.num_rows == 0:
            return
        names = list(batch.schema.names)
        if not self.metadata.fields:
            self.metadata.fields = names
        elif names != self.metadata.fields:
            missing = set(self.metadata.fields) - set(names)
            extra = set(names) - set(self.metadata.fields)
            if missing or extra:
                raise ValueError(
                    f"chunk fields mismatch: missing={missing} extra={extra}")
            batch = batch.select(self.metadata.fields)
        with self._data_lock:
            self._chunks.append(_Chunk.from_arrow(batch, src_off))
            self._consolidated = None
            self._maybe_evict_locked()

    def append_rows(self, rows: List[Dict[str, Any]]) -> None:
        """Append row dicts (used by result writers, e.g. predictions)."""
        if not rows:
            return
        fields = self.metadata.fields or list(rows[0].keys())
        cols: Columns = {}
        for f in fields:
            vals = [r.get(f) for r in rows]
            arr = np.asarray(vals)
            if arr.dtype.kind == "U":  # keep strings as object for None-safety
                arr = np.asarray(vals, dtype=object)
            cols[f] = arr
        self.append_columns(cols)

    def set_column(self, name: str, values: np.ndarray) -> None:
        """Replace/add a full column (used by type coercion). Atomic:
        snapshot, length-check, and replacement all happen under the data
        lock so a concurrent append can never be silently dropped.

        Materializes the dataset (coercion is inherently O(n)); previously
        flushed chunk files become stale and are rewritten on next save.
        """
        values = np.asarray(values)
        with self._data_lock:
            cols = dict(self._consolidate_locked())
            n = len(next(iter(cols.values()))) if cols else 0
            if n and len(values) != n:
                raise ValueError(
                    f"column length {len(values)} != num_rows {n}")
            cols[name] = values
            if name not in self.metadata.fields:
                self.metadata.fields.append(name)
            had_disk_state = (self._journal_records > 0
                              or any(c.path is not None
                                     for c in self._chunks))
            self._chunks = [_Chunk({f: cols[f]
                                    for f in self.metadata.fields})]
            self._consolidated = None
            # Only flag a rewrite when journaled files actually describe
            # stale data; a purely in-memory dataset just flushes normally.
            self._rewrite_needed = self._rewrite_needed or had_disk_state
            self._maybe_evict_locked()

    # -- chunk flushing / eviction ------------------------------------------

    def _write_chunk_file_locked(self, chunk: _Chunk) -> Dict[str, Any]:
        """Write one chunk to a new immutable parquet file (tmp + fsync +
        rename + dir fsync) and return its journal record. The caller
        commits the record to the journal."""
        assert self._chunk_dir is not None
        os.makedirs(self._chunk_dir, exist_ok=True)
        # Chunk files are Arrow IPC, uncompressed: writing is essentially
        # a buffer memcpy (~2.5x faster than parquet on the ingest-bound
        # one-core boxes this runs on) and reading is bulk buffer loads.
        # Legacy .parquet chunk files from older journals stay readable
        # (read_chunk_file dispatches on extension).
        fname = f"{self._gen:03d}-{self._next_chunk_id:05d}.arrow"
        self._next_chunk_id += 1
        final = os.path.join(self._chunk_dir, fname)
        tmp = final + ".tmp"
        if chunk.cols is None and chunk.arrow is not None:
            # Arrow chunks write straight from their buffers — no Python
            # string materialization on the ingest flush path.
            write_chunk_arrow_batch(tmp, chunk.arrow)
            dtypes = {f: str(dt) for f, dt in chunk.dtypes.items()}
        else:
            cols = chunk.materialize()
            write_chunk_arrow(tmp, cols, list(cols.keys()))
            # Record what was actually written (consolidation may have
            # promoted a view's dtype past what the chunk was appended
            # with).
            dtypes = {f: str(a.dtype) for f, a in cols.items()}
        # Checksum BEFORE the durability barrier: the journaled CRC32
        # describes what the writer intended, so storage-level damage
        # after this point (torn write, bit rot — or the failpoint below
        # simulating either) is detectable on every later read/scrub.
        crc = crc32_file(tmp)
        _fsync_file(tmp)
        failpoints.fire(FP_WRITE_CHUNK_PRE_RENAME, path=tmp)
        os.replace(tmp, final)
        _fsync_dir(self._chunk_dir)
        chunk.path = final
        chunk.crc32 = crc
        chunk.verify = self._verify_chunk
        chunk._verified = False
        rec = {"file": fname, "rows": chunk.n_rows,
               "bytes": chunk.data_bytes, "dtypes": dtypes, "crc32": crc}
        if chunk.src_off is not None:
            rec["src_off"] = chunk.src_off
        return rec

    def _commit_records_locked(self, records: List[Dict[str, Any]]) -> None:
        """Append journal lines for already-written chunk files with ONE
        fsync — the commit point. Files (and their renames) were fsynced
        before this, so a durable journal entry always references a
        durable file; a crash in between simply drops those chunks and
        recovery sees a consistent prefix (the reference's metadata-first
        idiom at chunk granularity, projection.py:78-123)."""
        if not records:
            return
        t0 = time.monotonic()
        with open(self._journal_path, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
            f.flush()
            # Crash window under test: records written but not yet
            # durable — recovery must land on the journaled prefix
            # (_parse_journal_bytes tolerates a torn tail).
            failpoints.fire(FP_JOURNAL_MID_APPEND, path=self._journal_path)
            os.fsync(f.fileno())
        self._journal_records += len(records)
        # The durability tax of a traced ingest/build, attributed: one
        # span per journal commit (append + fsync). No-op untraced.
        tracing.record_span("journal.commit", time.monotonic() - t0,
                            attrs={"records": len(records),
                                   "dataset": self.metadata.name})

    def _flush_chunk_locked(self, chunk: _Chunk) -> None:
        """Write + journal-commit one chunk (eviction path)."""
        self._commit_records_locked([self._write_chunk_file_locked(chunk)])

    def flush_new_chunks(self) -> List[str]:
        """Flush every not-yet-persisted chunk (store.save's incremental
        commit). All chunk files are written first, then journaled with a
        single fsync — a per-save batch, so a streaming ingest that
        commits every few chunks pays one journal fsync per batch instead
        of one per chunk. Returns the chunk file paths written this call."""
        written = []
        with self._data_lock:
            if self._chunk_dir is None:
                return written
            records = []
            for c in self._chunks:
                if c.path is None:
                    records.append(self._write_chunk_file_locked(c))
                    written.append(c.path)
            self._commit_records_locked(records)
        return written

    def rewrite_generation(self) -> bool:
        with self._data_lock:
            return self._rewrite_generation_locked()

    def _rewrite_generation_locked(self) -> bool:
        """Atomically replace the on-disk chunk state after a set_column
        rebuild. Returns whether a rewrite ran.

        Crash-safe ordering: every new-generation chunk file is written and
        fsynced first (old files untouched), then the *whole* new journal is
        swapped in with one atomic rename. Whichever journal version
        survives a crash references files that exist — there is never a
        window where committed data is unrecoverable. Old-generation files
        are garbage-collected afterwards (deferred while streaming readers
        hold a chunk snapshot)."""
        if not self._rewrite_needed or self._chunk_dir is None:
            return False
        self._gen += 1
        self._next_chunk_id = 0
        records = [self._write_chunk_file_locked(c)
                   for c in self._chunks]
        tmp = self._journal_path + ".tmp"
        with open(tmp, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        # Crash window under test: new-generation files durable, old
        # journal still in place — whichever journal survives references
        # files that exist.
        failpoints.fire(FP_JOURNAL_PRE_SWAP, path=tmp)
        os.replace(tmp, self._journal_path)
        _fsync_dir(os.path.dirname(self._journal_path))
        self._journal_records = len(records)
        self._rewrite_needed = False
        self._gc_locked()
        return True

    def _gc_locked(self) -> None:
        """Remove chunk files the journal no longer references (previous
        generations, orphaned tmp files). Deferred while streaming readers
        hold a chunk snapshot — their lazily-read files must stay valid."""
        if self._chunk_dir is None or not os.path.isdir(self._chunk_dir):
            return
        if self._active_readers:
            self._pending_gc = True
            return
        self._pending_gc = False
        referenced = {os.path.basename(c.path) for c in self._chunks
                      if c.path is not None}
        removed = []
        for fn in os.listdir(self._chunk_dir):
            if fn not in referenced:
                try:
                    os.remove(os.path.join(self._chunk_dir, fn))
                    removed.append(os.path.join(self._chunk_dir, fn))
                except FileNotFoundError:
                    pass
        if removed:
            # Prompt byte-reclaim only — cache keys are CRC-pinned, so a
            # stale entry could never be served wrongly, just held.
            readpipe.invalidate_files(removed)

    @property
    def rewrite_needed(self) -> bool:
        with self._data_lock:
            return self._rewrite_needed

    def journal_snapshot(self, gen: Optional[int] = None,
                         offset: int = 0) -> tuple:
        """Atomic journal snapshot for the store's mirror:
        ``(generation, total_size, data, is_delta)``.

        When ``gen`` matches the current generation, only bytes past
        ``offset`` are read and ``is_delta`` is True — the O(delta) path a
        per-chunk-checkpointing ingest needs (a full read per save would
        be O(total journal), quadratic across the ingest). Otherwise the
        whole journal is returned. Read under the data lock, so neither an
        eviction flush (journal append) nor an inline generation rewrite
        (journal *replacement*) can interleave: the returned bytes always
        end on a record boundary and belong to exactly the returned
        generation."""
        with self._data_lock:
            cur = self._gen
            data = b""
            if self._journal_path is not None:
                try:
                    with open(self._journal_path, "rb") as f:
                        if gen == cur and offset:
                            f.seek(offset)
                            data = f.read()
                            return cur, offset + len(data), data, True
                        data = f.read()
                except FileNotFoundError:
                    pass
            return cur, len(data), data, False

    def journal_size(self) -> tuple:
        """``(generation, journal_bytes)`` without reading the journal —
        the O(1) probe the store's replication lag accounting compares
        against per-peer acked watermarks."""
        with self._data_lock:
            size = 0
            if self._journal_path is not None:
                try:
                    size = os.path.getsize(self._journal_path)
                except OSError:
                    size = 0
            return self._gen, size

    def journal_files(self) -> List[str]:
        """Basenames of the chunk files the current state references —
        the store's GC/mirror source of truth."""
        with self._data_lock:
            return [os.path.basename(c.path) for c in self._chunks
                    if c.path is not None]

    def maybe_evict(self) -> None:
        with self._data_lock:
            self._maybe_evict_locked()

    def _maybe_evict_locked(self) -> None:
        """Drop in-memory chunk data (flushing first) until under budget.

        A pending rewrite (set_column) is committed inline first — flushing
        against the stale journal would corrupt recovery, and waiting for a
        store.save() that persist=False configurations never issue would
        disable the budget permanently.
        """
        if self._ram_budget is None or self._chunk_dir is None:
            return
        if self._rewrite_needed:
            self._rewrite_generation_locked()
        mem = sum(c.data_bytes for c in self._chunks if c.in_memory)
        if mem <= self._ram_budget:
            return
        # Pick victims first, then flush the unpersisted ones as ONE
        # journal batch (single fsync). Evict down to a low-water mark
        # (3/4 budget) rather than just under: appends trigger eviction
        # chunk-by-chunk, and without hysteresis a budgeted streaming
        # ingest would pay a journal fsync per appended chunk — the
        # low-water mark amortizes each fsync over budget/4 bytes.
        low_water = self._ram_budget - self._ram_budget // 4
        victims = []
        last_victim_idx = -1
        for idx, c in enumerate(self._chunks):
            if not c.in_memory or not c.evictable:
                continue
            victims.append(c)
            last_victim_idx = idx
            mem -= c.data_bytes
            if mem <= low_water:
                break
        # Journal IN APPEND ORDER: flush every still-unflushed chunk up to
        # the last victim — including skipped non-evictable ones (they
        # stay resident; flushing them here matches store.save semantics).
        # Journaling only the victims would write their records ahead of
        # earlier chunks', and restore_chunks trusts journal line order —
        # a restart would silently reorder the dataset's rows.
        records = [self._write_chunk_file_locked(c)
                   for c in self._chunks[:last_victim_idx + 1]
                   if c.path is None]
        self._commit_records_locked(records)
        for c in victims:
            c.cols = None
            c.arrow = None

    def restore_chunks(self, records: List[Dict[str, Any]],
                       chunk_dir: str) -> None:
        """Rebuild the chunk list from journal records (store.load) — data
        stays on disk until first access (lazy load). Files the journal no
        longer references (a crash orphaned a half-committed generation)
        are garbage-collected."""
        chunks = []
        max_gen, max_id = 0, -1
        for rec in records:
            dtypes = {f: np.dtype(dt) for f, dt in rec["dtypes"].items()}
            c = _Chunk.on_disk(
                os.path.join(chunk_dir, rec["file"]), rec["rows"], dtypes,
                rec.get("bytes", 0), src_off=rec.get("src_off"),
                crc32=rec.get("crc32"))
            c.verify = self._verify_chunk
            chunks.append(c)
            gen, cid = _parse_chunk_name(rec["file"])
            if (gen, cid) > (max_gen, max_id):
                max_gen, max_id = gen, cid
        with self._data_lock:
            self._chunks = chunks
            self._consolidated = None
            self._gen = max_gen
            self._next_chunk_id = max_id + 1
            self._journal_records = len(records)
            prev_dir = self._chunk_dir
            self._chunk_dir = chunk_dir
            self._gc_locked()
            self._chunk_dir = prev_dir

    def scrub_chunks(self) -> Dict[str, Any]:
        """Eagerly re-verify every journaled chunk file's checksum (the
        proactive integrity pass behind ``DatasetStore.scrub`` /
        ``POST /catalog/scrub``). Ignores the lazy ``_verified`` flag —
        a scrub re-reads every file so rot that set in *after* first
        read is still caught. Repair (replica mirror) runs exactly as on
        the lazy path; unrepairable chunks are reported, not raised, so
        one corrupt dataset doesn't abort a catalog-wide scrub."""
        with self._data_lock:
            chunks = [c for c in self._chunks if c.path is not None]
            # Register as an active reader for the pass: a concurrent
            # generation rewrite (set_column save / budget eviction)
            # must not GC this snapshot's files mid-verification —
            # deleted-under-us files would read as false corruption.
            self._active_readers += 1
        report: Dict[str, Any] = {"checked": 0, "unchecksummed": 0,
                                  "missing": 0, "errors": []}
        try:
            for c in chunks:
                present = os.path.isfile(c.path)
                if c.crc32 is None and present:
                    # Pre-checksum journal record: existence is all we
                    # can attest.
                    report["unchecksummed"] += 1
                    continue
                if not present:
                    # Whole file gone (re-imaged host / deleted chunks
                    # dir): reported distinctly, and verification below
                    # still runs so the repair ladder gets its shot.
                    report["missing"] += 1
                c._verified = False
                try:
                    self._verify_chunk(c)
                    report["checked"] += 1
                except ChunkCorrupt as exc:
                    report["errors"].append(str(exc))
        finally:
            self._release_reader()
        return report

    # -- reads --------------------------------------------------------------

    @property
    def num_rows(self) -> int:
        with self._data_lock:
            return sum(c.n_rows for c in self._chunks)

    @property
    def shard_map(self) -> Optional[dict]:
        """Ownership map a range-partitioned ingest recorded (owner host →
        contiguous row range, in global row order); None for datasets
        ingested serially or written locally. A placement hint only —
        reads never require it (non-local chunks stay reachable through
        the replicate.fetch_chunk repair path)."""
        return self.metadata.extra.get("shard_map")

    @property
    def resume_offset(self) -> Optional[int]:
        """Source-stream byte offset after the last committed ingest chunk
        — where an interrupted ingest resumes. None when the dataset has
        no offset-tracked chunks (non-ingest datasets, or journals written
        before offsets existed: those must not resume, they'd duplicate
        rows)."""
        with self._data_lock:
            if not self._chunks:
                return None
            off = self._chunks[-1].src_off
            return int(off) if off is not None else None

    def _total_bytes_locked(self) -> int:
        return sum(c.data_bytes for c in self._chunks)

    def _consolidate_locked(self) -> Columns:
        """Full materialization; caller must hold ``_data_lock``.

        Cached unless the dataset exceeds its RAM budget — over-budget
        datasets materialize transiently (dense trainers need the full
        design matrix on the way to the device) but the catalog's resident
        footprint stays bounded by the chunk tier.
        """
        if self._consolidated is not None:
            return self._consolidated
        if not self._chunks:
            self._consolidated = {}
            return self._consolidated
        fields = self.metadata.fields
        loaded = [c.materialize() for c in self._chunks]
        if len(loaded) == 1:
            cols = loaded[0]
        else:
            cols = {f: _concat([lc[f] for lc in loaded]) for f in fields}
        if (self._ram_budget is None
                or self._total_bytes_locked() <= self._ram_budget):
            self._consolidated = cols
            if len(self._chunks) > 1:
                # Don't keep two resident copies (per-chunk arrays + the
                # concatenation): purely-in-memory chunk lists merge into
                # one chunk sharing the consolidated arrays; chunks with
                # disk bookkeeping to preserve re-point their resident data
                # at *views* of the consolidation — same values (no drift,
                # no re-reads), one buffer.
                if (not self._rewrite_needed
                        and all(c.path is None for c in self._chunks)):
                    merged = _Chunk(cols)
                    # The merged chunk stands for all rows up to the last
                    # chunk's source offset — resume bookkeeping survives.
                    merged.src_off = self._chunks[-1].src_off
                    self._chunks = [merged]
                else:
                    offset = 0
                    for c in self._chunks:
                        end = offset + c.n_rows
                        c.cols = {f: cols[f][offset:end] for f in fields}
                        c.arrow = None  # views are authoritative now
                        c.dtypes = {f: cols[f].dtype for f in fields}
                        c._evictable = None
                        offset = end
        return cols

    @property
    def columns(self) -> Columns:
        """Consolidated column arrays (cached; invalidated by appends).

        The returned dict is an immutable snapshot: appends build a new
        consolidation rather than mutating these arrays, so callers can
        compute over it without holding the lock."""
        with self._data_lock:
            return self._consolidate_locked()

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def iter_chunks(self, fields: Optional[List[str]] = None,
                    max_chunks: Optional[int] = None,
                    prefetch: Optional[int] = None) -> Iterator[Columns]:
        """Stream the dataset chunk-by-chunk without full materialization —
        the out-of-core compute path (histogram, projection). Spilled
        chunks are read from their chunk files through the prefetching
        read pipeline: while the consumer computes on chunk i, a worker
        pool reads + verifies + decodes chunks i+1..i+K (``prefetch``;
        None = the dataset/process default, 0 = strictly synchronous —
        the parity oracle). Reads go through the shared LRU chunk cache,
        so a second pass over the same snapshot hits warm host RAM.

        Yielded chunks carry *unified* dtypes matching what full
        consolidation would produce: a field that is object (string) in any
        chunk is object in every yielded chunk (`_concat`'s rule), and
        mixed numeric dtypes promote to their ``np.result_type`` (so e.g. a
        column integral in early chunks and float later yields float keys
        everywhere, agreeing with ``value_counts`` on the same data).
        Prefetch never changes yield order or values: futures are consumed
        in submission order and coercion runs on the consumer thread, so
        the pipeline is bit-identical to the synchronous oracle. A worker
        failure (``ChunkCorrupt``, an armed failpoint) re-raises here, on
        the consumer, at the failed chunk's position.

        The snapshot registers as an active reader for its lifetime: chunk
        file GC (generation rewrites) defers until the iterator is
        exhausted or closed, so lazily-read files stay valid — in-flight
        prefetch reads are drained before the registration drops. This is
        a generator function — the snapshot and reader registration happen
        at the first ``next()``, so an iterator that is never started
        never leaks a reader count.

        ``max_chunks`` truncates the snapshot *before* dtype unification:
        the SPMD histogram pins a journaled chunk count so every pod
        process streams identical chunk boundaries AND identical unified
        dtypes even if extra chunks appended on one process since.
        """
        with self._data_lock:
            chunks = list(self._chunks)
            if max_chunks is not None:
                chunks = chunks[:max_chunks]
            self._active_readers += 1
        pipeline = _pipelined_materialize(
            chunks, fields,
            readpipe.prefetch_depth(
                prefetch if prefetch is not None else self._prefetch))
        try:
            coerce = self._make_coercer(chunks, fields)
            for _c, cols in pipeline:
                yield {f: coerce(f, a) for f, a in cols.items()}
        finally:
            # Drain the worker window BEFORE releasing the reader: a
            # deferred generation-rewrite GC must never delete a file a
            # still-running prefetch worker is reading.
            pipeline.close()
            self._release_reader()

    @staticmethod
    def _make_coercer(chunks, want):
        """Per-field dtype coercer unifying a chunk snapshot's dtypes to
        what full consolidation would produce (``iter_chunks``'s contract;
        shared with ``read_rows``)."""
        target: Dict[str, np.dtype] = {}
        seen: Dict[str, set] = {}
        for c in chunks:
            for f, dt in c.dtypes.items():
                if want is None or f in want:
                    seen.setdefault(f, set()).add(dt)
        for f, dts in seen.items():
            if len(dts) > 1:
                target[f] = (np.dtype(object)
                             if any(dt == object for dt in dts)
                             else np.result_type(*dts))
        # Numeric→object coercion stringifies only when the object
        # chunks hold strings (same rule as _concat); object chunks
        # already on disk are strings by construction.
        nonstringy = set()
        if any(t == object for t in target.values()):
            for c in chunks:
                ccols = c.cols
                if ccols is None:
                    continue
                for f, a in ccols.items():
                    if (target.get(f) == object and a.dtype == object
                            and not is_stringy(a)):
                        nonstringy.add(f)

        def _coerce(f: str, a: np.ndarray) -> np.ndarray:
            t = target.get(f)
            if t is None or a.dtype == t:
                return a
            if t != object:
                return a.astype(t)
            return (a.astype(object) if f in nonstringy
                    else stringify_numeric(a))

        return _coerce

    @contextlib.contextmanager
    def snapshot(self, max_chunks: Optional[int] = None):
        """Pin ONE chunk snapshot for multiple reads: every ``read``/
        ``scan`` through the yielded :class:`SnapshotReader` sees the same
        chunk generation, so a paged response evaluated block-by-block can
        never mix pre- and post-``set_column``-rewrite values. Registers
        as an active reader for its lifetime (chunk-file GC defers)."""
        with self._data_lock:
            chunks = list(self._chunks)
            if max_chunks is not None:
                chunks = chunks[:max_chunks]
            self._active_readers += 1
        try:
            yield SnapshotReader(self, chunks)
        finally:
            self._release_reader()

    def pin_snapshot(self) -> "SnapshotReader":
        """Long-lived form of :meth:`snapshot` for readers whose lifetime
        doesn't fit a ``with`` block — a :class:`~learningorchestra_tpu_torch.
        ops.preprocess.ChunkedDesign` reads row ranges lazily for as long
        as a build holds it, and every one of those reads must see the
        same chunk generation (a concurrent ``set_column`` rewrite must
        never mix pre-/post-rewrite rows across fitting passes or device
        shards). The active-reader registration is released when the
        returned reader is garbage-collected, or eagerly via its
        ``release()``."""
        with self._data_lock:
            chunks = list(self._chunks)
            self._active_readers += 1
        reader = SnapshotReader(self, chunks)
        reader._finalizer = weakref.finalize(reader, self._release_reader)
        return reader

    def _release_reader(self) -> None:
        with self._data_lock:
            self._active_readers -= 1
            if self._pending_gc and not self._active_readers:
                self._gc_locked()

    def read_rows(self, fields: Optional[List[str]] = None,
                  start: int = 0, stop: Optional[int] = None,
                  max_chunks: Optional[int] = None) -> Columns:
        """Materialize ONLY the chunks overlapping rows ``[start, stop)``
        and return that row range — O(overlapping chunks) host memory, not
        O(dataset). This is the shard-local read the pod data path builds
        device shards from (each process reads just its own row ranges
        instead of consolidating the full dataset; contrast the
        reference's executors, which likewise hold only their partitions,
        model_builder.py:200). Dtypes are unified exactly as
        ``iter_chunks``/consolidation would, so a range read never sees
        chunk-local dtype drift."""
        with self.snapshot(max_chunks) as snap:
            return snap.read(fields, start, stop)

    @property
    def over_budget(self) -> bool:
        """True when column data exceeds the configured RAM budget — the
        signal for switching from full consolidation to the shard-local
        streamed design-matrix path (ops/preprocess.ChunkedDesign)."""
        with self._data_lock:
            return (self._ram_budget is not None
                    and self._total_bytes_locked() > self._ram_budget)

    #: Most derived artifacts kept per dataset (each can pin a full design
    #: matrix, so the cap bounds resident memory in long-lived servers).
    _MEMO_CAP = 4

    def memo(self, key, builder, token=None):
        """Cache a derived artifact (e.g. a design matrix) against the
        current consolidation snapshot; invalidated by appends/coercion.
        ``token`` adds an extra validity object compared by *identity*
        (e.g. the preprocessing state a test matrix was built with).

        Keeping the artifact's *identity* stable across repeated reads is
        what lets downstream identity-keyed caches hit — in particular the
        mesh runtime's host→device transfer cache, so a server fitting
        repeatedly on the same dataset re-uses the on-device copy instead
        of re-transferring gigabytes per build. Snapshots and tokens are
        stored and compared as objects (``is``), never as raw ``id()``
        integers — a recycled address must not resurrect a stale entry.
        Entries from superseded snapshots are purged, and the cache is
        size-capped, so invalidated design matrices don't pin memory for
        the dataset's lifetime. Over-budget (out-of-core) datasets never
        cache their consolidation, so nothing giant gets pinned for them
        either.
        """
        cols = self.columns  # consolidates; snapshot identity = validity
        with self._data_lock:
            current = self._consolidated is cols
            for k in [k for k, (snap, _, _) in self._memo.items()
                      if snap is not cols]:
                del self._memo[k]
            if current:
                hit = self._memo.get(key)
                if hit is not None and hit[1] is token:
                    return hit[2]
        val = builder()
        if current:
            with self._data_lock:
                if self._consolidated is cols:
                    self._memo[key] = (cols, token, val)
                    while len(self._memo) > self._MEMO_CAP:
                        del self._memo[next(iter(self._memo))]
        return val

    def rows(self, indices: np.ndarray) -> List[Dict[str, Any]]:
        """Materialize row documents (``_id`` = index+1) for the given
        0-based row indices — the read-back path (reference database.py:36-48)."""
        return rows_from(self.columns, self.metadata.fields, indices)

    def numeric_matrix(self, fields: Optional[List[str]] = None) -> np.ndarray:
        """Dense float32 design matrix over the given (default: all numeric)
        fields — the hand-off point from catalog to the TPU mesh."""
        cols = self.columns
        if fields is None:
            fields = [f for f in self.metadata.fields
                      if cols[f].dtype.kind in "ifub"]
        mats = []
        for f in fields:
            c = cols[f]
            if c.dtype.kind not in "ifub":
                raise TypeError(f"field {f!r} is not numeric (dtype {c.dtype})")
            mats.append(np.asarray(c, dtype=np.float32))
        if not mats:
            return np.zeros((self.num_rows, 0), dtype=np.float32)
        return np.stack(mats, axis=1)


# -- chunk parquet IO --------------------------------------------------------

def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        # Durability helper, not a commit point: the two-phase commits
        # that CALL it carry the failpoint sites (write_chunk.pre_rename,
        # journal.pre_swap), so the crash sweep already brackets this.
        os.fsync(fd)  # lolint: disable=failpoint-coverage
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """Durably commit a rename: fsync the containing directory (POSIX —
    best-effort on filesystems that reject directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        # Same as _fsync_file: durability plumbing for commit points
        # that carry their own failpoint sites at the rename itself.
        os.fsync(fd)  # lolint: disable=failpoint-coverage
    except OSError:
        pass
    finally:
        os.close(fd)


def _parse_chunk_name(fname: str) -> tuple:
    """``GGG-NNNNN.arrow`` → (gen, id); legacy ``NNNNN.parquet`` → (0, id)."""
    stem = fname
    for ext in (".arrow", ".parquet"):
        if stem.endswith(ext):
            stem = stem[:-len(ext)]
            break
    parts = stem.split("-")
    try:
        if len(parts) == 2:
            return int(parts[0]), int(parts[1])
        return 0, int(parts[0])
    except ValueError:
        return 0, -1


def _cols_to_arrow_table(cols: Columns, fields: List[str]):
    """Columns → arrow table. Object columns serialize as nullable strings
    (non-string objects stringify — the store's value domain is
    numbers/strings/null, matching the reference's Mongo documents)."""
    import pyarrow as pa

    arrays, names = [], []
    for fname in fields:
        arr = cols[fname]
        if arr.dtype == object:
            arrays.append(pa.array([None if v is None else str(v)
                                    for v in arr], type=pa.string()))
        else:
            arrays.append(pa.array(arr))
        names.append(fname)
    return pa.table(arrays, names=names)


def write_chunk_arrow(path: str, cols: Columns, fields: List[str]) -> None:
    """Columns → Arrow IPC chunk file (uncompressed; see the chunk-format
    note in ``_write_chunk_file_locked``)."""
    _write_arrow_table(path, _cols_to_arrow_table(cols, fields))


def write_chunk_arrow_batch(path: str, batch) -> None:
    """RecordBatch → Arrow IPC chunk file, straight from its buffers."""
    import pyarrow as pa

    _write_arrow_table(path, pa.Table.from_batches([batch]))


def _write_arrow_table(path: str, table) -> None:
    import pyarrow.ipc as ipc

    with ipc.new_file(path, table.schema) as writer:
        writer.write_table(table)


def write_chunk_parquet(path: str, cols: Columns,
                        fields: List[str]) -> None:
    """Columns → parquet (legacy chunk format; kept for tooling/tests that
    exercise the .parquet read fallback)."""
    import pyarrow.parquet as pq

    pq.write_table(_cols_to_arrow_table(cols, fields), path)


def read_chunk_file(path: str,
                    fields: Optional[List[str]] = None) -> Columns:
    """Chunk file → Columns (string columns come back as object arrays
    with ``None`` for nulls, numerics as their numpy dtypes). Dispatches
    on extension: Arrow IPC for current files, parquet for chunks
    journaled by older builds."""
    if path.endswith(".parquet"):
        return read_chunk_parquet(path, fields)
    import pyarrow.ipc as ipc

    with ipc.open_file(path) as reader:
        table = reader.read_all()
    if fields is not None:
        table = table.select([f for f in fields
                              if f in table.column_names])
    return {fname: table.column(fname).to_numpy(zero_copy_only=False)
            for fname in table.column_names}


def read_chunk_parquet(path: str,
                       fields: Optional[List[str]] = None) -> Columns:
    """Legacy parquet chunk file → Columns.

    Read single-threaded without pre-buffering: chunk files are a few MB
    (decode parallelism would not pay for itself), and avoiding pyarrow's
    internal IO pool is defense-in-depth against the jax+pyarrow
    init-order hazard documented in catalog/__init__.py."""
    import pyarrow.parquet as pq

    table = pq.read_table(path, columns=fields, use_threads=False,
                          pre_buffer=False)
    cols: Columns = {}
    for fname in table.column_names:
        cols[fname] = table.column(fname).to_numpy(zero_copy_only=False)
    return cols


def is_stringy(a: np.ndarray) -> bool:
    """Whether an object column holds only str/None — the CSV value domain
    (as opposed to e.g. float scores with None gaps from ``append_rows``)."""
    return all(v is None or isinstance(v, str) for v in a)


def _concat(arrays: List[np.ndarray]) -> np.ndarray:
    """Concatenate column chunks, reconciling dtypes.

    Chunked parsing infers dtypes per chunk, so a column can arrive numeric
    in early chunks and object (string) later (e.g. 'N/A' first appears at
    row 70k). A whole-file parse would have made every value a string, so on
    conflict numeric values are stringified (ints exactly; NaN → None) to
    keep one consistent value domain for queries and value_counts. That
    rule only applies when the object chunks actually hold strings: object
    chunks carrying numbers (floats with None gaps) keep their numeric
    values and the numeric chunks join them as objects."""
    has_obj = any(a.dtype == object for a in arrays)
    if has_obj and any(a.dtype != object for a in arrays):
        if all(is_stringy(a) for a in arrays if a.dtype == object):
            arrays = [stringify_numeric(a) if a.dtype != object else a
                      for a in arrays]
        else:
            arrays = [a.astype(object) if a.dtype != object else a
                      for a in arrays]
    return np.concatenate(arrays)


def stringify_numeric(a: np.ndarray) -> np.ndarray:
    """Numeric column → object strings: NaN → None, integral floats print
    as ints. The single number→string value-domain rule, shared with the
    fieldtypes coercion op (ops/dtypes.py; reference
    data_type_handler.py:63-70)."""
    out = np.empty(len(a), dtype=object)
    is_float = a.dtype.kind == "f"
    for i, v in enumerate(a):
        if is_float and np.isnan(v):
            out[i] = None
        elif is_float and v == int(v):
            out[i] = str(int(v))
        else:
            out[i] = str(v)
    return out


def _pipelined_materialize(chunks: List["_Chunk"],
                           fields: Optional[List[str]],
                           depth: int):
    """Yield ``(chunk, columns)`` in chunk order, materializing up to
    ``depth`` chunks ahead on the shared readpipe worker pool — the
    asynchronous read pipeline under ``iter_chunks`` / ``scan``.

    ``depth <= 0`` (or a trivial snapshot) degenerates to the exact
    synchronous loop — the parity oracle. Otherwise a bounded sliding
    window of futures keeps at most ``depth`` reads in flight; results
    are consumed strictly in submission order, so chunk order (and
    therefore SPMD device-op alignment) is deterministic, and a worker
    exception re-raises on the consumer thread at the failed chunk's
    position instead of hanging the stream. On close/abandonment the
    window is cancelled and in-flight reads are waited out, so callers
    can safely drop reader registrations (chunk-file GC) afterwards."""
    t0 = time.monotonic()
    hits0, misses0 = readpipe.cache_probe()
    produced = 0
    window: deque = deque()          # (chunk, future), submission order
    try:
        if depth <= 0 or len(chunks) <= 1:
            for c in chunks:
                yield c, c.materialize(fields)
                produced += 1
            return
        pool = readpipe.pool()
        nxt = 0
        while nxt < len(chunks) and len(window) < depth:
            c = chunks[nxt]
            nxt += 1
            window.append((c, pool.submit(c.materialize, fields)))
        while window:
            c, fut = window.popleft()
            if not fut.done():
                readpipe.bump("prefetch_stalls")
            try:
                cols = fut.result()
            except BaseException:
                readpipe.bump("worker_errors")
                raise
            readpipe.bump("prefetched_chunks")
            if nxt < len(chunks):
                c2 = chunks[nxt]
                nxt += 1
                window.append((c2, pool.submit(c2.materialize, fields)))
            yield c, cols
            produced += 1
    finally:
        for _c, fut in window:
            fut.cancel()
        for _c, fut in window:
            if not fut.cancelled():
                try:
                    fut.result()
                except BaseException:  # noqa: BLE001 — result discarded
                    pass
        # One span per scan (not per chunk), covering first-next →
        # exhaustion/close on the consumer thread — the read-pipeline
        # leg of a traced job's time. No-op without an ambient trace.
        # Cache traffic is a global-counter delta: exact for a lone
        # scan, approximate while scans overlap.
        hits1, misses1 = readpipe.cache_probe()
        tracing.record_span(
            "readpipe.materialize", time.monotonic() - t0,
            attrs={"chunks": produced, "snapshot_chunks": len(chunks),
                   "depth": depth, "cache_hits": hits1 - hits0,
                   "cache_misses": misses1 - misses0})


class SnapshotReader:
    """Row reads over one pinned chunk snapshot (``Dataset.snapshot``).

    All reads through one instance see the same chunk generation —
    ``set_column`` rewrites replace the dataset's chunk list, but never
    this captured one (the enclosing context's active-reader registration
    keeps the chunk files alive). Coercers are cached per field-selection
    so repeated scans/reads don't re-derive dtype unification."""

    def __init__(self, ds: "Dataset", chunks: List["_Chunk"]):
        self._ds = ds
        self._chunks = chunks
        self.n_rows = sum(c.n_rows for c in chunks)
        self._coercers: Dict[Any, Any] = {}
        #: Set by Dataset.pin_snapshot; context-managed snapshots release
        #: through their ``with`` block instead.
        self._finalizer = None

    def release(self) -> None:
        """Eagerly release a pinned snapshot (``Dataset.pin_snapshot``);
        idempotent, and a no-op for context-managed snapshots."""
        if self._finalizer is not None:
            self._finalizer()

    def _coercer(self, fields: Optional[List[str]]):
        key = None if fields is None else tuple(fields)
        got = self._coercers.get(key)
        if got is None:
            got = Dataset._make_coercer(self._chunks, fields)
            self._coercers[key] = got
        return got

    def read(self, fields: Optional[List[str]], start: int,
             stop: Optional[int]) -> Columns:
        """Rows ``[start, stop)`` — materializes only overlapping chunks,
        slicing before coercion (O(range), not O(chunk))."""
        coerce = self._coercer(fields)
        stop = self.n_rows if stop is None else min(stop, self.n_rows)
        start = max(0, min(start, stop))
        parts: List[Columns] = []
        off = 0
        for c in self._chunks:
            end = off + c.n_rows
            if end > start and off < stop:
                cols = c.materialize(fields)
                lo, hi = max(start - off, 0), min(stop - off, c.n_rows)
                parts.append({f: coerce(f, a[lo:hi])
                              for f, a in cols.items()})
            off = end
            if off >= stop:
                break
        if not parts:
            flds = (fields if fields is not None
                    else list(self._ds.metadata.fields))
            dts = {f: dt for c in self._chunks
                   for f, dt in c.dtypes.items()}
            # Coerce the empties too, so an empty page carries the same
            # unified dtypes as any non-empty read.
            return {f: coerce(f, np.empty(0, dtype=dts.get(f, object)))
                    for f in flds}
        if len(parts) == 1:
            return parts[0]
        return {f: _concat([p[f] for p in parts]) for f in parts[0]}

    def scan(self, fields: Optional[List[str]] = None,
             block_rows: int = 1 << 16, prefetch: Optional[int] = None):
        """Yield ``(offset, n_block, cols)`` row blocks over the snapshot
        — each chunk materialized once, split into ≤``block_rows`` pieces.
        ``fields`` projects columns (a filtered read scans only the
        query's fields); ``cols`` may be empty when ``fields`` is, which
        is why the block length is yielded explicitly. Chunks stream
        through the prefetching read pipeline (next chunks read/decoded
        by workers while the consumer computes on this one; ``prefetch``
        None = the dataset/process default, 0 = synchronous oracle) and
        the shared chunk cache, so a second scan of the same snapshot —
        the fused streamed-fit's second pass — hits warm host RAM."""
        coerce = self._coercer(fields)
        off = 0
        pipeline = _pipelined_materialize(
            self._chunks, fields,
            readpipe.prefetch_depth(
                prefetch if prefetch is not None else self._ds._prefetch))
        try:
            for c, cols in pipeline:
                for s in range(0, c.n_rows, block_rows):
                    e = min(s + block_rows, c.n_rows)
                    yield (off + s, e - s,
                           {f: coerce(f, a[s:e]) for f, a in cols.items()})
                off += c.n_rows
        finally:
            # Abandoned scans (a filtered read that early-outs) must
            # drain in-flight prefetch reads before the enclosing
            # snapshot's reader registration can release.
            pipeline.close()


def rows_from(cols: Columns, fields: List[str], indices: np.ndarray,
              id_offset: int = 0) -> List[Dict[str, Any]]:
    """Materialize row docs from a column snapshot (lock-free).
    ``id_offset`` shifts ``_id`` for block-streamed reads, where ``cols``
    holds a row range starting at that global offset."""
    out = []
    for i in indices:
        doc = {"_id": int(i) + 1 + id_offset}
        for f in fields:
            doc[f] = _pyval(cols[f][i])
        out.append(doc)
    return out


def _pyval(v):
    """numpy scalar → plain Python (JSON-serializable) value."""
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and v != v:  # NaN → null in JSON
        return None
    return v
