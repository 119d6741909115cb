"""DatasetStore — the catalog: thread-safe named-dataset registry + queries
+ disk persistence.

Replaces the reference's MongoDB replica set as the universal data plane
(reference docker-compose.yml:27-91). The API surface mirrors what the 7
microservices actually used Mongo for (SURVEY.md §1/L4):

- collection-per-file naming, create/get/delete/list
  (reference database.py:94-130),
- paginated, filtered, ``_id``-sorted reads (database.py:36-48,107-111),
- metadata read/update incl. the ``finished`` flip (database.py:177-181),
- value-count aggregation for histograms (histogram.py:49-74) — here a
  vectorized method instead of a Mongo ``$group`` pipeline.

Queries support the Mongo operator set a reference client could reach by
passing JSON straight to ``find()`` (reference database.py:44-48): equality,
``$gt/$gte/$lt/$lte/$ne/$eq/$in/$nin/$exists/$regex/$not``, the logical
combinators ``$and/$or/$nor``, and dotted paths into nested documents —
evaluated vectorized over columns. Persistence is parquet + metadata.json
per dataset under ``settings.store_root`` — the durability tier replacing
Mongo volumes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch.catalog import readpipe, replicate
from learningorchestra_tpu_torch.catalog.dataset import (
    ChunkCorrupt, Columns, Dataset, Metadata, _fsync_dir, crc32_file,
    rows_from as _rows_from)
from learningorchestra_tpu_torch.config import Settings, settings as global_settings
from learningorchestra_tpu_torch.utils import failpoints

#: Deterministic fault-injection sites (utils/failpoints.py).
FP_MIRROR_PRE_COPY = failpoints.declare("store.mirror.pre_copy")
FP_FINISH_PRE_SAVE = failpoints.declare("store.finish.pre_save")
FP_SAVE_PRE_META_SWAP = failpoints.declare("store.save.pre_meta_swap")
FP_REPAIR_PRE_INSTALL = failpoints.declare("store.repair.pre_install")
FP_SHARDMAP_PRE_SWAP = failpoints.declare("store.shardmap.pre_swap")


class DatasetNotFound(KeyError):
    pass


class DatasetExists(ValueError):
    pass


class DatasetFailed(RuntimeError):
    """``finish`` refused: the dataset already carries a failure record."""


#: Dataset names become directory names under store_root and arrive from the
#: REST API, so they must never traverse paths.
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.\-]*$")

#: Row-block size for streamed filtered reads — bounds per-request host
#: memory while amortizing per-block query-evaluation overhead.
_READ_BLOCK_ROWS = 1 << 16


def validate_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME_RE.match(name) or ".." in name:
        raise ValueError(
            f"invalid dataset name {name!r}: use letters, digits, '_', '-', "
            "'.' (must start with a letter or digit)")
    return name


def column_value_counts(col: np.ndarray) -> Dict[Any, int]:
    """Value→count mapping for one column; missing values (None/NaN) bucket
    under the None key (Mongo $group keeps null as a distinct group key).
    Shared by ``DatasetStore.value_counts`` and the histogram op's host
    fallback (ops/histogram.py)."""
    if col.dtype == object:
        # pandas' hash-based value_counts is ~3x np.unique on object
        # arrays (no sort of Python strings) — the streaming histogram
        # calls this per chunk. Keys stringify, matching the historical
        # astype(str) domain for the rare non-string object cell.
        import pandas as pd

        try:
            vc = pd.Series(col, dtype=object).value_counts(dropna=True)
        except TypeError:
            # Unhashable cells (e.g. the dict-valued 'counts' column that
            # create_histogram writes): per-cell walk with the SAME key
            # domain as the hashable path below — scalars keep native
            # type, everything else stringifies, NaN/None bucket under
            # None — so which branch a chunk takes never changes its keys.
            out = {}
            n_null = 0
            for v in col:
                if v is None or (isinstance(v, (float, np.floating))
                                 and v != v):
                    n_null += 1
                    continue
                if isinstance(v, np.generic):
                    v = v.item()
                if not isinstance(v, (str, int, float)):
                    v = str(v)
                out[v] = out.get(v, 0) + 1
        else:
            # Key domain must match the histogram device path, which
            # returns NATIVE int keys (ops/histogram.py field_counts): a
            # column whose chunks flip between int64 and object dtype
            # (per-block type inference on mixed data) must not split one
            # value's count across an int bucket and a str bucket. So
            # numeric keys stay native; only non-scalar cells stringify —
            # accumulated, not overwritten, since distinct unhashables can
            # stringify alike.
            out = {}
            for k, c in vc.items():
                if isinstance(k, np.generic):
                    k = k.item()
                if not isinstance(k, (str, int, float)):
                    k = str(k)
                out[k] = out.get(k, 0) + int(c)
            n_null = len(col) - int(vc.sum())
        if n_null:
            out[None] = n_null
        return out
    null_mask = (np.isnan(col) if col.dtype.kind == "f"
                 else np.zeros(len(col), dtype=bool))
    vals = col[~null_mask]
    uniq, counts = np.unique(vals, return_counts=True)
    out = {}
    for u, c in zip(uniq, counts):
        u = u.item() if isinstance(u, np.generic) else u
        out[u] = int(c)
    n_null = int(null_mask.sum())
    if n_null:
        out[None] = n_null
    return out


class DatasetStore:
    """In-memory catalog of named datasets with optional disk persistence."""

    def __init__(self, cfg: Optional[Settings] = None):
        self.cfg = cfg or global_settings
        self._lock = threading.RLock()
        self._datasets: Dict[str, Dataset] = {}
        #: (generation, journal bytes) already mirrored to the replica,
        #: per dataset — keeps per-save mirroring O(delta) and detects
        #: journal replacement across rewrites/restarts.
        self._mirror_state: Dict[str, tuple] = {}
        #: Interrupted source-URL ingests found by the last load_all
        #: (resume_ingests=True) — the serving layer resubmits these.
        self.resumable_ingests: List[str] = []
        #: Data-plane integrity counters, served on GET /metrics:
        #: corrupt chunk detections, successful replica repairs, and
        #: scrub activity.
        self._integrity_lock = threading.Lock()
        self._integrity = {"chunks_corrupt": 0, "chunks_repaired": 0,
                           "chunks_scrubbed": 0, "scrub_runs": 0}
        #: Peer replication plane (catalog/replicate.py). _peer_state
        #: generalizes _mirror_state's (generation, journal-bytes)
        #: watermark per (peer addr, dataset): acked means the peer has
        #: committed that exact journal prefix, so journal_bytes - acked
        #: is the dataset's replication lag — under-replication is
        #: *known*, not hoped. Pushes run on a single async committer
        #: thread (same single-slot discipline as ingest's chunk
        #: committer); failures land in _push_failing and surface via
        #: replication_snapshot / the data_under_replicated alert.
        self._peers: List[str] = replicate.parse_peers(
            self.cfg.replica_peers)
        self._push_cv = threading.Condition(threading.Lock())
        self._push_dirty: set = set()
        self._push_inflight: Optional[str] = None
        self._push_thread: Optional[threading.Thread] = None
        self._push_stop = False
        self._peer_state: Dict[Tuple[str, str], tuple] = {}
        self._push_failing: Dict[Tuple[str, str], str] = {}
        self._push_attempt: Dict[str, float] = {}
        self._repl = {"pushes": 0, "push_bytes": 0, "fetches": 0,
                      "repairs": 0, "errors": 0}

    def _bump(self, key: str, by: int = 1) -> None:
        with self._integrity_lock:
            self._integrity[key] += by

    def integrity_snapshot(self) -> Dict[str, int]:
        """Corruption/repair counters (GET /metrics ``integrity`` block)."""
        with self._integrity_lock:
            return dict(self._integrity)

    def _bump_repl(self, key: str, by: int = 1) -> None:
        with self._integrity_lock:
            self._repl[key] = self._repl.get(key, 0) + by

    def _forget_peer_state(self, name: str) -> None:
        """Drop all replication bookkeeping for a dataset (delete /
        reopen): the next save starts a fresh full sync."""
        with self._push_cv:
            self._push_dirty.discard(name)
            self._push_attempt.pop(name, None)
            for key in [k for k in self._peer_state if k[1] == name]:
                del self._peer_state[key]
            for key in [k for k in self._push_failing if k[1] == name]:
                del self._push_failing[key]

    # -- lifecycle ----------------------------------------------------------

    def create(self, name: str, *, url: Optional[str] = None,
               parent: Optional[str] = None, finished: bool = False,
               columns: Optional[Columns] = None,
               extra: Optional[Dict[str, Any]] = None) -> Dataset:
        validate_name(name)
        with self._lock:
            if name in self._datasets:
                # Reference returns 409 on duplicate filename
                # (database_api_image/server.py:44-48).
                raise DatasetExists(name)
            meta = Metadata(name=name, url=url, parent=parent,
                            finished=finished, extra=dict(extra or {}))
            ds = Dataset(meta, columns)
            self._attach_storage(ds)
            self._datasets[name] = ds
        if self.cfg.persist:
            # Persist the metadata-first state immediately: a crash between
            # create and commit must leave a recoverable record, so restart
            # can mark the job interrupted instead of losing the dataset
            # (pollers would 404 forever otherwise).
            self.save(name)
        return ds

    def get(self, name: str) -> Dataset:
        with self._lock:
            try:
                return self._datasets[name]
            except KeyError:
                raise DatasetNotFound(name) from None

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._datasets

    def delete(self, name: str) -> None:
        with self._lock:
            if name not in self._datasets:
                raise DatasetNotFound(name)
            del self._datasets[name]
            self._mirror_state.pop(name, None)
        self._forget_peer_state(name)
        path = self._path(name)
        # Reclaim the dataset's cached chunk reads promptly (keys are
        # CRC-pinned, so this is about bytes, not correctness).
        readpipe.invalidate_under(os.path.join(path, "chunks"))
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        if self.cfg.replica_root:
            rpath = os.path.join(self.cfg.replica_root, name)
            if os.path.isdir(rpath):
                shutil.rmtree(rpath, ignore_errors=True)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._datasets)

    # -- metadata / completion protocol -------------------------------------

    def metadata_docs(self) -> List[Dict[str, Any]]:
        """All metadata docs — the reference's ``read_files_descriptor``
        listing (database_api_image/server.py:79-87)."""
        with self._lock:
            return [d.metadata.to_doc() for d in self._datasets.values()]

    def finish(self, name: str, **extra) -> None:
        """Flip ``finished`` true and persist — the commit point
        (reference database.py:177-181, projection.py:113-123).

        A dataset already marked FAILED refuses to flip to success: the
        pod watchdog fails a job's outputs the moment a worker dies
        mid-job, and the surviving process's compute may still run to
        completion afterwards (death after the worker's last collective)
        — its late ``finish`` must not overwrite the recorded failure
        with a half-a-pod success."""
        ds = self.get(name)
        if ds.metadata.finished and ds.metadata.error:
            raise DatasetFailed(
                f"dataset {name} is already marked failed "
                f"({ds.metadata.error}); refusing to mark it finished")
        ds.metadata.extra.update(extra)
        ds.metadata.finished = True
        failpoints.fire(FP_FINISH_PRE_SAVE)
        if self.cfg.persist:
            self.save(name)

    def install_shard_map(self, name: str, shard_map: Dict[str, Any]) -> None:
        """Record a range-partitioned ingest's ownership map (owner host →
        contiguous row range; global row order = partition order) in the
        dataset's metadata, where it rides the atomic ``save`` swap and
        the ``journal_sync`` metadata doc to replica peers. The map is a
        pure placement hint: a crash in the window before the metadata
        swap (the failpoint below) leaves a dataset that is fully
        readable and resumable, merely unplanned — ``mesh.shard_chunked``
        treats a missing map as unsharded."""
        ds = self.get(name)
        ds.metadata.extra["shard_map"] = shard_map
        failpoints.fire(FP_SHARDMAP_PRE_SWAP)
        if self.cfg.persist:
            self.save(name)

    def fail(self, name: str, error: str) -> None:
        """Record job failure so pollers don't spin forever (fixes the
        reference's finished:false-forever failure mode, SURVEY.md §5).

        First failure wins: a dataset already in a terminal state keeps
        its original record — the root cause (e.g. the watchdog's ``pod
        failure:`` flag, which the retry rescan keys on) must not be
        overwritten by downstream errors cascading from it."""
        ds = self.get(name)
        if ds.metadata.finished:
            return
        ds.metadata.error = error
        ds.metadata.finished = True
        if self.cfg.persist:
            self.save(name)

    def reopen(self, name: str) -> Dataset:
        """Reset a failed dataset for an automatic re-run (the job-retry
        path, serving/app.py): clear the failure record, drop any
        partially-written rows (a re-run appending after a partial save
        would duplicate them), and count the attempt in ``retries``. The
        journaled chunk store makes this safe — the replaced incarnation's
        chunk files are simply never referenced again."""
        ds = self.get(name)
        meta = ds.metadata
        meta.error = None
        meta.finished = False
        meta.fields = []
        meta.extra["retries"] = int(meta.extra.get("retries", 0) or 0) + 1
        fresh = Dataset(meta)
        path = self._path(name)
        readpipe.invalidate_under(os.path.join(path, "chunks"))
        shutil.rmtree(os.path.join(path, "chunks"), ignore_errors=True)
        for fn in ("journal.jsonl", "data.parquet"):
            try:
                os.remove(os.path.join(path, fn))
            except FileNotFoundError:
                pass
        self._attach_storage(fresh)
        with self._lock:
            self._datasets[name] = fresh
            self._mirror_state.pop(name, None)
        self._forget_peer_state(name)
        if self.cfg.persist:
            self.save(name)
        return fresh

    # -- reads ---------------------------------------------------------------

    def read(self, name: str, skip: int = 0, limit: int = 10,
             query: Optional[Dict[str, Any]] = None) -> List[Dict[str, Any]]:
        """Paginated filtered read, ``_id``-sorted, metadata doc included when
        it matches — mirrors ``DatabaseApi.read_file``
        (reference database.py:36-48, server.py:62-76)."""
        ds = self.get(name)
        query = query or {}
        if limit <= 0:
            return []
        docs: List[Dict[str, Any]] = []
        meta_doc = ds.metadata.to_doc()
        n_meta = 1 if _doc_matches(meta_doc, query) else 0
        if n_meta and skip == 0:
            docs.append(meta_doc)
        if len(docs) >= limit:
            # Early out before touching column data: the client's 3-second
            # completion poll is read(limit=1) (reference __init__.py:26-32)
            # and must stay O(1) — consolidating an out-of-core dataset to
            # answer it would read every chunk from disk.
            return docs
        row_skip = max(0, skip - n_meta)
        remaining = limit - len(docs)
        if remaining <= 0:
            return docs
        fields = ds.metadata.fields
        # Row reads never consolidate: only the chunks overlapping each
        # requested range are touched, so paging a spilled 50M-row dataset
        # reads O(page) — the reference pushed skip/limit into the Mongo
        # cursor for the same reason (database.py:107-111). The whole
        # request runs over ONE pinned chunk snapshot: a concurrent
        # set_column generation rewrite can never mix pre- and
        # post-rewrite values within a single response.
        with ds.snapshot() as snap:
            if not query:
                stop = min(row_skip + remaining, snap.n_rows)
                block = snap.read(None, row_skip, stop)
                k = len(next(iter(block.values()))) if block else 0
                docs.extend(_rows_from(block, fields, np.arange(k),
                                       id_offset=row_skip))
                return docs
            # Filtered read: scan only the QUERY's columns block-by-block
            # (with each block's global ``_id`` offset), stop as soon as
            # skip+limit matches are found, and fetch full rows just for
            # the matches — a selective 1-column predicate over a wide
            # dataset never decompresses the other columns of
            # non-matching blocks.
            to_skip = row_skip
            for off, n_blk, block in snap.scan(_query_fields(query, fields),
                                               block_rows=_READ_BLOCK_ROWS):
                idx = self._query_indices(block, fields, query,
                                          id_offset=off, n=n_blk)
                if to_skip:
                    dropped = min(to_skip, len(idx))
                    idx = idx[dropped:]
                    to_skip -= dropped
                take = idx[:remaining]
                if len(take):
                    g = take + off
                    lo, hi = int(g.min()), int(g.max()) + 1
                    full = snap.read(None, lo, hi)
                    docs.extend(_rows_from(full, fields, g - lo,
                                           id_offset=lo))
                    remaining -= len(take)
                if remaining <= 0:
                    break
            return docs

    @staticmethod
    def _query_indices(cols, fields: List[str], query: Dict[str, Any],
                       id_offset: int = 0,
                       n: Optional[int] = None) -> np.ndarray:
        if n is None:
            n = len(next(iter(cols.values()))) if cols else 0

        def resolve(field: str):
            if field == "_id":
                return (np.arange(id_offset + 1, id_offset + n + 1),
                        np.ones(n, dtype=bool))
            if field in cols:
                vals = cols[field]
                if vals.dtype == object:
                    exists = np.array([v is not None for v in vals],
                                      dtype=bool)
                elif vals.dtype.kind == "f":
                    exists = ~np.isnan(vals)
                else:
                    exists = np.ones(n, dtype=bool)
                return vals, exists
            if "." in field:
                # Dotted path into an object column of nested documents
                # (Mongo path traversal; flat CSV columns rarely hit this,
                # but query parity requires it).
                root, rest = field.split(".", 1)
                if root in cols and cols[root].dtype == object:
                    out = np.empty(n, dtype=object)
                    exists = np.zeros(n, dtype=bool)
                    for i, v in enumerate(cols[root]):
                        got, ok = _traverse(v, rest)
                        out[i] = got
                        exists[i] = ok
                    return out, exists
            return np.full(n, None, dtype=object), np.zeros(n, dtype=bool)

        return np.nonzero(_eval_query_mask(query, resolve, n))[0]

    # -- aggregation ---------------------------------------------------------

    def value_counts(self, name: str, field: str) -> Dict[Any, int]:
        """Per-value counts of a column — the reference's histogram
        aggregation ``[{"$group": {"_id": "$field", "count": {"$sum": 1}}}]``
        (histogram.py:49-74), vectorized.

        Streams chunk-by-chunk and merges per-chunk counts, like the
        histogram op (ops/histogram.py) — never consolidates, so this
        stays O(one chunk) in host memory on a spilled dataset (this was
        the last O(dataset) read on the catalog surface). ``iter_chunks`` yields consolidation's *unified*
        dtypes, so per-chunk key domains match the resident counts
        exactly (native numeric keys stay native, None buckets NaN/None,
        unhashables stringify)."""
        ds = self.get(name)
        if field not in ds.metadata.fields:
            raise KeyError(field)
        totals: Dict[Any, int] = {}
        for cols in ds.iter_chunks([field]):
            for k, v in column_value_counts(cols[field]).items():
                totals[k] = totals.get(k, 0) + v
        return totals

    # -- persistence ---------------------------------------------------------
    #
    # On-disk layout per dataset (store_root/<name>/):
    #   metadata.json        — small, rewritten atomically (tmp+rename)
    #   journal.jsonl        — append-only, fsynced chunk-commit log
    #   chunks/00000.parquet — immutable chunk files (tmp+rename)
    # Legacy single-file layout (data.parquet) remains loadable.
    #
    # A commit (``save``) costs O(new chunks) + one small metadata write —
    # never a full rewrite — replacing the reference's per-row Mongo
    # inserts (database.py:176) with journaled columnar chunk appends.

    def _path(self, name: str) -> str:
        # Defense in depth alongside validate_name at create time.
        validate_name(name)
        return os.path.join(self.cfg.store_root, name)

    def _attach_storage(self, ds: Dataset) -> None:
        """Wire a dataset to its chunk dir / journal / RAM budget. Spilling
        works even with persist=False (chunk files land under store_root
        and die with the dataset)."""
        path = os.path.join(self.cfg.store_root, ds.metadata.name)
        budget = (self.cfg.ram_budget_mb * (1 << 20)
                  if self.cfg.ram_budget_mb else None)
        ds.attach_storage(os.path.join(path, "chunks"),
                          os.path.join(path, "journal.jsonl"),
                          ram_budget_bytes=budget,
                          prefetch_chunks=self.cfg.prefetch_chunks)
        name = ds.metadata.name
        ds.set_repair_hook(
            lambda fname, crc, _n=name: self._repair_chunk(_n, fname, crc))

    def _repair_chunk(self, name: str, fname: str,
                      expected_crc: Optional[int]) -> bool:
        """A chunk file failed verification (checksum mismatch / missing)
        — the self-healing tier. Counts the detection, then walks the
        repair ladder: the local replica mirror first (cheap, same
        host), then a CRC-verified remote fetch from any configured peer
        holding the dataset — so bit-rot and whole-host loss heal
        through the same ChunkCorrupt path. Returns whether a verified
        copy was installed."""
        self._bump("chunks_corrupt")
        if self._repair_from_mirror(name, fname, expected_crc):
            return True
        return self._repair_from_peers(name, fname, expected_crc)

    def _install_repair(self, name: str, fname: str,
                        src_path: Optional[str] = None,
                        data: Optional[bytes] = None) -> None:
        """Land a verified replacement chunk via tmp+rename so a
        concurrent reader never sees a half-copied file — the shared
        tail of both repair rungs (``src_path`` from the local mirror,
        ``data`` fetched from a peer)."""
        dst_dir = os.path.join(self.cfg.store_root, name, "chunks")
        os.makedirs(dst_dir, exist_ok=True)
        dst = os.path.join(dst_dir, fname)
        tmp = dst + ".repair"
        if src_path is not None:
            shutil.copy2(src_path, tmp)
        else:
            with open(tmp, "wb") as f:
                f.write(data or b"")
                f.flush()
                os.fsync(f.fileno())
        # Crash/torn window mid-repair: the corrupt primary (or a torn
        # .repair tmp) survives and the next read re-enters repair
        # idempotently.
        failpoints.fire(FP_REPAIR_PRE_INSTALL, path=tmp)
        os.replace(tmp, dst)
        _fsync_dir(dst_dir)
        # The pre-repair file may have been read (and CACHED) after rot
        # set in — lazy verification only covers the first read, so such
        # bytes enter the cache under the journal CRC key. Repair is the
        # one event that proves the old reads can't be trusted: drop
        # them so the next read re-decodes the verified replacement.
        # Both rungs — local mirror AND remote fetch — must pass through
        # here: a remotely healed file with stale cache entries would
        # serve the old decoded bytes under the new file's CRC key.
        readpipe.invalidate_files([dst])
        self._bump("chunks_repaired")

    def _repair_from_mirror(self, name: str, fname: str,
                            expected_crc: Optional[int]) -> bool:
        """Rung 1: restore from the local replica mirror when one is
        configured AND its copy itself verifies (a replica that mirrored
        the same rot must not 'repair' corrupt bytes over corrupt
        bytes)."""
        if not self.cfg.replica_root:
            return False
        src = os.path.join(self.cfg.replica_root, name, "chunks", fname)
        if not os.path.isfile(src):
            return False
        if expected_crc is not None and crc32_file(src) != expected_crc:
            return False
        self._install_repair(name, fname, src_path=src)
        return True

    def _repair_from_peers(self, name: str, fname: str,
                           expected_crc: Optional[int]) -> bool:
        """Rung 2: CRC-verified remote fetch from any peer holding the
        dataset. The client side verifies the received bytes against the
        journal CRC before anything is installed, and the serving peer
        re-verifies before replying — corrupt bytes cannot cross the
        wire in either direction undetected."""
        if not self._peers:
            return False
        for peer in self._peers:
            try:
                with replicate.ReplicaClient(
                        peer, self.cfg.replica_timeout_s) as cli:
                    data = cli.fetch_chunk(name, fname, expected_crc)
            except (replicate.ReplicaError, OSError, RuntimeError):
                # Dead peer / peer without the dataset / mismatched
                # bytes: count it and try the next rung candidate.
                self._bump_repl("errors")
                continue
            self._bump_repl("fetches")
            self._install_repair(name, fname, data=data)
            self._bump_repl("repairs")
            return True
        return False

    def scrub(self, name: Optional[str] = None) -> Dict[str, Any]:
        """Proactive integrity pass: re-verify every journaled chunk's
        checksum for one dataset (or the whole catalog), repairing from
        the replica where possible. Returns a report; corruption that
        could not be repaired is listed per dataset under ``errors``
        rather than raised, so one rotten dataset doesn't hide the state
        of the rest. Served at ``POST /catalog/scrub``."""
        names = [name] if name else self.names()
        report: Dict[str, Any] = {"datasets": len(names), "checked": 0,
                                  "unchecksummed": 0, "missing": 0,
                                  "errors": {}}
        for n in names:
            ds = self.get(n)
            r = ds.scrub_chunks()
            report["checked"] += r["checked"]
            report["unchecksummed"] += r["unchecksummed"]
            report["missing"] += r.get("missing", 0)
            if r["errors"]:
                report["errors"][n] = r["errors"]
        self._bump("chunks_scrubbed", report["checked"])
        self._bump("scrub_runs")
        report["ok"] = not report["errors"]
        return report

    def save(self, name: str) -> None:
        """Incremental commit: flush new chunks + rewrite metadata.json.

        Cost is O(data appended since the last save), so streaming ingest
        can checkpoint per chunk (the reference's durability granularity
        was per row via Mongo; database.py:171-181). After a set_column
        rebuild, a new chunk generation is written and the journal swapped
        atomically (old files stay valid until the swap — no crash window
        loses committed data), then stale files are garbage-collected.
        """
        ds = self.get(name)
        path = self._path(name)
        os.makedirs(path, exist_ok=True)
        if not ds.rewrite_generation():    # GCs its own stale files
            ds.flush_new_chunks()
        # A journaled layout supersedes any legacy single-file copy.
        if os.path.isfile(os.path.join(path, "journal.jsonl")):
            try:
                os.remove(os.path.join(path, "data.parquet"))
            except FileNotFoundError:
                pass
        tmp = os.path.join(path, "metadata.json.tmp")
        with open(tmp, "w") as f:
            json.dump(ds.metadata.to_doc(), f, default=str)
        # Crash window between journal commit (above) and the metadata
        # swap: load() rebuilds metadata.fields from journal dtypes, so
        # the sweep proves a stale/missing metadata.json is recoverable.
        failpoints.fire(FP_SAVE_PRE_META_SWAP)
        os.replace(tmp, os.path.join(path, "metadata.json"))
        ds.maybe_evict()
        if self.cfg.replica_root:
            self._mirror(name)
        if self._peers:
            self._queue_push(name)

    def _mirror(self, name: str) -> None:
        """Copy the dataset's committed delta to the replica root — the
        availability tier standing in for the reference's Mongo
        primary/secondary replication (docker-compose.yml:27-91).

        Per-save cost is O(what was committed since the last mirror): the
        journal bytes appended since the tracked per-dataset offset name
        exactly the chunk files to copy (immutable, uniquely named across
        generations — including files flushed by budget evictions between
        saves). Files are copied *before* the journal bytes referencing
        them land, so the replica is itself always a consistent prefix.

        The delta path only applies while the journal is known to be
        append-only since the last mirror: a generation change (rewrites,
        including ones committed inline by budget eviction) or an unknown
        offset (fresh process) falls back to a wholesale journal replace +
        GC of unreferenced replica files.
        """
        ds = self.get(name)
        src = self._path(name)
        dst = os.path.join(self.cfg.replica_root, name)
        os.makedirs(os.path.join(dst, "chunks"), exist_ok=True)
        src_chunks = os.path.join(src, "chunks")
        src_journal = os.path.join(src, "journal.jsonl")
        dst_journal = os.path.join(dst, "journal.jsonl")

        def copy_files(records):
            for rec in records:
                fn = rec.get("file")
                if not fn:
                    continue
                s = os.path.join(src_chunks, fn)
                d = os.path.join(dst, "chunks", fn)
                if os.path.isfile(d):
                    continue
                failpoints.fire(FP_MIRROR_PRE_COPY, path=s)
                if not os.path.isfile(s):
                    continue
                crc = rec.get("crc32")
                actual = None if crc is None else crc32_file(s)
                if crc is not None and actual != crc:
                    # The primary file is already damaged at mirror time
                    # (torn write that slipped past rename, or rot
                    # between commit and mirror). NEVER propagate corrupt
                    # bytes into the replica: repair the primary from an
                    # existing good replica copy if one survives,
                    # otherwise fail the save with the precise error.
                    if not self._repair_chunk(name, fn, crc):
                        raise ChunkCorrupt(s, crc, actual)
                shutil.copy2(s, d)

        # One atomic snapshot under the dataset's data lock: a concurrent
        # eviction flush (journal append) or inline generation rewrite
        # (journal *replacement*) cannot interleave, so the tracked offset
        # always refers to this exact byte sequence — reading gen and size
        # separately would let a rewrite land between them and the delta
        # path would splice new-generation bytes after old-generation
        # records in the replica. The snapshot reads only the delta when
        # the generation matches (O(what was committed since last mirror)).
        state = self._mirror_state.get(name)
        known_gen, known_off = (state if state is not None
                                and os.path.isfile(dst_journal)
                                else (None, 0))
        gen, size, data, is_delta = ds.journal_snapshot(known_gen, known_off)
        if data or is_delta or os.path.isfile(src_journal):
            records = _parse_journal_bytes(data)
            copy_files(records)
            if is_delta:
                if data:
                    with open(dst_journal, "ab") as d_f:
                        d_f.write(data)
            else:
                tmp = dst_journal + ".tmp"
                with open(tmp, "wb") as t_f:
                    t_f.write(data)
                os.replace(tmp, dst_journal)
                referenced = {rec["file"] for rec in records
                              if rec.get("file")}
                dst_chunks = os.path.join(dst, "chunks")
                for fn in os.listdir(dst_chunks):
                    if fn not in referenced:
                        try:
                            os.remove(os.path.join(dst_chunks, fn))
                        except FileNotFoundError:
                            pass
            self._mirror_state[name] = (gen, size)
        meta = os.path.join(src, "metadata.json")
        if os.path.isfile(meta):
            tmp = os.path.join(dst, "metadata.json.tmp")
            shutil.copy2(meta, tmp)
            os.replace(tmp, os.path.join(dst, "metadata.json"))

    # -- peer replication ----------------------------------------------------
    #
    # The cross-host generalization of _mirror: each save marks the
    # dataset dirty and a single committer thread pushes the committed
    # journal delta to every peer in LO_TPU_REPLICA_PEERS — chunk bytes
    # first (each hop CRC-verified against the journal record), then the
    # journal bytes referencing them, so a peer's replica is always a
    # consistent prefix exactly like the local mirror. A host death
    # mid-push costs only the unacked suffix.

    def _queue_push(self, name: str) -> None:
        """Mark a dataset dirty for the push committer (idempotent;
        concurrent saves of the same dataset coalesce — the push always
        reads the newest committed journal snapshot)."""
        with self._push_cv:
            if self._push_stop:
                return
            self._push_dirty.add(name)
            if self._push_thread is None:
                # thread-lifecycle: owner=DatasetStore
                # exit=stop_replication() sets _push_stop and notifies;
                # the loop returns on the next wake.
                self._push_thread = threading.Thread(
                    target=self._push_loop, name="lo-replica-push",
                    daemon=True)
                self._push_thread.start()
            self._push_cv.notify_all()

    def _push_loop(self) -> None:
        while True:
            with self._push_cv:
                while not self._push_dirty and not self._push_stop:
                    self._push_cv.wait()
                if self._push_stop:
                    return
                name = sorted(self._push_dirty)[0]
                self._push_dirty.discard(name)
                self._push_inflight = name
            try:
                self._push_dataset(name)
            finally:
                with self._push_cv:
                    self._push_inflight = None
                    self._push_cv.notify_all()

    def _push_dataset(self, name: str) -> None:
        """One push cycle: every peer, errors recorded per (peer,
        dataset) — never raised (replication is asynchronous; the
        primary's durability does not depend on it)."""
        with self._push_cv:
            self._push_attempt[name] = time.monotonic()
        try:
            ds = self.get(name)
        except DatasetNotFound:
            return  # deleted between save and push
        for peer in self._peers:
            key = (peer, name)
            try:
                self._push_peer(peer, name, ds)
            except (replicate.ReplicaError, ChunkCorrupt, OSError,
                    RuntimeError) as exc:
                self._bump_repl("errors")
                with self._push_cv:
                    self._push_failing[key] = str(exc)

    def _push_peer(self, peer: str, name: str, ds: Dataset) -> None:
        """Push the committed journal delta for one dataset to one peer.
        Same snapshot discipline as _mirror: one atomic journal_snapshot
        names exactly the chunk files to send; files cross the wire
        before the journal bytes referencing them, each hop CRC-checked
        on both ends. An offset-mismatch rejection (peer re-imaged or
        watermark lost) clears the watermark and retries once as a full
        sync, using scrub_probe to skip bytes the peer already holds."""
        key = (peer, name)
        src_chunks = os.path.join(self.cfg.store_root, name, "chunks")
        for attempt in (0, 1):
            with self._push_cv:
                state = self._peer_state.get(key)
            known_gen, known_off = (state if state is not None
                                    else (None, 0))
            gen, size, data, is_delta = ds.journal_snapshot(
                known_gen, known_off)
            records = _parse_journal_bytes(data)
            try:
                with replicate.ReplicaClient(
                        peer, self.cfg.replica_timeout_s) as cli:
                    if is_delta:
                        need = [r for r in records if r.get("file")]
                    else:
                        refs = [(r["file"], r.get("crc32"))
                                for r in records if r.get("file")]
                        have = (set(cli.scrub_probe(name, refs))
                                if refs else set())
                        need = [r for r in records
                                if r.get("file") and r["file"] not in have]
                    for rec in need:
                        fn = rec["file"]
                        crc = rec.get("crc32")
                        path = os.path.join(src_chunks, fn)
                        actual = (crc32_file(path)
                                  if os.path.isfile(path) else None)
                        if crc is not None and actual != crc:
                            # NEVER push bytes that don't match the
                            # journal — heal the primary first (mirror
                            # or another peer) or record the failure.
                            if not self._repair_chunk(name, fn, crc):
                                raise ChunkCorrupt(path, crc, actual)
                        with open(path, "rb") as f:
                            payload = f.read()
                        cli.push_chunk(name, fn, crc, payload)
                        self._bump_repl("pushes")
                        self._bump_repl("push_bytes", len(payload))
                    # Metadata rides every sync (a bare `finish` changes
                    # metadata without appending journal bytes). Routed
                    # through json default=str like save()'s write.
                    meta_doc = json.loads(
                        json.dumps(ds.metadata.to_doc(), default=str))
                    cli.journal_sync(
                        name, gen, known_off if is_delta else 0, data,
                        is_delta, meta_doc)
            except replicate.ReplicaError as exc:
                if attempt == 0 and "offset" in str(exc):
                    with self._push_cv:
                        self._peer_state.pop(key, None)
                    continue
                raise
            with self._push_cv:
                self._peer_state[key] = (gen, size)
                self._push_failing.pop(key, None)
            return

    def replication_drain(self, timeout_s: float = 30.0) -> bool:
        """Block until the push committer's queue is empty (every dirty
        dataset attempted against every peer). Returns False on timeout.
        Failed pushes still count as drained — their outcome is in
        replication_snapshot, not an exception."""
        deadline = time.monotonic() + timeout_s
        with self._push_cv:
            while self._push_dirty or self._push_inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._push_cv.wait(left)
        return True

    def stop_replication(self) -> None:
        """Stop the push committer thread (serving shutdown)."""
        with self._push_cv:
            self._push_stop = True
            self._push_cv.notify_all()
            t = self._push_thread
        if t is not None:
            t.join(timeout=5)

    def replication_snapshot(self) -> Dict[str, Any]:
        """Per-dataset replication state for GET /metrics: per-peer
        acked watermarks, lag bytes, and which datasets are
        under-replicated (lag with a failed last push — transient lag
        from an in-flight push is not flagged). Also the read-driven
        retry tick: datasets whose last attempt failed longer than
        replica_push_retry_s ago are re-queued, so each scrape advances
        re-replication until lag clears."""
        with self._integrity_lock:
            counters = dict(self._repl)
        snap: Dict[str, Any] = {"enabled": bool(self._peers),
                                "peers": list(self._peers),
                                "counters": counters,
                                "datasets": {},
                                "under_replicated": [],
                                "max_lag_bytes": 0}
        if not self._peers:
            return snap
        now = time.monotonic()
        with self._push_cv:
            state = dict(self._peer_state)
            failing = dict(self._push_failing)
            dirty = set(self._push_dirty)
            inflight = self._push_inflight
            attempts = dict(self._push_attempt)
        retry: List[str] = []
        for name in self.names():
            try:
                ds = self.get(name)
            except DatasetNotFound:
                continue
            gen, size = ds.journal_size()
            peers_doc: Dict[str, Any] = {}
            worst = 0
            flagged = False
            for peer in self._peers:
                st = state.get((peer, name))
                acked = st[1] if st is not None and st[0] == gen else 0
                lag = max(0, size - acked)
                err = failing.get((peer, name))
                doc: Dict[str, Any] = {"acked_bytes": acked,
                                       "lag_bytes": lag}
                if err:
                    doc["error"] = err
                peers_doc[peer] = doc
                pending = name in dirty or inflight == name
                if lag > 0 and (err or not pending):
                    worst = max(worst, lag)
                    flagged = True
                    snap["under_replicated"].append(
                        {"dataset": name, "peer": peer,
                         "lag_bytes": lag})
            snap["datasets"][name] = {"journal_bytes": size,
                                      "lag_bytes": worst,
                                      "peers": peers_doc}
            snap["max_lag_bytes"] = max(snap["max_lag_bytes"], worst)
            if flagged and name not in dirty and inflight != name:
                last = attempts.get(name)
                if last is None or (now - last
                                    >= self.cfg.replica_push_retry_s):
                    retry.append(name)
        for name in retry:
            self._queue_push(name)
        return snap

    @staticmethod
    def _read_journal(path: str) -> List[Dict[str, Any]]:
        """Parse journal records from a file (load path)."""
        try:
            with open(path, "rb") as f:
                return _parse_journal_bytes(f.read())
        except FileNotFoundError:
            return []

    def load(self, name: str) -> Dataset:
        """Load one persisted dataset into the catalog.

        Journaled chunk layout loads *lazily* — only metadata and the
        journal are read; column data stays in its chunk files until first
        access. Legacy single-file (data.parquet) layout reads eagerly.
        """
        import pyarrow.parquet as pq

        path = self._path(name)
        meta_path = os.path.join(path, "metadata.json")
        if not os.path.isfile(meta_path):
            raise DatasetNotFound(name)
        with open(meta_path) as f:
            meta = Metadata.from_doc(json.load(f))
        records = self._read_journal(os.path.join(path, "journal.jsonl"))
        ds = Dataset(meta)
        if records:
            ds.restore_chunks(records, os.path.join(path, "chunks"))
            if not meta.fields:
                # Crash window: chunks journal-committed before the first
                # metadata rewrite landed (save orders journal first).
                # The journal's dtype maps carry the field names in
                # append order — recover them so the prefix is readable
                # (and a resumed ingest knows its columns).
                meta.fields = list(records[0].get("dtypes", {}).keys())
        else:
            data_path = os.path.join(path, "data.parquet")
            if os.path.isfile(data_path):
                # Single-threaded read: see read_chunk_parquet's note on
                # pyarrow's IO pool segfaulting in jax-loaded processes.
                table = pq.read_table(data_path, use_threads=False,
                                      pre_buffer=False)
                columns: Columns = {
                    fname: table.column(fname).to_numpy(zero_copy_only=False)
                    for fname in table.column_names}
                if columns:
                    ds.append_columns(
                        {f: columns[f] for f in meta.fields if f in columns}
                        if meta.fields else columns)
        self._attach_storage(ds)
        with self._lock:
            self._datasets[name] = ds
        return ds

    def load_all(self, resume_ingests: bool = False) -> List[str]:
        """Recover the catalog from disk at startup (crash resume).

        If a replica root is configured, datasets present there but missing
        from the primary (disk loss) are restored first — the failover
        analogue of the reference's replica-set recovery
        (docker-compose.yml:27-91).

        Datasets recovered with ``finished: false`` were mid-job when the
        process died; their jobs are gone, so they are marked failed —
        every dataset reaches a terminal state across restarts (the
        reference left finished:false forever, SURVEY.md §5). Exception:
        with ``resume_ingests``, interrupted *source-URL ingests* are left
        unfinished and listed in ``resumable_ingests`` — their journaled
        chunks carry source byte offsets, so the serving layer restarts
        them from the last committed byte (catalog/ingest.py
        ``resume_ingest``) instead of failing a 99%-done load.
        """
        root = self.cfg.store_root
        if self.cfg.replica_root and os.path.isdir(self.cfg.replica_root):
            for name in sorted(os.listdir(self.cfg.replica_root)):
                rmeta = os.path.join(self.cfg.replica_root, name,
                                     "metadata.json")
                pmeta = os.path.join(root, name, "metadata.json")
                if os.path.isfile(rmeta) and not os.path.isfile(pmeta):
                    shutil.copytree(os.path.join(self.cfg.replica_root, name),
                                    os.path.join(root, name),
                                    dirs_exist_ok=True)
        loaded = []
        if os.path.isdir(root):
            for name in sorted(os.listdir(root)):
                if os.path.isfile(os.path.join(root, name, "metadata.json")):
                    self.load(name)
                    loaded.append(name)
        self.resumable_ingests: List[str] = []
        for name in loaded:
            ds = self.get(name)
            if not ds.metadata.finished and not ds.metadata.error:
                if (resume_ingests and ds.metadata.url
                        and not ds.metadata.parent
                        and (ds.num_rows == 0
                             or ds.resume_offset is not None)):
                    self.resumable_ingests.append(name)
                    continue
                self.fail(name, "interrupted: server restarted mid-job")
        if self.cfg.scrub_on_load and loaded:
            # Recovery-scan verification: checksum every journaled chunk
            # the crash-surviving journals reference, repairing from the
            # replica where possible. Off by default — it reads every
            # chunk file, trading startup time for eager detection;
            # lazy first-read verification covers the default path.
            report = self.scrub()
            for n, errs in report["errors"].items():
                # Direct mark (not ``fail``): corruption must surface on
                # the metadata even for datasets that finished
                # successfully before the rot set in, and must not
                # overwrite an earlier recorded root cause.
                ds = self.get(n)
                ds.metadata.error = (ds.metadata.error
                                     or f"chunk corruption: {errs[0]}")
                ds.metadata.finished = True
                # A corrupt interrupted ingest must NOT be resubmitted
                # for resume — it would append fresh rows to a dataset
                # just declared damaged.
                if n in self.resumable_ingests:
                    self.resumable_ingests.remove(n)
                if self.cfg.persist:
                    try:
                        self.save(n)
                    except ChunkCorrupt:
                        # The mirror re-verifies chunks and re-raises on
                        # the same unrepairable file; metadata.json was
                        # already rewritten before the mirror step, and
                        # one rotten dataset must not abort the whole
                        # recovery scan.
                        pass
        if self._peers:
            # Establish fresh acked watermarks: a restarted process has
            # no push state, so every recovered dataset is re-synced
            # (scrub_probe keeps the cost at journal bytes + any chunk
            # bytes the peers actually lack). This is the
            # "re-replicate" leg of the host-loss runbook.
            for name in loaded:
                self._queue_push(name)
        return loaded


def _parse_journal_bytes(data: bytes) -> List[Dict[str, Any]]:
    """Journal bytes → records, tolerating a torn final line (a crash
    mid-append commits nothing; the preceding prefix stays valid)."""
    records: List[Dict[str, Any]] = []
    for line in data.decode("utf-8", errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            break  # torn tail write — everything before is valid
    return records


# -- query evaluation --------------------------------------------------------
#
# The reference's read API passed the client's JSON query verbatim into
# pymongo's ``find()`` (database_api_image/database.py:44-48), so the whole
# Mongo operator set was reachable. This section reproduces that contract
# as vectorized mask evaluation: one shared evaluator serves both column
# queries (arrays of length n) and single-document matches (length-1).

_OPS = {
    "$gt": lambda v, x: v > x,
    "$gte": lambda v, x: v >= x,
    "$lt": lambda v, x: v < x,
    "$lte": lambda v, x: v <= x,
    "$ne": lambda v, x: v != x,
    "$eq": lambda v, x: v == x,
    "$in": lambda v, x: np.isin(v, x),
    "$nin": lambda v, x: ~np.isin(v, x),
}

#: Operators whose Mongo semantics MATCH documents missing the field
#: ($ne/$nin match absent values; comparisons and $in/$regex don't).
_MATCH_MISSING = {"$ne", "$nin"}

_REGEX_FLAGS = {"i": re.IGNORECASE, "m": re.MULTILINE, "s": re.DOTALL,
                "x": re.VERBOSE}


def _query_fields(query: Dict[str, Any],
                  fields: List[str]) -> List[str]:
    """Root column names a Mongo-style query touches (dotted paths keep
    their root; ``_id`` is positional and needs no column) — the
    projection a filtered scan reads instead of every column."""
    out: set = set()

    def walk(q) -> None:
        if not isinstance(q, dict):
            return
        for k, v in q.items():
            if k in ("$and", "$or", "$nor"):
                for sub in (v if isinstance(v, (list, tuple)) else ()):
                    walk(sub)
            elif not k.startswith("$") and k != "_id":
                out.add(k.split(".", 1)[0])

    walk(query)
    return [f for f in fields if f in out]


def _traverse(value: Any, path: str):
    """Walk a dotted path inside a nested document; returns (value, found)."""
    for part in path.split("."):
        if isinstance(value, dict) and part in value:
            value = value[part]
        else:
            return None, False
    return value, True


def _apply_op(op: str, vals: np.ndarray, operand: Any) -> np.ndarray:
    """One operator over a column; object columns evaluate elementwise so
    mixed/None values never raise (a None cell simply doesn't match —
    Mongo's null-comparison behavior, which the vectorized path can't give
    for object dtypes)."""
    fn = _OPS[op]
    if vals.dtype == object:
        out = np.zeros(len(vals), dtype=bool)
        for i, v in enumerate(vals):
            try:
                out[i] = bool(fn(v, operand))
            except TypeError:
                out[i] = False
        return out
    with np.errstate(invalid="ignore"):
        return np.asarray(fn(vals, operand), dtype=bool)


def _apply_regex(vals: np.ndarray, pattern: str, options: str) -> np.ndarray:
    flags = 0
    for ch in options or "":
        flags |= _REGEX_FLAGS.get(ch, 0)
    rx = re.compile(pattern, flags)
    out = np.zeros(len(vals), dtype=bool)
    for i, v in enumerate(vals):
        if isinstance(v, str):          # np.str_ subclasses str
            out[i] = rx.search(v) is not None
    return out


def _eval_cond(vals: np.ndarray, exists: np.ndarray, cond: Any) -> np.ndarray:
    """Evaluate one field condition (scalar equality or operator document)
    against resolved values + an existence mask."""
    if isinstance(cond, dict) and any(k.startswith("$") for k in cond):
        mask = np.ones(len(vals), dtype=bool)
        for op, operand in cond.items():
            if op == "$exists":
                mask &= exists if operand else ~exists
            elif op == "$not":
                # $not negates the operator expression and matches docs
                # missing the field (Mongo semantics).
                mask &= ~_eval_cond(vals, exists, operand)
            elif op == "$regex":
                mask &= _apply_regex(vals.astype(object), operand,
                                     cond.get("$options", ""))
            elif op == "$options":
                continue  # consumed by $regex
            elif op == "$eq" and operand is None:
                mask &= ~exists          # null equality matches null/missing
            elif op == "$ne" and operand is None:
                mask &= exists
            elif op in _OPS:
                m = _apply_op(op, vals, operand)
                has_null = (op in ("$in", "$nin")
                            and isinstance(operand, (list, tuple))
                            and None in operand)
                if op in _MATCH_MISSING:
                    # $nin [..., null]: null IS in the list, so null/missing
                    # values are excluded rather than matched.
                    m = (m & exists) if has_null else (m | ~exists)
                else:
                    # $in [..., null] matches null/missing (Mongo null-in-
                    # array semantics); plain comparisons require presence.
                    m = (m | ~exists) if has_null else (m & exists)
                mask &= m
            else:
                raise ValueError(f"unsupported query operator: {op}")
        return mask
    if cond is None:
        # {field: null} matches documents where the field is null OR
        # missing (Mongo semantics; NaN/None cells count as missing here).
        return ~exists
    # Scalar (or literal-document) equality: field must exist and equal.
    return _apply_op("$eq", vals, cond) & exists


def _eval_query_mask(query: Dict[str, Any], resolve, n: int) -> np.ndarray:
    """Evaluate a full query document: implicit AND of field conditions and
    the $and/$or/$nor combinators. ``resolve(field) -> (vals, exists)``."""
    mask = np.ones(n, dtype=bool)
    for key, cond in query.items():
        if key in ("$and", "$or", "$nor"):
            if not isinstance(cond, (list, tuple)) or not cond:
                raise ValueError(f"{key} requires a non-empty array")
            subs = [_eval_query_mask(q, resolve, n) for q in cond]
            if key == "$and":
                sub = np.logical_and.reduce(subs)
            else:
                sub = np.logical_or.reduce(subs)
                if key == "$nor":
                    sub = ~sub
            mask &= sub
        elif key.startswith("$"):
            raise ValueError(f"unsupported top-level operator: {key}")
        else:
            vals, exists = resolve(key)
            mask &= _eval_cond(vals, exists, cond)
    return mask


def _doc_matches(doc: Dict[str, Any], query: Dict[str, Any]) -> bool:
    def resolve(field: str):
        val, found = _traverse(doc, field)
        return (np.asarray([val], dtype=object),
                np.asarray([found], dtype=bool))

    try:
        return bool(_eval_query_mask(query, resolve, 1)[0])
    except TypeError:
        return False
