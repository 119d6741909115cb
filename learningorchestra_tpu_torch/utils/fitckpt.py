"""Fit-progress checkpoints — interrupted fits resume instead of restart.

A job that dies mid-build (process restart, job retry) re-executes FROM
SCRATCH without this module: at the HIGGS-11M scale, losing a gb fit's
boost rounds to one blip is the dominant recovery cost. Trainers (and
the streamed-design state fit) persist per-family progress at natural
boundaries — gb boost-round segments, rf tree batches, fitting-pass
boundaries — and a retried job resumes from the newest valid
checkpoint, producing **bit-identical** final params/metrics to an
uninterrupted fit (parity-pinned per family in
tests/test_torch_fitckpt.py).

Disk discipline mirrors the chunk store's: every checkpoint is an
immutable ``ckpt-<progress>.npz`` payload committed via tmp+fsync+rename
with a sidecar ``ckpt-<progress>.json`` carrying the payload's CRC32 —
written strictly AFTER the payload lands, so a crash at any byte leaves
either a fully-valid pair or an ignorable orphan, never a torn
checkpoint that could be trusted (the ``fit.ckpt.pre_rename`` failpoint
drives that window). Older checkpoints are pruned only after a newer
pair is fully durable.

Validity is KEYED, never assumed: the sidecar records
``(dataset, family, config, snapshot, mesh_epoch)`` — the config hash
covers hparams/steps/device type (the card's fixed-point histogram sums
and the CPU's float sums give different trees, so one's partial
progress must not be resumed by the other), the snapshot token pins the
row prefix the fit read, and the epoch records the writing incarnation.
A checkpoint whose key mismatches, whose epoch is FROM THE FUTURE (a
concurrent newer incarnation wrote it), or whose payload fails its CRC
is discarded with a structlog warning — stale or corrupt progress is
never trusted. ``LO_TPU_FIT_CKPT_ROUNDS=0`` (default) disables the
whole tier and keeps the single-pass fit path as the oracle.
"""

from __future__ import annotations

import io
import json
import os
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch.config import Settings, mesh_epoch
from learningorchestra_tpu_torch.utils import failpoints
from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("fitckpt")

#: Deterministic fault-injection sites (utils/failpoints.py): the
#: payload is written+fsynced but not yet renamed into place (the torn
#: /crash window the sweep drives), and the read side's entry (corrupt
#: checkpoints must be discarded, never trusted).
FP_CKPT_PRE_RENAME = failpoints.declare("fit.ckpt.pre_rename")
FP_CKPT_PRE_READ = failpoints.declare("fit.ckpt.pre_read")

#: Families whose fits carry natural mid-fit checkpoint boundaries (the
#: builder only mints contexts for these; lr/nb/dt fits are single
#: closed-form/one-batch fits whose only boundary is the start).
SEGMENTED_FAMILIES = ("gb", "rf", "mlp")

_counter_lock = threading.Lock()
_counters = {"writes": 0, "resumes": 0, "discarded": 0}


def _bump(key: str) -> None:
    with _counter_lock:
        _counters[key] += 1


def counters_snapshot() -> Dict[str, int]:
    with _counter_lock:
        return dict(_counters)


def count_resume() -> None:
    """Count one ACTUAL resume — called by the segmented fit loops at
    the moment they accept a loaded checkpoint (not by ``load`` itself:
    a caller may still reject a key-valid checkpoint whose progress
    doesn't fit its shape, and the series documents successful
    resumes)."""
    _bump("resumes")


def root_dir(cfg: Settings) -> str:
    return os.path.join(cfg.store_root, "_fitckpt")


def disk_snapshot(cfg: Settings) -> Dict[str, Any]:
    """The ``fit_checkpoints`` section of ``/metrics``: live bytes/files
    under ``<store_root>/_fitckpt`` plus the process counters. One
    directory walk per scrape — the dir holds at most a handful of
    (payload, sidecar) pairs per in-flight family."""
    files = 0
    nbytes = 0
    root = root_dir(cfg)
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            try:
                nbytes += os.path.getsize(os.path.join(dirpath, name))
                files += 1
            except OSError:
                continue
    doc: Dict[str, Any] = {"files": files, "bytes": nbytes}
    doc.update(counters_snapshot())
    return doc


def config_hash(doc: Any) -> str:
    """Stable short hash of a JSON-able config document (hparams, steps,
    device type, ...) — the checkpoint-validity component that makes a
    resume under ANY changed fit configuration start fresh."""
    blob = json.dumps(doc, sort_keys=True, default=str).encode("utf-8")
    return f"{zlib.crc32(blob):08x}-{len(blob)}"


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclass
class FitContext:
    """One (dataset, family) checkpoint stream: ``save`` commits
    progress, ``load`` returns the newest valid checkpoint, ``clear``
    drops the stream once the fit completed. ``every`` is the cadence in
    the family's natural unit (gb rounds); ``0`` disables —
    callers should then never consult the context at all."""

    cfg: Settings
    dataset: str
    family: str
    config: str                      # config_hash() of the fit's knobs
    snapshot: str                    # pinned row-prefix token
    every: int = 0
    #: Serializes this stream's save/load/clear: fan-out family threads
    #: each own their context, so this is cheap insurance against a
    #: future caller sharing one — never a hot lock.
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    @property
    def enabled(self) -> bool:
        return self.every > 0

    def _dir(self) -> str:
        # Dataset/family names are validated route-side (store
        # validate_name); the join stays flat by construction.
        return os.path.join(root_dir(self.cfg),
                            f"{self.dataset}__{self.family}")

    def _key_doc(self) -> Dict[str, Any]:
        return {"dataset": self.dataset, "family": self.family,
                "config": self.config, "snapshot": self.snapshot}

    # -- write ---------------------------------------------------------------

    def save(self, progress: int, arrays: Dict[str, np.ndarray],
             meta: Optional[Dict[str, Any]] = None) -> None:
        """Commit one checkpoint at ``progress`` (a monotone count in the
        family's natural unit). Best-effort by contract: a checkpoint
        write failure must never fail the fit it exists to protect —
        except an armed failpoint, which must stay injectable."""
        if not self.enabled:
            return
        try:
            with self._lock:
                self._save(progress, arrays, meta)
            _bump("writes")
        except failpoints.FailpointError:
            raise
        except OSError as exc:
            log.warning("fit checkpoint write failed for %s/%s@%d: %s",
                        self.dataset, self.family, progress, exc)

    def _save(self, progress: int, arrays: Dict[str, np.ndarray],
              meta: Optional[Dict[str, Any]]) -> None:
        d = self._dir()
        os.makedirs(d, exist_ok=True)
        payload = os.path.join(d, f"ckpt-{progress:08d}.npz")
        sidecar = os.path.join(d, f"ckpt-{progress:08d}.json")
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        blob = buf.getvalue()
        tmp = payload + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        # The torn/crash window under sweep test: payload durable in its
        # tmp name, nothing committed yet — the previous checkpoint pair
        # must stay the one a resume trusts.
        failpoints.fire(FP_CKPT_PRE_RENAME, path=tmp)
        os.replace(tmp, payload)
        doc = dict(self._key_doc(),
                   progress=int(progress),
                   crc32=zlib.crc32(blob),
                   nbytes=len(blob),
                   mesh_epoch=mesh_epoch(),
                   meta=dict(meta or {}))
        stmp = sidecar + ".tmp"
        with open(stmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(stmp, sidecar)
        _fsync_dir(d)
        # Prune strictly-older pairs only now that the newer pair is
        # fully durable (a crash anywhere above leaves the previous one).
        for name in os.listdir(d):
            if not name.startswith("ckpt-"):
                continue
            try:
                p = int(name[5:13])
            except ValueError:
                continue
            if p < progress:
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass

    # -- read ----------------------------------------------------------------

    def load(self) -> Optional[Tuple[int, Dict[str, np.ndarray],
                                     Dict[str, Any]]]:
        """Newest valid checkpoint as ``(progress, arrays, meta)``, or
        None. Anything stale, corrupt, or config-mismatched is DISCARDED
        with a warning — a resume never trusts it, and the files are
        unlinked so the next write starts clean."""
        if not self.enabled:
            return None
        d = self._dir()
        with self._lock:
            try:
                names = sorted((n for n in os.listdir(d)
                                if n.startswith("ckpt-")
                                and n.endswith(".json")), reverse=True)
            except OSError:
                return None
            failpoints.fire(FP_CKPT_PRE_READ)
            for name in names:
                sidecar = os.path.join(d, name)
                payload = sidecar[:-5] + ".npz"
                got = self._load_one(sidecar, payload)
                if got is not None:
                    return got
        return None

    def _load_one(self, sidecar: str, payload: str):
        def discard(why: str) -> None:
            log.warning("discarding fit checkpoint %s: %s", sidecar, why)
            _bump("discarded")
            for p in (sidecar, payload):
                try:
                    os.remove(p)
                except OSError:
                    pass

        try:
            with open(sidecar) as f:
                doc = json.load(f)
        except (OSError, ValueError) as exc:
            discard(f"unreadable sidecar ({exc})")
            return None
        want = self._key_doc()
        got = {k: doc.get(k) for k in want}
        if got != want:
            discard(f"key mismatch (have {got}, want {want})")
            return None
        epoch = int(doc.get("mesh_epoch", 0) or 0)
        if epoch > mesh_epoch():
            # Written by an incarnation newer than this process's epoch:
            # a concurrent deployment owns this stream — never resume its
            # partial progress from here.
            discard(f"mesh epoch {epoch} is newer than ours "
                    f"({mesh_epoch()})")
            return None
        try:
            with open(payload, "rb") as f:
                blob = f.read()
        except OSError as exc:
            discard(f"payload unreadable ({exc})")
            return None
        if zlib.crc32(blob) != int(doc.get("crc32", -1)):
            discard("payload CRC32 mismatch (torn or rotten)")
            return None
        try:
            with np.load(io.BytesIO(blob), allow_pickle=False) as npz:
                arrays = {k: npz[k] for k in npz.files}
        except Exception as exc:  # noqa: BLE001 — any decode failure = torn
            discard(f"payload decode failed ({exc})")
            return None
        meta = dict(doc.get("meta") or {})
        meta["mesh_epoch"] = epoch
        return int(doc["progress"]), arrays, meta

    def clear(self) -> None:
        """Drop the stream (fit completed — its progress is now fully
        represented by the persisted model / prediction dataset)."""
        d = self._dir()
        with self._lock:
            try:
                for name in os.listdir(d):
                    try:
                        os.remove(os.path.join(d, name))
                    except OSError:
                        pass
                os.rmdir(d)
            except OSError:
                pass


def context(cfg: Settings, *, dataset: str, family: str, config: Any,
            snapshot: str, every: Optional[int] = None) -> FitContext:
    """Build a checkpoint context; ``config`` may be any JSON-able doc
    (hashed here). ``every`` defaults to ``cfg.fit_ckpt_rounds``."""
    return FitContext(
        cfg=cfg, dataset=dataset, family=family,
        config=config if isinstance(config, str) else config_hash(config),
        snapshot=str(snapshot),
        every=int(cfg.fit_ckpt_rounds if every is None else every))
