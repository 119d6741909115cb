"""Peer-host replication plane for the chunk store.

``ReplicaClient``/``ReplicaServer`` speak length-prefixed frames over the
same transport-agnostic framing as serving/rowchannel.py (u32 header-len,
u32 payload-len, JSON header, raw payload). Four frame kinds:

==============  ========================================================
frame           meaning
==============  ========================================================
push_chunk      primary -> peer: one chunk file's bytes; header carries
                the journal CRC32 and the peer refuses bytes that don't
                match it (a replica never *accepts* unjournaled bytes)
journal_sync    primary -> peer: a committed journal prefix (delta append
                or full rewrite) + metadata doc; the peer verifies every
                referenced chunk file against its journal CRC before
                committing, so the replica is always a consistent prefix
fetch_chunk     any host -> peer: chunk bytes back out for remote repair;
                the peer re-CRCs the file before replying (a replica
                never *serves* bytes that don't match the journal) and
                the fetching side verifies again on receipt
scrub_probe     primary -> peer: which of these (file, crc) pairs do you
                hold intact? Used to resume a full sync without
                re-pushing bytes the peer already has
==============  ========================================================

Layering: this module sits beside dataset.py (it imports only the chunk
CRC helpers and the shared framing) — store.py owns the policy of *when*
to push and *where* repairs come from.

Sharded (range-partition-ingested) datasets need nothing extra from this
plane: the shard map lives in ``metadata.extra``, so it rides the
``journal_sync`` metadata doc to every peer, and a host reading rows it
doesn't own locally fetches them through the same ``fetch_chunk`` frames
remote repair uses — placement (parallel/mesh.py) is a hint layered on
top, never a correctness dependency.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from learningorchestra_tpu_torch.catalog.dataset import _fsync_dir, crc32_file
from learningorchestra_tpu_torch.serving.rowchannel import (
    ChannelProtocolError,
    pack_frame,
    recv_frame,
)
from learningorchestra_tpu_torch.utils import failpoints
from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("catalog.replicate")

#: Chaos sites for the crash-sweep harness (tests/test_failpoints.py).
#: push.* fire on the primary's send side, fetch.* on the repair side,
#: serve.* on the peer — pre_commit before a received file/journal is
#: renamed into place, pre_reply before any reply frame leaves.
FP_PUSH_PRE_SEND = failpoints.declare("replicate.push.pre_send")
FP_PUSH_MID_STREAM = failpoints.declare("replicate.push.mid_stream")
FP_FETCH_PRE_READ = failpoints.declare("replicate.fetch.pre_read")
FP_SERVE_PRE_COMMIT = failpoints.declare("replicate.serve.pre_commit")
FP_SERVE_PRE_REPLY = failpoints.declare("replicate.serve.pre_reply")

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.\-]*$")


class ReplicaError(RuntimeError):
    """A peer rejected a frame or the exchange failed mid-flight."""


def parse_peers(spec: str) -> List[str]:
    """``"hostA:9401, hostB:9401"`` -> ``["hostA:9401", "hostB:9401"]``."""
    peers = []
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        if ":" not in tok:
            raise ValueError(f"replica peer {tok!r} is not host:port")
        peers.append(tok)
    return peers


def _split_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host, int(port)


def _safe_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME_RE.match(name) or ".." in name:
        raise ReplicaError(f"invalid dataset name {name!r}")
    return name


def _safe_file(fname: str) -> str:
    if (
        not isinstance(fname, str)
        or not fname
        or fname != os.path.basename(fname)
        or fname.startswith(".")
    ):
        raise ReplicaError(f"invalid chunk file name {fname!r}")
    return fname


def _parse_journal(data: bytes) -> List[Dict[str, Any]]:
    """Journal bytes -> records, tolerating a torn final line (same
    discipline as the store's recovery parser: everything before the
    first undecodable line is the valid prefix)."""
    records: List[Dict[str, Any]] = []
    for line in data.decode("utf-8", errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            break
    return records


# -- client ------------------------------------------------------------------


class ReplicaClient:
    """One connection to a peer ReplicaServer. Not thread-safe; the push
    committer and each repair attempt open their own short-lived client."""

    def __init__(self, addr: str, timeout_s: float = 10.0):
        self.addr = addr
        host, port = _split_addr(addr)
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.settimeout(timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ReplicaClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _reply(self) -> Tuple[Dict[str, Any], bytes]:
        got = recv_frame(self._sock)
        if got is None:
            raise ReplicaError(f"peer {self.addr} closed mid-exchange")
        header, payload = got
        if header.get("kind") == "error":
            raise ReplicaError(
                f"peer {self.addr}: {header.get('message', 'unknown error')}"
            )
        return header, payload

    def push_chunk(
        self, dataset: str, fname: str, crc32: Optional[int], data: bytes
    ) -> None:
        """Send one chunk file; the peer refuses it on CRC mismatch."""
        failpoints.fire(FP_PUSH_PRE_SEND, path=fname)
        self._sock.sendall(
            pack_frame(
                {
                    "kind": "push_chunk",
                    "dataset": dataset,
                    "file": fname,
                    "crc32": crc32,
                },
                data,
            )
        )
        self._reply()

    def journal_sync(
        self,
        dataset: str,
        generation: int,
        offset: int,
        data: bytes,
        is_delta: bool,
        meta: Optional[Dict[str, Any]] = None,
    ) -> int:
        """Commit a journal prefix on the peer. Returns the peer's new
        journal size (the acked watermark). ``offset`` is the size the
        peer must currently hold for a delta append to be legal."""
        failpoints.fire(FP_PUSH_MID_STREAM, path=dataset)
        self._sock.sendall(
            pack_frame(
                {
                    "kind": "journal_sync",
                    "dataset": dataset,
                    "generation": generation,
                    "offset": offset,
                    "is_delta": bool(is_delta),
                    "meta": meta,
                },
                data,
            )
        )
        header, _ = self._reply()
        return int(header.get("size", 0))

    def fetch_chunk(
        self, dataset: str, fname: str, crc32: Optional[int]
    ) -> bytes:
        """Fetch chunk bytes for remote repair; both ends CRC-verify."""
        failpoints.fire(FP_FETCH_PRE_READ, path=fname)
        self._sock.sendall(
            pack_frame(
                {
                    "kind": "fetch_chunk",
                    "dataset": dataset,
                    "file": fname,
                    "crc32": crc32,
                }
            )
        )
        header, payload = self._reply()
        actual = zlib.crc32(payload) & 0xFFFFFFFF
        expected = crc32 if crc32 is not None else header.get("crc32")
        if expected is not None and actual != expected:
            raise ReplicaError(
                f"peer {self.addr} served {dataset}/{fname} with crc "
                f"{actual}, expected {expected}"
            )
        return payload

    def scrub_probe(
        self, dataset: str, files: Sequence[Tuple[str, Optional[int]]]
    ) -> List[str]:
        """Which of these (file, crc32) pairs does the peer hold intact?
        Part of the push path (full-sync resume), hence the push site."""
        failpoints.fire(FP_PUSH_PRE_SEND, path=dataset)
        self._sock.sendall(
            pack_frame(
                {
                    "kind": "scrub_probe",
                    "dataset": dataset,
                    "files": [
                        {"file": f, "crc32": c} for f, c in files
                    ],
                }
            )
        )
        header, _ = self._reply()
        have = header.get("have", [])
        return [str(f) for f in have] if isinstance(have, list) else []


# -- server ------------------------------------------------------------------


class ReplicaServer:
    """Receive side of the replication plane. Stores peers' datasets
    under ``root/<dataset>/{chunks,journal.jsonl,metadata.json}`` — the
    same layout as a replica_root mirror, so load_all()'s replica-restore
    path and _repair_chunk's local rung work against it unchanged.
    ``extra_roots`` (typically the host's primary store_root) are
    consulted read-only by fetch_chunk, so a peer can also heal from
    datasets this host natively owns."""

    def __init__(
        self,
        root: str,
        host: str = "127.0.0.1",
        port: int = 0,
        extra_roots: Sequence[str] = (),
        timeout_s: float = 30.0,
    ):
        self.root = root
        self.extra_roots = [r for r in extra_roots if r]
        os.makedirs(root, exist_ok=True)
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {
            "pushes": 0,
            "push_bytes": 0,
            "journal_syncs": 0,
            "fetches": 0,
            "probes": 0,
            "errors": 0,
        }
        self._conns: List[socket.socket] = []
        self._stopped = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(32)
        self.host, self.port = self._listener.getsockname()[:2]
        # thread-lifecycle: owner=ReplicaServer exit=stop() closes the
        # listener, which breaks accept() with OSError.
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name="lo-replica-accept",
            daemon=True,
        )
        self._accept_thread.start()
        log.info("replica server listening on %s:%d (root %s)",
                 self.host, self.port, root)

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "addr": self.addr,
                "root": self.root,
                "connections": len(self._conns),
                "counters": dict(self._counters),
            }

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed by stop()
            conn.settimeout(self._timeout_s)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._stopped:
                    conn.close()
                    return
                self._conns.append(conn)
            # thread-lifecycle: owner=ReplicaServer exit=peer disconnect
            # (recv_frame -> None) or stop() closing the socket.
            t = threading.Thread(
                target=self._serve_conn,
                args=(conn,),
                name="lo-replica-conn",
                daemon=True,
            )
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        """One frame at a time per connection; replication is a
        sequential protocol, so no handler pool is needed."""
        try:
            while True:
                try:
                    got = recv_frame(conn)
                except (ChannelProtocolError, OSError):
                    return
                if got is None:
                    return  # clean EOF
                header, payload = got
                try:
                    reply_header, reply_payload = self._handle(
                        header, payload
                    )
                except ReplicaError as exc:
                    self._bump("errors")
                    reply_header, reply_payload = (
                        {"kind": "error", "message": str(exc)},
                        b"",
                    )
                except Exception as exc:  # noqa: BLE001 - reply then drop
                    self._bump("errors")
                    log.warning("replica %s handler failed: %r",
                                header.get("kind"), exc)
                    reply_header, reply_payload = (
                        {"kind": "error", "message": repr(exc)},
                        b"",
                    )
                failpoints.fire(FP_SERVE_PRE_REPLY,
                                path=str(header.get("file", "")))
                try:
                    conn.sendall(pack_frame(reply_header, reply_payload))
                except OSError:
                    return
        finally:
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(
        self, header: Dict[str, Any], payload: bytes
    ) -> Tuple[Dict[str, Any], bytes]:
        kind = header.get("kind")
        if kind == "push_chunk":
            return self._handle_push(header, payload)
        if kind == "journal_sync":
            return self._handle_journal(header, payload)
        if kind == "fetch_chunk":
            return self._handle_fetch(header)
        if kind == "scrub_probe":
            return self._handle_probe(header)
        raise ReplicaError(f"unknown frame kind {kind!r}")

    def _dataset_dir(self, name: str) -> str:
        return os.path.join(self.root, _safe_name(name))

    def _handle_push(
        self, header: Dict[str, Any], payload: bytes
    ) -> Tuple[Dict[str, Any], bytes]:
        name = _safe_name(str(header.get("dataset")))
        fname = _safe_file(str(header.get("file")))
        crc = header.get("crc32")
        actual = zlib.crc32(payload) & 0xFFFFFFFF
        if crc is not None and actual != crc:
            # Never accept bytes that don't match the journal CRC.
            raise ReplicaError(
                f"push_chunk {name}/{fname}: payload crc {actual} does "
                f"not match journal crc {crc}"
            )
        chunk_dir = os.path.join(self._dataset_dir(name), "chunks")
        os.makedirs(chunk_dir, exist_ok=True)
        dst = os.path.join(chunk_dir, fname)
        tmp = dst + ".push"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        failpoints.fire(FP_SERVE_PRE_COMMIT, path=tmp)
        os.replace(tmp, dst)
        _fsync_dir(chunk_dir)
        self._bump("pushes")
        self._bump("push_bytes", len(payload))
        return {"kind": "ok", "crc32": actual}, b""

    def _handle_journal(
        self, header: Dict[str, Any], payload: bytes
    ) -> Tuple[Dict[str, Any], bytes]:
        name = _safe_name(str(header.get("dataset")))
        offset = int(header.get("offset", 0))
        is_delta = bool(header.get("is_delta"))
        ddir = self._dataset_dir(name)
        chunk_dir = os.path.join(ddir, "chunks")
        os.makedirs(chunk_dir, exist_ok=True)
        jpath = os.path.join(ddir, "journal.jsonl")
        try:
            cur_size = os.path.getsize(jpath)
        except OSError:
            cur_size = 0
        if is_delta and cur_size != offset:
            raise ReplicaError(
                f"journal_sync {name}: delta offset {offset} does not "
                f"match replica journal size {cur_size}"
            )
        # A replica never accepts a journal whose records it cannot back
        # with matching bytes: verify every newly referenced chunk file.
        for rec in _parse_journal(payload):
            fname = rec.get("file")
            if not fname:
                continue
            path = os.path.join(chunk_dir, _safe_file(str(fname)))
            crc = rec.get("crc32")
            if not os.path.isfile(path):
                raise ReplicaError(
                    f"journal_sync {name}: referenced chunk {fname} was "
                    f"never pushed"
                )
            if crc is not None and crc32_file(path) != crc:
                raise ReplicaError(
                    f"journal_sync {name}: chunk {fname} does not match "
                    f"journal crc {crc}"
                )
        if is_delta:
            with open(jpath, "ab") as f:
                f.write(payload)
                f.flush()
                failpoints.fire(FP_SERVE_PRE_COMMIT, path=jpath)
                os.fsync(f.fileno())
            new_size = cur_size + len(payload)
        else:
            tmp = jpath + ".sync"
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            failpoints.fire(FP_SERVE_PRE_COMMIT, path=tmp)
            os.replace(tmp, jpath)
            _fsync_dir(ddir)
            new_size = len(payload)
            # GC replica chunk files the new journal no longer references
            # (a generation rewrite on the primary shrank the set).
            referenced = {
                rec["file"]
                for rec in _parse_journal(payload)
                if rec.get("file")
            }
            for fname in os.listdir(chunk_dir):
                if fname.endswith(".push"):
                    continue
                if fname not in referenced:
                    try:
                        os.remove(os.path.join(chunk_dir, fname))
                    except OSError:
                        pass
        meta = header.get("meta")
        if isinstance(meta, dict):
            mpath = os.path.join(ddir, "metadata.json")
            tmp = mpath + ".sync"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(meta, f)
            os.replace(tmp, mpath)
        self._bump("journal_syncs")
        return {"kind": "ok", "size": new_size}, b""

    def _handle_fetch(
        self, header: Dict[str, Any]
    ) -> Tuple[Dict[str, Any], bytes]:
        name = _safe_name(str(header.get("dataset")))
        fname = _safe_file(str(header.get("file")))
        expected = header.get("crc32")
        roots = [self.root] + self.extra_roots
        last_err = f"fetch_chunk {name}/{fname}: not held by this peer"
        for root in roots:
            path = os.path.join(root, name, "chunks", fname)
            if not os.path.isfile(path):
                continue
            with open(path, "rb") as f:
                data = f.read()
            actual = zlib.crc32(data) & 0xFFFFFFFF
            if expected is not None and actual != expected:
                # Never serve bytes that don't match the journal CRC —
                # keep looking in the other roots for an intact copy.
                last_err = (
                    f"fetch_chunk {name}/{fname}: held copy crc {actual} "
                    f"does not match journal crc {expected}"
                )
                continue
            self._bump("fetches")
            return {"kind": "chunk", "crc32": actual}, data
        raise ReplicaError(last_err)

    def _handle_probe(
        self, header: Dict[str, Any]
    ) -> Tuple[Dict[str, Any], bytes]:
        name = _safe_name(str(header.get("dataset")))
        chunk_dir = os.path.join(self._dataset_dir(name), "chunks")
        have: List[str] = []
        for entry in header.get("files", []) or []:
            fname = entry.get("file")
            if not fname:
                continue
            path = os.path.join(chunk_dir, _safe_file(str(fname)))
            if not os.path.isfile(path):
                continue
            crc = entry.get("crc32")
            if crc is None or crc32_file(path) == crc:
                have.append(str(fname))
        self._bump("probes")
        return {"kind": "probe", "have": have}, b""

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            conns = list(self._conns)
        try:
            # Closing alone does not wake a blocked accept() on every
            # platform; shutdown first, mirroring RowChannelServer.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=5)
        log.info("replica server stopped (%s)", self.addr)
