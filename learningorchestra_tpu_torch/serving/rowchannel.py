"""The row channel: length-prefixed frames between front-end workers and
the device-owning process, plus the binary columnar predict body codec.

The multi-worker front end (serving/frontend.py) splits HTTP handling
from device ownership: N accept processes parse sockets and JSON, ONE
process owns the batcher and the device. This module is the seam between
them —

- a **frame protocol**: ``u32 header_len | u32 payload_len |
  header JSON | payload bytes``. Headers are small JSON dicts carrying a
  ``kind`` plus routing fields (frame id, model name, trace context via
  ``tracing.to_wire``); payloads carry the bulk bytes (row buffers,
  proxied request/response bodies) so row data never round-trips through
  JSON on the channel;
- a **binary columnar body codec** (``application/x-lo-columnar``): a
  16-byte header + a packed float32 row-major matrix. Decoding is
  ``np.frombuffer(...).reshape(...)`` — the bytes the socket delivered
  ARE the design matrix ``design_from_rows`` feeds to the device, zero
  per-row decode. The same content type works against the single-process
  topology (serving/http.py reads it) so clients need not know the
  server's worker count;
- the **channel server** run by the device-owning process: one reader
  thread per worker connection, frames handled on a bounded pool
  (``LO_TPU_FRONTEND_CHANNEL_THREADS``) because predict frames block
  awaiting the batcher — the explicit analogue of the threaded server's
  handler threads. Replies are written under a per-connection lock so
  concurrent handlers never interleave frames.

Frame kinds worker → primary: ``predict`` (hot path: model, deadline
header, trace wire doc; payload = columnar buffer or raw JSON body),
``http`` (generic proxy: method/url/headers; payload = body), ``spans``
(the worker's sampled span docs for a finished trace — merged via
``tracing.ingest`` so ``GET /trace/{id}`` shows one trace across both
processes), ``ready`` (worker listener bound — the supervisor's startup
barrier). Primary → worker: ``probs`` (payload = float32 probability
matrix; the worker formats the JSON response), ``error`` (mapped status/
message/headers — backpressure 503s, deadline 504s, quarantine, drain),
``http_ok`` (proxied status/headers; payload = body bytes).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("serving.rowchannel")

#: Content type of the binary columnar predict body.
COLUMNAR_CONTENT_TYPE = "application/x-lo-columnar"

#: Columnar body header: magic, version, dtype code, flags, rows, cols.
_COLUMNAR_MAGIC = b"LOCB"
_COLUMNAR_HEADER = struct.Struct("<4sBBHII")
_DTYPE_F32 = 1

#: Frame length prefix: header bytes, payload bytes.
_FRAME_PREFIX = struct.Struct("<II")
#: Hard caps so a corrupt peer cannot make either side allocate wildly.
MAX_HEADER_BYTES = 1 << 20
MAX_PAYLOAD_BYTES = 256 << 20


class ChannelProtocolError(RuntimeError):
    """A malformed frame on the worker channel — the connection is torn
    down (a desynced length-prefixed stream cannot be resynced)."""


# -- binary columnar body codec ----------------------------------------------

def encode_columnar(X: np.ndarray) -> bytes:
    """Pack a 2-D float32 matrix as a columnar request body (client
    side, and the worker's re-encode of numeric JSON list rows)."""
    X = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
    if X.ndim != 2:
        raise ValueError("columnar body requires a 2-D matrix")
    n, d = X.shape
    return _COLUMNAR_HEADER.pack(_COLUMNAR_MAGIC, 1, _DTYPE_F32, 0, n, d) \
        + X.tobytes()


def decode_columnar(body: bytes) -> np.ndarray:
    """Binary columnar body → float32 design matrix, zero row decode.

    Raises ``ValueError`` on any malformation — the serving layer maps
    it to the same 406 a malformed JSON row gets, never a 500.
    """
    if len(body) < _COLUMNAR_HEADER.size:
        raise ValueError(
            f"malformed columnar body: {len(body)} bytes is shorter than "
            f"the {_COLUMNAR_HEADER.size}-byte header")
    magic, version, dtype, _flags, n, d = _COLUMNAR_HEADER.unpack_from(body)
    if magic != _COLUMNAR_MAGIC or version != 1:
        raise ValueError(
            "malformed columnar body: bad magic/version (want "
            f"{_COLUMNAR_MAGIC!r} v1, got {magic!r} v{version})")
    if dtype != _DTYPE_F32:
        raise ValueError(
            f"malformed columnar body: unsupported dtype code {dtype} "
            "(only float32=1 is defined)")
    want = _COLUMNAR_HEADER.size + 4 * n * d
    if n <= 0 or d <= 0 or len(body) != want:
        raise ValueError(
            f"malformed columnar body: header says {n}x{d} float32 "
            f"({want} bytes total) but body is {len(body)} bytes")
    # frombuffer is the zero-copy step: the socket's bytes become the
    # design matrix directly (read-only, which every downstream consumer
    # honors — padding into the AOT bucket copies anyway).
    return np.frombuffer(body, dtype=np.float32,
                         offset=_COLUMNAR_HEADER.size).reshape(n, d)


# -- frame codec ---------------------------------------------------------------

def pack_frame(header: Dict[str, Any], payload: bytes = b"") -> bytes:
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return _FRAME_PREFIX.pack(len(hdr), len(payload)) + hdr + payload


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Blocking read of exactly ``n`` bytes; b"" on clean EOF at a frame
    boundary, ChannelProtocolError on EOF mid-frame."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            if buf:
                raise ChannelProtocolError("EOF mid-frame")
            return b""
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket
               ) -> Optional[Tuple[Dict[str, Any], bytes]]:
    """Blocking frame read (primary side); None on clean EOF."""
    prefix = recv_exact(sock, _FRAME_PREFIX.size)
    if not prefix:
        return None
    hlen, plen = _FRAME_PREFIX.unpack(prefix)
    if hlen > MAX_HEADER_BYTES or plen > MAX_PAYLOAD_BYTES:
        raise ChannelProtocolError(
            f"oversized frame: header {hlen}B payload {plen}B")
    hdr_bytes = recv_exact(sock, hlen)
    if len(hdr_bytes) != hlen:
        raise ChannelProtocolError("EOF mid-frame")
    payload = recv_exact(sock, plen) if plen else b""
    if len(payload) != plen:
        raise ChannelProtocolError("EOF mid-frame")
    try:
        header = json.loads(hdr_bytes)
    except json.JSONDecodeError as e:
        raise ChannelProtocolError(f"bad frame header: {e}") from None
    if not isinstance(header, dict) or "kind" not in header:
        raise ChannelProtocolError("frame header missing 'kind'")
    return header, payload


# -- primary-side channel server ----------------------------------------------

class RowChannelServer:
    """The device-owning process's end of the row channel.

    ``handler(header, payload) -> (header, payload) | None`` runs on the
    bounded pool; a None return means no reply (fire-and-forget frames:
    ``spans``, ``ready``). Unexpected handler exceptions answer a
    generic ``error`` frame so a worker is never left holding a pending
    request forever.
    """

    def __init__(self, handler: Callable[[Dict[str, Any], bytes],
                                         Optional[Tuple[Dict[str, Any],
                                                        bytes]]],
                 host: str = "127.0.0.1", threads: int = 16,
                 on_ready: Optional[Callable[[int], None]] = None):
        self._handler = handler
        self._on_ready = on_ready
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()[:2]
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(threads)),
            thread_name_prefix="lo-rowchan")
        self._lock = threading.Lock()
        self._conns: Dict[int, Tuple[socket.socket, threading.Lock]] = {}
        self._next_conn = 0
        self._stopped = threading.Event()
        self.frames = 0
        self.replies = 0
        self.protocol_errors = 0
        # thread-lifecycle: owner=RowChannelServer; exits when stop()
        # closes the listen socket (accept raises OSError) and sets
        # _stopped; daemon so a leaked server cannot hang interpreter
        # exit.
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="lo-rowchan-accept")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return                      # stop() closed the listener
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                cid = self._next_conn = self._next_conn + 1
                self._conns[cid] = (conn, threading.Lock())
            # thread-lifecycle: owner=RowChannelServer; one reader per
            # worker connection, exits on peer EOF / protocol error /
            # stop()'s socket close; daemon for the same leak bound as
            # the accept thread.
            threading.Thread(target=self._reader_loop, args=(cid, conn),
                             daemon=True,
                             name=f"lo-rowchan-reader-{cid}").start()

    def _reader_loop(self, cid: int, conn: socket.socket) -> None:
        try:
            while True:
                frame = recv_frame(conn)
                if frame is None:
                    return
                with self._lock:
                    self.frames += 1
                self._pool.submit(self._handle_one, cid, *frame)
        except ChannelProtocolError as e:
            with self._lock:
                self.protocol_errors += 1
            log.error("row-channel conn %d protocol error: %s", cid, e)
        except OSError:
            return                          # torn down under us
        finally:
            self._drop_conn(cid)

    def _drop_conn(self, cid: int) -> None:
        with self._lock:
            ent = self._conns.pop(cid, None)
        if ent is not None:
            try:
                ent[0].close()
            except OSError:
                pass

    def _handle_one(self, cid: int, header: Dict[str, Any],
                    payload: bytes) -> None:
        if header.get("kind") == "ready":
            if self._on_ready is not None:
                try:
                    self._on_ready(int(header.get("index", -1)))
                except Exception:  # noqa: BLE001 — callback best-effort
                    traceback.print_exc()
            return
        try:
            reply = self._handler(header, payload)
        except Exception as e:  # noqa: BLE001 — worker must get an answer
            traceback.print_exc()
            reply = ({"kind": "error", "id": header.get("id"),
                      "status": 500,
                      "message": f"internal error: {e}"}, b"")
        if reply is None:
            return
        self.send(cid, reply[0], reply[1])

    def send(self, cid: int, header: Dict[str, Any],
             payload: bytes = b"") -> bool:
        """Write one frame to worker connection ``cid`` (per-connection
        write lock — concurrent pool handlers never interleave bytes).
        False when the worker is gone: its HTTP client sees the reset
        and the stock retry path takes over — nothing to do here."""
        with self._lock:
            ent = self._conns.get(cid)
        if ent is None:
            return False
        conn, wlock = ent
        data = pack_frame(header, payload)
        try:
            with wlock:
                conn.sendall(data)
            with self._lock:
                self.replies += 1
            return True
        except OSError:
            self._drop_conn(cid)
            return False

    def connections(self) -> int:
        with self._lock:
            return len(self._conns)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"connections": len(self._conns),
                    "frames_total": self.frames,
                    "replies_total": self.replies,
                    "protocol_errors_total": self.protocol_errors}

    def stop(self) -> None:
        self._stopped.set()
        # shutdown() BEFORE close(): closing an fd does NOT wake a
        # thread blocked in accept()/recv() on it (the fd stays
        # referenced) — without the shutdown, the accept thread sits
        # out the join timeout below and process exit stalls ~5 s
        # (observed live via the SIGTERM drain path).
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn, _lock in conns:
            for fn in (lambda: conn.shutdown(socket.SHUT_RDWR),
                       conn.close):
                try:
                    fn()
                except OSError:
                    pass
        self._pool.shutdown(wait=False)
        self._accept_thread.join(timeout=5.0)
