"""Multi-worker serving front end: SO_REUSEPORT accept processes + the
device-owning backend of the row channel.

``LO_TPU_HTTP_WORKERS > 1`` replaces the single threaded stdlib server
with N **accept processes** — separate interpreters, so N GILs — all
bound to the SAME host:port via ``SO_REUSEPORT`` (the kernel spreads
accepted connections across the listeners). Each worker runs a
non-blocking ``selectors`` event loop: it parses HTTP, decodes predict
bodies (JSON rows → a packed float32 matrix; binary columnar bodies
pass through untouched), and forwards frames over the length-prefixed
row channel (serving/rowchannel.py) to the ONE process that owns the
device and all serving state. Responses relay back asynchronously —
a worker never blocks on one request, and the expensive per-request
JSON encode of probabilities runs in the worker's interpreter, off the
device process's GIL.

Everything that is not the predict hot path proxies over the same
channel as a generic ``http`` frame and executes in the device-owning
process through the exact same ``Router``/``App._wrap`` stack the
threaded server uses — idempotency replay, drain gating, error mapping
and backpressure semantics are shared by construction, not re-derived.

Topology (``docs/serving.md`` §front end has the full diagram)::

     clients ──┬─► worker 0 (async accept loop) ─┐
               ├─► worker 1                      ├─ row channel ─► device
               └─► worker N-1                    ┘   (frames)      process

Semantics preserved across the process hop:

- **trace propagation** — the worker mints/validates the request id,
  roots the ``http.handle`` span, and ships the trace context in every
  frame (``tracing.to_wire`` form); the backend attaches it so
  ``queue.wait``/``dispatch.device`` spans land in the SAME trace with
  the worker's root as parent. Workers ship their finished spans back
  as ``spans`` frames (``tracing.ingest``), so ``GET /trace/{id}``
  shows one tree spanning both processes.
- **deadlines** — the raw ``X-Deadline-Ms`` header rides the frame and
  is parsed/clamped by the same ``App._deadline_ms``; expiry is the
  same terminal 504.
- **backpressure / drain** — QueueFull's computed Retry-After, the
  draining 503 + ``Connection: close``, quarantine and pod-degraded
  mappings all come from the shared ``App.map_exception``.
- **self-healing** — a worker process death is survived twice over: the
  kernel stops routing new connections to the dead listener (the
  client's stock connection-error retry lands on a live sibling), and
  the in-process :class:`WorkerSupervisor` respawns the slot under a
  restart budget with healthy-window decay
  (``LO_TPU_RESTART_BUDGET`` / ``LO_TPU_RESTART_HEALTHY_S``).
  Respawned workers start with ``LO_TPU_FAILPOINTS`` stripped — a
  one-shot chaos seam must not become a crash loop.

Worker processes import neither torch nor jax (serving/__init__ is lazy
for exactly this reason, and the package ``__init__`` loads no torch):
an accept process is a few MB of Python + numpy and starts in fractions
of a second. Workers are started with ``subprocess`` as fresh
interpreters, never forked from the process that holds the CUDA
context.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import selectors
import socket
import subprocess
import sys
import threading
import time
import traceback
from http.client import responses as _REASONS
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch.config import (
    Settings, settings as global_settings)
from learningorchestra_tpu_torch.serving import rowchannel
from learningorchestra_tpu_torch.serving.http import (
    _REQUEST_ID_RE, FileResponse, HtmlResponse, HttpError, TextResponse,
    parse_body)
from learningorchestra_tpu_torch.utils import failpoints, tracing
from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("serving.frontend")

#: Chaos seams on the worker↔batcher relay (docs/fault_tolerance.md §7):
#: ``pre_forward`` fires in the worker before a request frame enters the
#: channel (raise = the device never saw it → retryable 503; crash = a
#: worker death mid-request, survived by kernel re-routing + respawn);
#: ``pre_reply`` fires before the worker writes the relayed response
#: (raise-mode proves a computed-but-unsendable answer still ends in a
#: typed retryable error, never a hang).
FP_PRE_FORWARD = failpoints.declare("serving.front.pre_forward")
FP_PRE_REPLY = failpoints.declare("serving.front.pre_reply")

#: The predict hot path's route, matched in the worker without a Router.
PREDICT_ROUTE = "/trained-models/{name}/predict"
_PREDICT_RE = re.compile(r"^/trained-models/([^/]+)/predict$")

#: Worker span ``process`` stamp base: front-end workers are not the
#: device process (0), so they stamp 100+index — a trace's
#: ``processes`` list shows the hop explicitly.
WORKER_PROCESS_BASE = 100

_MAX_HEADER_BYTES = 64 << 10
_MAX_BODY_BYTES = 256 << 20


# =============================================================================
# Worker side (runs in the accept processes; imports no torch or jax)
# =============================================================================


class _Conn:
    """One client HTTP connection inside the worker event loop."""

    __slots__ = ("sock", "inbuf", "out", "close_after", "inflight",
                 "last_active", "open", "writing")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.inbuf = bytearray()
        self.out = bytearray()
        self.close_after = False
        self.inflight = False
        self.last_active = time.monotonic()
        self.open = True
        self.writing = False


class _Chan:
    """The worker's end of the row channel: one persistent non-blocking
    socket multiplexing every in-flight request, plus incremental frame
    parsing."""

    __slots__ = ("sock", "inbuf", "out", "alive")

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port), timeout=10.0)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.setblocking(False)
        self.inbuf = bytearray()
        self.out = bytearray()
        self.alive = True

    def queue_frame(self, header: Dict[str, Any], payload: bytes = b"") \
            -> None:
        if not self.alive:
            raise ConnectionError("row channel closed")
        self.out += rowchannel.pack_frame(header, payload)

    def parse_frames(self) -> List[Tuple[Dict[str, Any], bytes]]:
        out = []
        buf = self.inbuf
        prefix = rowchannel._FRAME_PREFIX
        while len(buf) >= prefix.size:
            hlen, plen = prefix.unpack_from(buf)
            total = prefix.size + hlen + plen
            if hlen > rowchannel.MAX_HEADER_BYTES \
                    or plen > rowchannel.MAX_PAYLOAD_BYTES:
                raise rowchannel.ChannelProtocolError("oversized frame")
            if len(buf) < total:
                break
            header = json.loads(bytes(buf[prefix.size:prefix.size + hlen]))
            payload = bytes(buf[prefix.size + hlen:total])
            del buf[:total]
            out.append((header, payload))
        return out


class FrontendWorker:
    """One accept process: async HTTP in front, the row channel behind.

    Single-threaded by design — concurrency comes from the event loop
    inside one worker and from N workers across GILs, never from
    handler threads.
    """

    def __init__(self, host: str, port: int, channel_port: int,
                 index: int, http_timeout_s: float = 30.0,
                 pending_timeout_s: float = 60.0,
                 channel_host: str = "127.0.0.1",
                 trace_sample: Optional[float] = None):
        self.host = host
        self.port = port
        self.index = index
        self.http_timeout_s = float(http_timeout_s)
        self.pending_timeout_s = float(pending_timeout_s)
        self.sel = selectors.DefaultSelector()
        self.stopping = False
        self.conns: Dict[int, _Conn] = {}
        self.pending: Dict[int, Tuple[_Conn, Dict[str, Any]]] = {}
        self._next_fid = 0
        try:
            # The supervisor forwards the primary's EFFECTIVE sampling
            # rate on the command line — a programmatic
            # Settings(trace_sample=...) must shape worker sampling
            # exactly like the single-process topology's, not whatever
            # the env happens to say.
            self._sample = float(
                global_settings.trace_sample if trace_sample is None
                else trace_sample)
        except (TypeError, ValueError):
            self._sample = 1.0
        # Channel first: if the primary is gone there is nothing to
        # serve, and failing before bind keeps the port clean.
        self.chan = _Chan(channel_host, channel_port)
        self.lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self.lsock.bind((host, port))
        self.lsock.listen(256)
        self.lsock.setblocking(False)
        self.sel.register(self.lsock, selectors.EVENT_READ, "listen")
        self.sel.register(self.chan.sock, selectors.EVENT_READ, "chan")
        # Ready handshake (raw append on purpose: the ready frame is
        # lifecycle plumbing, not a request forward — it must not trip
        # the pre_forward chaos seam). The supervisor's startup barrier
        # counts these.
        self.chan.out += rowchannel.pack_frame(
            {"kind": "ready", "index": index})
        self._chan_interest()

    # -- event loop -----------------------------------------------------------

    def run(self) -> None:
        log.info("front-end worker %d accepting on %s:%d",
                 self.index, self.host, self.port)
        try:
            while not self.stopping:
                for key, mask in self.sel.select(0.5):
                    tag = key.data
                    try:
                        if tag == "listen":
                            self._accept()
                        elif tag == "chan":
                            self._chan_io(mask)
                        else:
                            self._conn_io(tag, mask)
                    except rowchannel.ChannelProtocolError:
                        self._channel_lost()
                self._sweep()
        finally:
            self._close_all()

    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self.lsock.accept()
            except BlockingIOError:
                return
            except OSError:
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock)
            self.conns[sock.fileno()] = conn
            self.sel.register(sock, selectors.EVENT_READ, conn)

    def _conn_interest(self, conn: _Conn) -> None:
        if not conn.open:
            return
        events = selectors.EVENT_READ
        if conn.out:
            events |= selectors.EVENT_WRITE
        try:
            self.sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _chan_interest(self) -> None:
        events = selectors.EVENT_READ
        if self.chan.out:
            events |= selectors.EVENT_WRITE
        try:
            self.sel.modify(self.chan.sock, events, "chan")
        except (KeyError, ValueError, OSError):
            pass

    def _conn_io(self, conn: _Conn, mask: int) -> None:
        if mask & selectors.EVENT_WRITE and conn.out:
            try:
                sent = conn.sock.send(conn.out)
                del conn.out[:sent]
                if sent:
                    conn.last_active = time.monotonic()
            except BlockingIOError:
                pass
            except OSError:
                self._close_conn(conn)
                return
            if not conn.out:
                if conn.close_after:
                    self._close_conn(conn)
                    return
                self._conn_interest(conn)
        if mask & selectors.EVENT_READ:
            try:
                data = conn.sock.recv(1 << 18)
            except BlockingIOError:
                return
            except OSError:
                self._close_conn(conn)
                return
            if not data:
                self._close_conn(conn)
                return
            conn.last_active = time.monotonic()
            conn.inbuf += data
            self._try_parse(conn)

    def _chan_io(self, mask: int) -> None:
        if mask & selectors.EVENT_WRITE and self.chan.out:
            try:
                sent = self.chan.sock.send(self.chan.out)
                del self.chan.out[:sent]
            except BlockingIOError:
                pass
            except OSError:
                self._channel_lost()
                return
            self._chan_interest()
        if mask & selectors.EVENT_READ:
            try:
                data = self.chan.sock.recv(1 << 20)
            except BlockingIOError:
                return
            except OSError:
                self._channel_lost()
                return
            if not data:
                self._channel_lost()
                return
            self.chan.inbuf += data
            for header, payload in self.chan.parse_frames():
                self._on_chan_frame(header, payload)

    def _sweep(self) -> None:
        now = time.monotonic()
        if self.http_timeout_s > 0:
            # A non-empty out buffer does NOT exempt a connection: a
            # client that stops READING its response would otherwise
            # pin the socket + buffer forever (writes that make
            # progress refresh last_active, so only stalled writers
            # age out).
            idle = [c for c in list(self.conns.values())
                    if not c.inflight
                    and now - c.last_active > self.http_timeout_s]
            for c in idle:
                self._close_conn(c)
        stale = [fid for fid, (_c, meta) in self.pending.items()
                 if now - meta["t0"] > self.pending_timeout_s]
        for fid in stale:
            conn, meta = self.pending.pop(fid)
            self._emergency_503(conn, meta,
                                "front-end relay timed out; retry")

    # -- request handling -----------------------------------------------------

    def _try_parse(self, conn: _Conn) -> None:
        # One request in flight per connection (clients here don't
        # pipeline); parsing resumes from the buffer when the reply is
        # queued, so back-to-back keep-alive requests still stream.
        while conn.open and not conn.inflight:
            buf = conn.inbuf
            end = buf.find(b"\r\n\r\n")
            if end < 0:
                if len(buf) > _MAX_HEADER_BYTES:
                    self._direct_error(conn, 431,
                                       "request header too large")
                return
            try:
                head = bytes(buf[:end]).decode("latin-1")
                lines = head.split("\r\n")
                method, path_qs, _version = lines[0].split(" ", 2)
            except ValueError:
                self._direct_error(conn, 400, "malformed request line")
                return
            headers: Dict[str, str] = {}
            for line in lines[1:]:
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                headers.setdefault(k.strip(), v.strip())
            lower = {k.lower(): v for k, v in headers.items()}
            if "transfer-encoding" in lower:
                self._direct_error(conn, 501,
                                   "chunked request bodies unsupported")
                return
            try:
                clen = int(lower.get("content-length") or 0)
            except ValueError:
                self._direct_error(conn, 400, "bad Content-Length")
                return
            if clen < 0 or clen > _MAX_BODY_BYTES:
                self._direct_error(conn, 413, "request body too large")
                return
            total = end + 4 + clen
            if len(buf) < total:
                return
            body = bytes(buf[end + 4:total])
            del buf[:total]
            conn.inflight = True
            conn.last_active = time.monotonic()
            self._handle_request(conn, method.upper(), path_qs, headers,
                                 lower, body)

    def _handle_request(self, conn: _Conn, method: str, path_qs: str,
                        headers: Dict[str, str], lower: Dict[str, str],
                        body: bytes) -> None:
        inbound = lower.get("x-request-id") or ""
        rid = (inbound if _REQUEST_ID_RE.match(inbound)
               else tracing.new_id())
        sampled = (self._sample >= 1.0
                   or (self._sample > 0.0
                       and random.random() < self._sample))
        meta: Dict[str, Any] = {
            "rid": rid, "sid": tracing.new_id(), "sampled": sampled,
            "t0": time.monotonic(), "t_wall": tracing.now(),
            "method": method, "path": path_qs.split("?", 1)[0],
            "close": (lower.get("connection") or "").lower() == "close",
        }
        trace_doc = {"trace_id": rid, "span_id": meta["sid"],
                     "sampled": sampled}
        self._next_fid += 1
        fid = self._next_fid
        m = _PREDICT_RE.match(meta["path"])
        if method == "POST" and m:
            meta["model"] = m.group(1)
            payload = body
            ct = (lower.get("content-type") or "").split(";", 1)[0] \
                .strip().lower()
            if ct == rowchannel.COLUMNAR_CONTENT_TYPE:
                bkind = "columnar"
            else:
                bkind = "json"
                # Numeric list rows decode HERE, in the worker's
                # interpreter, and ship as the same columnar matrix a
                # binary body carries — the device process never JSON-
                # parses a row. Anything else (dict rows, malformed
                # JSON) forwards raw; the backend reproduces the exact
                # single-process behavior for it.
                rows = None
                try:
                    parsed = json.loads(body) if body else None
                    if isinstance(parsed, dict):
                        rows = parsed.get("rows")
                except (ValueError, UnicodeDecodeError):
                    rows = None
                if isinstance(rows, list) and rows \
                        and isinstance(rows[0], (list, tuple)):
                    try:
                        X = np.asarray(rows, dtype=np.float32)
                        if X.ndim == 2:
                            payload = rowchannel.encode_columnar(X)
                            bkind = "columnar"
                    except (TypeError, ValueError):
                        pass
            frame = {"kind": "predict", "id": fid,
                     "model": meta["model"],
                     "deadline": lower.get("x-deadline-ms"),
                     "body": bkind, "trace": trace_doc}
        else:
            frame = {"kind": "http", "id": fid, "method": method,
                     "url": path_qs, "headers": headers,
                     "trace": trace_doc}
            payload = body
        try:
            self._forward(conn, meta, frame, payload)
        except Exception as e:  # noqa: BLE001 — forward seam: retryable
            # The device never saw this request (the forward itself
            # failed): a retryable 503 — the stock client's backoff
            # lands the retry on a healthy path.
            try:
                self._reply(conn, meta, 503, json.dumps(
                    {"result": f"front-end forward failed: {e}"},
                    default=str).encode(), "application/json",
                    {"Retry-After": "1"}, None)
            except Exception:  # noqa: BLE001 — last-resort raw answer
                self._emergency_503(conn, meta, "front-end forward failed")

    def _forward(self, conn: _Conn, meta: Dict[str, Any],
                 header: Dict[str, Any], payload: bytes) -> None:
        failpoints.fire(FP_PRE_FORWARD)
        fid = header["id"]
        self.pending[fid] = (conn, meta)
        try:
            self.chan.queue_frame(header, payload)
        except Exception:
            self.pending.pop(fid, None)
            raise
        self._chan_interest()

    def _on_chan_frame(self, header: Dict[str, Any],
                       payload: bytes) -> None:
        kind = header.get("kind")
        ent = self.pending.pop(header.get("id") or -1, None)
        if ent is None:
            return                          # connection died meanwhile
        conn, meta = ent
        if not conn.open:
            return
        try:
            if kind == "probs":
                n, k = header.get("shape") or (0, 0)
                probs = np.frombuffer(payload, np.float32).reshape(n, k)
                # The exact response the single-process handler builds
                # (same key order, same float32→Python widening) — the
                # bytes are bit-identical by construction, just encoded
                # on this GIL instead of the device process's.
                doc = {"model": meta.get("model"),
                       "kind": header.get("mkind"),
                       "predictions": np.argmax(probs, axis=1).tolist(),
                       "probabilities": probs.tolist()}
                self._reply(conn, meta, 200,
                            json.dumps(doc, default=str).encode(),
                            "application/json", {}, header.get("route"))
            elif kind == "error":
                data = json.dumps({"result": header.get("message")},
                                  default=str).encode()
                self._reply(conn, meta, int(header.get("status", 500)),
                            data, "application/json",
                            header.get("headers") or {},
                            header.get("route"))
            elif kind == "http_ok":
                self._reply(conn, meta, int(header.get("status", 200)),
                            payload,
                            header.get("content_type")
                            or "application/json",
                            header.get("headers") or {},
                            header.get("route"))
            else:
                self._emergency_503(conn, meta,
                                    f"unknown channel frame {kind!r}")
        except Exception:  # noqa: BLE001 — reply seam: typed answer
            self._emergency_503(conn, meta, "front-end reply failed; retry")

    def _reply(self, conn: _Conn, meta: Dict[str, Any], status: int,
               data: bytes, content_type: str,
               extra_headers: Dict[str, str],
               route: Optional[str]) -> None:
        failpoints.fire(FP_PRE_REPLY)
        close = bool(meta.get("close"))
        lines = [f"HTTP/1.1 {status} {_REASONS.get(status, '')}",
                 f"Content-Type: {content_type}",
                 f"Content-Length: {len(data)}",
                 f"X-Request-Id: {meta['rid']}"]
        for k, v in (extra_headers or {}).items():
            lines.append(f"{k}: {v}")
            if k.lower() == "connection" and str(v).lower() == "close":
                close = True
        if close and "connection" not in {k.lower() for k in
                                          (extra_headers or {})}:
            lines.append("Connection: close")
        resp = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + data
        if meta["sampled"]:
            attrs: Dict[str, Any] = {"method": meta["method"],
                                     "path": meta["path"],
                                     "status": status,
                                     "worker": self.index}
            if route:
                attrs["route"] = route
            tracing.record_span(
                "http.handle", tracing.now() - meta["t_wall"],
                ctx=tracing.TraceContext(meta["rid"], meta["sid"], True),
                span_id=meta["sid"], parent_id="",
                t_wall=meta["t_wall"], attrs=attrs)
            docs = tracing.pop_spans(meta["rid"])
            if docs and self.chan.alive:
                self.chan.queue_frame({"kind": "spans"},
                                      json.dumps(docs).encode())
                self._chan_interest()
        self._queue_response(conn, resp, close)
        conn.inflight = False
        self._try_parse(conn)

    def _queue_response(self, conn: _Conn, resp: bytes,
                        close: bool) -> None:
        conn.out += resp
        conn.close_after = close
        conn.last_active = time.monotonic()
        try:
            sent = conn.sock.send(conn.out)
            del conn.out[:sent]
        except BlockingIOError:
            pass
        except OSError:
            self._close_conn(conn)
            return
        if not conn.out and close:
            self._close_conn(conn)
            return
        self._conn_interest(conn)

    def _direct_error(self, conn: _Conn, status: int, msg: str) -> None:
        """Protocol-level reject (bad request line, oversized header):
        answered locally and the connection closed — there is no request
        to forward."""
        data = json.dumps({"result": msg}).encode()
        resp = (f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(data)}\r\n"
                "Connection: close\r\n\r\n").encode("latin-1") + data
        self._queue_response(conn, resp, True)

    def _emergency_503(self, conn: _Conn, meta: Dict[str, Any],
                       msg: str) -> None:
        """Raw last-resort 503 (used when the normal reply path itself
        failed — e.g. a pre_reply chaos raise): the client must get a
        retryable answer, never a hang."""
        if not conn.open:
            return
        data = json.dumps({"result": msg}).encode()
        resp = ("HTTP/1.1 503 Service Unavailable\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(data)}\r\n"
                f"X-Request-Id: {meta.get('rid', '-')}\r\n"
                "Retry-After: 1\r\n"
                "Connection: close\r\n\r\n").encode("latin-1") + data
        conn.inflight = False
        self._queue_response(conn, resp, True)

    # -- teardown -------------------------------------------------------------

    def _close_conn(self, conn: _Conn) -> None:
        if not conn.open:
            return
        conn.open = False
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        self.conns.pop(conn.sock.fileno(), None)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _channel_lost(self) -> None:
        """The primary went away: answer every pending request 503 and
        exit — the supervisor (or the operator) owns what happens next."""
        if not self.chan.alive:
            return
        self.chan.alive = False
        log.error("front-end worker %d lost the row channel; exiting",
                  self.index)
        for fid in list(self.pending):
            conn, meta = self.pending.pop(fid)
            self._emergency_503(conn, meta,
                                "server restarting; retry")
        self.stopping = True

    def _close_all(self) -> None:
        for conn in list(self.conns.values()):
            self._close_conn(conn)
        for sock in (self.lsock, self.chan.sock):
            try:
                self.sel.unregister(sock)
            except (KeyError, ValueError):
                pass
            try:
                sock.close()
            except OSError:
                pass
        self.sel.close()


def worker_main(argv: Optional[List[str]] = None) -> int:
    from learningorchestra_tpu_torch.utils import structlog

    structlog.configure()
    ap = argparse.ArgumentParser(
        description="learningorchestra_tpu_torch front-end accept worker")
    ap.add_argument("--host", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--channel-port", type=int, required=True)
    ap.add_argument("--channel-host", default="127.0.0.1")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--http-timeout", type=float, default=30.0)
    ap.add_argument("--pending-timeout", type=float, default=60.0)
    ap.add_argument("--trace-sample", type=float, default=None)
    args = ap.parse_args(argv)
    tracing.set_process(WORKER_PROCESS_BASE + args.index)
    worker = FrontendWorker(args.host, args.port, args.channel_port,
                            args.index, http_timeout_s=args.http_timeout,
                            pending_timeout_s=args.pending_timeout,
                            channel_host=args.channel_host,
                            trace_sample=args.trace_sample)

    import signal

    def _term(_signum, _frame):
        worker.stopping = True

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    worker.run()
    return 0


# =============================================================================
# Primary side (runs in the device-owning process)
# =============================================================================


class _FrontendBackend:
    """Frame handlers for the row channel — thin adapters onto the App's
    existing serving stack, so the process hop adds no second copy of
    any semantic."""

    def __init__(self, app):
        self.app = app
        self._lock = threading.Lock()
        self.predict_frames = 0
        self.predict_binary = 0
        self.proxied_frames = 0
        self.spans_ingested = 0

    def handle_frame(self, header: Dict[str, Any], payload: bytes
                     ) -> Optional[Tuple[Dict[str, Any], bytes]]:
        kind = header.get("kind")
        if kind == "spans":
            try:
                n = tracing.ingest(json.loads(payload))
            except (ValueError, TypeError):
                n = 0
            with self._lock:
                self.spans_ingested += n
            return None
        if kind == "predict":
            return self._predict_frame(header, payload)
        if kind == "http":
            return self._http_frame(header, payload)
        return ({"kind": "error", "id": header.get("id"), "status": 500,
                 "message": f"unknown frame kind {kind!r}"}, b"")

    def _error_reply(self, fid: Any, e: Exception,
                     route: Optional[str]) -> Tuple[Dict[str, Any], bytes]:
        he = e if isinstance(e, HttpError) else self.app.map_exception(e)
        if he is None:
            traceback.print_exc()
            he = HttpError(500, f"internal error: {e}")
        return ({"kind": "error", "id": fid, "status": he.status,
                 "message": he.message, "headers": dict(he.headers),
                 "route": route}, b"")

    def _predict_frame(self, header: Dict[str, Any], payload: bytes
                       ) -> Tuple[Dict[str, Any], bytes]:
        app = self.app
        fid = header.get("id")
        binary = header.get("body") == "columnar"
        with self._lock:
            self.predict_frames += 1
            if binary:
                self.predict_binary += 1
        ctx = tracing.from_wire(header.get("trace"))
        try:
            with tracing.attach(ctx):
                if app.draining:
                    raise app.drain_error()
                from learningorchestra_tpu_torch.parallel import spmd

                spmd.require_pod_health()
                deadline_ms = app._deadline_ms(header.get("deadline"))
                if binary:
                    # ValueError → the same 406 a malformed JSON row
                    # gets (map_exception), never a 500.
                    rows: Any = rowchannel.decode_columnar(payload)
                else:
                    try:
                        body = json.loads(payload) if payload else None
                    except ValueError:
                        raise HttpError(400, "invalid JSON body") \
                            from None
                    if not isinstance(body, dict) or "rows" not in body:
                        raise HttpError(400,
                                        "missing required field: rows")
                    rows = body["rows"]
                mkind, probs = app.predictor.predict_probs(
                    str(header.get("model")), rows,
                    deadline_ms=deadline_ms)
        except Exception as e:  # noqa: BLE001 — mapped like the router
            return self._error_reply(fid, e, PREDICT_ROUTE)
        probs = np.ascontiguousarray(np.asarray(probs, np.float32))
        return ({"kind": "probs", "id": fid, "mkind": mkind,
                 "shape": [int(probs.shape[0]), int(probs.shape[1])],
                 "route": PREDICT_ROUTE}, probs.tobytes())

    def _http_frame(self, header: Dict[str, Any], payload: bytes
                    ) -> Tuple[Dict[str, Any], bytes]:
        app = self.app
        fid = header.get("id")
        method = str(header.get("method", "GET")).upper()
        url = str(header.get("url", "/"))
        headers = {str(k): str(v)
                   for k, v in (header.get("headers") or {}).items()}
        with self._lock:
            self.proxied_frames += 1
        ctx = tracing.from_wire(header.get("trace"))
        attrs: Dict[str, Any] = {}
        extra: Dict[str, str] = {}
        try:
            with tracing.attach(ctx):
                ct_in = next((v for k, v in headers.items()
                              if k.lower() == "content-type"), "")
                body = parse_body(payload, ct_in)
                status, result = app.router.dispatch(
                    method, url, body, headers, attrs=attrs)
                data, content_type, override = _render_payload(result)
                if override is not None:
                    status = override
        except HttpError as e:
            status = e.status
            extra = dict(e.headers)
            content_type = "application/json"
            data = json.dumps({"result": e.message}, default=str).encode()
        except Exception as e:  # noqa: BLE001 — request boundary
            traceback.print_exc()
            status = 500
            content_type = "application/json"
            data = json.dumps({"result": f"internal error: {e}"},
                              default=str).encode()
        return ({"kind": "http_ok", "id": fid, "status": status,
                 "content_type": content_type, "headers": extra,
                 "route": attrs.get("route")}, data)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"predict_frames_total": self.predict_frames,
                    "predict_binary_total": self.predict_binary,
                    "proxied_frames_total": self.proxied_frames,
                    "spans_ingested_total": self.spans_ingested}


def _render_payload(payload: Any) -> Tuple[bytes, str, Optional[int]]:
    """A dispatch result → (body bytes, content type, status override) —
    the wire-path mirror of the threaded handler's _send_* family."""
    if isinstance(payload, FileResponse):
        with open(payload.path, "rb") as f:
            return f.read(), payload.content_type, None
    if isinstance(payload, HtmlResponse):
        return (payload.html.encode(), "text/html; charset=utf-8",
                payload.status)
    if isinstance(payload, TextResponse):
        return payload.text.encode(), payload.content_type, payload.status
    return (json.dumps(payload, default=str).encode(),
            "application/json", None)


class WorkerSupervisor:
    """Spawns and respawns the accept processes: a restart budget,
    exponential backoff and healthy-window budget decay, per slot."""

    def __init__(self, cfg: Settings, host: str, port: int,
                 channel_port: int):
        self.cfg = cfg
        self.host = host
        self.port = port
        self.channel_port = channel_port
        self.n = max(0, int(cfg.http_workers))
        self._lock = threading.Lock()
        self._slots: List[Optional[subprocess.Popen]] = [None] * self.n
        self._next_spawn = [0.0] * self.n
        self._gave_up = [False] * self.n
        #: Restart budget is PER SLOT: one flapping worker exhausting a
        #: shared budget must not doom its healthy siblings' respawns.
        self._budget_used = [0] * self.n
        self._healthy_since = time.monotonic()
        self.respawns_total = 0
        self._stopping = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    def _cmd(self, index: int) -> List[str]:
        return [sys.executable, "-m",
                "learningorchestra_tpu_torch.serving.frontend",
                "--host", self.host, "--port", str(self.port),
                "--channel-port", str(self.channel_port),
                "--index", str(index),
                "--http-timeout", str(self.cfg.http_timeout_s),
                "--pending-timeout",
                str(float(self.cfg.serve_timeout_s) + 30.0),
                "--trace-sample", str(float(self.cfg.trace_sample))]

    def _spawn(self, index: int, first: bool) -> subprocess.Popen:
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH",
                                                            "")
        if not first:
            # A respawned worker starts with fault injection disarmed:
            # chaos seams are one-shot by convention (failpoints nth
            # semantics) and re-arming them in every incarnation would
            # turn a single injected crash into a crash loop.
            env.pop("LO_TPU_FAILPOINTS", None)
        return subprocess.Popen(self._cmd(index), env=env)

    def start(self) -> None:
        with self._lock:
            for i in range(self.n):
                self._slots[i] = self._spawn(i, first=True)
        # thread-lifecycle: owner=WorkerSupervisor; exits when stop()
        # sets _stopping (joined there); daemon so a leaked supervisor
        # cannot hang interpreter exit.
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="lo-frontend-supervisor")
        self._monitor.start()

    def _monitor_loop(self) -> None:
        while not self._stopping.wait(0.05):
            now = time.monotonic()
            with self._lock:
                alive = 0
                for i in range(self.n):
                    if self._gave_up[i]:
                        continue
                    proc = self._slots[i]
                    if proc is not None and proc.poll() is None:
                        alive += 1
                        continue
                    if proc is not None:
                        log.error(
                            "front-end worker %d exited rc=%s",
                            i, proc.returncode)
                        proc.wait()
                        self._slots[i] = None
                        self._budget_used[i] += 1
                        if self._budget_used[i] > int(
                                self.cfg.restart_budget):
                            self._gave_up[i] = True
                            log.error(
                                "front-end worker %d: restart budget "
                                "exhausted (%d); slot abandoned — "
                                "remaining workers keep accepting",
                                i, int(self.cfg.restart_budget))
                            continue
                        backoff = min(
                            float(self.cfg.restart_backoff_max_s),
                            float(self.cfg.restart_backoff_s)
                            * (2 ** max(0, self._budget_used[i] - 1)))
                        self._next_spawn[i] = now + backoff
                        log.warning(
                            "respawning front-end worker %d in %.2fs "
                            "(budget %d/%d)", i, backoff,
                            self._budget_used[i],
                            int(self.cfg.restart_budget))
                        continue
                    if now >= self._next_spawn[i]:
                        self._slots[i] = self._spawn(i, first=False)
                        self.respawns_total += 1
                if alive < self.n - sum(self._gave_up):
                    self._healthy_since = now
                elif (any(self._budget_used)
                      and float(self.cfg.restart_healthy_s) > 0
                      and now - self._healthy_since
                      >= float(self.cfg.restart_healthy_s)):
                    log.info(
                        "front-end workers healthy for %.0fs: restart "
                        "budget restored (was %s consumed)",
                        float(self.cfg.restart_healthy_s),
                        self._budget_used)
                    self._budget_used = [0] * self.n

    def alive(self) -> int:
        with self._lock:
            return sum(1 for p in self._slots
                       if p is not None and p.poll() is None)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"workers": self.n,
                    "workers_alive": sum(
                        1 for p in self._slots
                        if p is not None and p.poll() is None),
                    "respawns_total": self.respawns_total,
                    "restart_budget_used": sum(self._budget_used),
                    "slots_abandoned": sum(self._gave_up)}

    def stop(self) -> None:
        self._stopping.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        with self._lock:
            procs = [p for p in self._slots if p is not None]
            self._slots = [None] * self.n
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 5.0
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


class FrontendServer:
    """The multi-worker topology behind the same start/stop surface as
    serving.http.Server — App.serve returns one or the other and
    nothing downstream can tell (tests, __main__, the supervisor's
    drain path all keep working)."""

    def __init__(self, app, host: str, port: int):
        cfg = app.cfg
        self.host = host
        # The placeholder socket resolves port 0 once and holds the
        # port (SO_REUSEPORT, never listening) so every worker — and
        # every respawn — binds the SAME number, and the port cannot be
        # lost to another process while all workers happen to be dead.
        self._placeholder = socket.socket(socket.AF_INET,
                                          socket.SOCK_STREAM)
        self._placeholder.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEPORT, 1)
        self._placeholder.bind((host, port))
        self.port = self._placeholder.getsockname()[1]
        self.backend = _FrontendBackend(app)
        self._ready_lock = threading.Lock()
        #: DISTINCT worker indices seen ready — a respawned worker's
        #: second ready frame must not satisfy the barrier for a
        #: sibling that never bound its listener.
        self._ready_indices: set = set()
        self._ready = threading.Event()
        self.channel = rowchannel.RowChannelServer(
            self.backend.handle_frame,
            threads=cfg.frontend_channel_threads,
            on_ready=self._on_worker_ready)
        self.supervisor = WorkerSupervisor(cfg, host, self.port,
                                           self.channel.port)
        self._stop_callbacks: List[Any] = []
        self._stopped = threading.Event()
        self._started = False

    def _on_worker_ready(self, index: int) -> None:
        with self._ready_lock:
            self._ready_indices.add(index)
            if len(self._ready_indices) >= self.supervisor.n:
                self._ready.set()

    def on_stop(self, fn) -> None:
        self._stop_callbacks.append(fn)

    def start_background(self, ready_timeout_s: float = 20.0
                         ) -> "FrontendServer":
        if not self._started:
            self._started = True
            self.supervisor.start()
            if not self._ready.wait(ready_timeout_s):
                self.stop()
                raise RuntimeError(
                    f"front-end workers failed to come up within "
                    f"{ready_timeout_s:.0f}s "
                    f"({len(self._ready_indices)}/{self.supervisor.n} "
                    "ready)")
            log.info("front end up: %d accept process(es) on %s:%d",
                     self.supervisor.n, self.host, self.port)
        return self

    def serve_forever(self) -> None:
        self.start_background()
        self._stopped.wait()

    def snapshot(self) -> Dict[str, Any]:
        return {**self.supervisor.snapshot(),
                **{f"channel_{k}": v
                   for k, v in self.channel.snapshot().items()},
                **self.backend.snapshot()}

    def stop(self) -> None:
        # Workers first (stop accepting), then the app-level teardown
        # hooks (predict dispatchers, telemetry — mirrors Server.stop's
        # ordering), then the channel and the held port.
        self.supervisor.stop()
        for fn in self._stop_callbacks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — teardown best-effort
                traceback.print_exc()
        self.channel.stop()
        try:
            self._placeholder.close()
        except OSError:
            pass
        self._stopped.set()


if __name__ == "__main__":
    sys.exit(worker_main())
