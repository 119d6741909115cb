"""Minimal threaded HTTP/JSON framework on the Python stdlib.

The reference runs 7 separate Flask apps, one per microservice, each with
its own port and copy-pasted error mapping (reference
microservices/*/server.py). This framework provides the same request
surface — JSON bodies, query params, path params, file responses, and the
406/409/404 error mapping convention (e.g. model_builder_image/
server.py:52-115) — in ~150 lines with no third-party dependency, served by
``ThreadingHTTPServer`` so long-running jobs never block other requests.
"""

from __future__ import annotations

import collections
import json
import re
import socket
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from learningorchestra_tpu_torch.utils import failpoints, tracing

#: Inbound X-Request-Id values become trace ids verbatim when they look
#: like ids; anything else (oversized, control chars, header-injection
#: attempts) is replaced with a fresh id rather than propagated.
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

#: Chaos seam at the response-write boundary — the handler computed an
#: answer the client may never (or only very late) receive. raise-mode
#: proves the error path still answers (one-shot re-entry); slow/hang
#: exercise client-side read timeouts against a committed server.
FP_PRE_RESPONSE = failpoints.declare("serving.http.pre_response")


def parse_body(raw: Optional[bytes], content_type: str) -> Optional[Dict]:
    """Request body bytes → handler body dict — THE body parse, shared
    by the threaded handler and the row-channel proxy path so a body
    parses identically whichever topology served it.

    JSON is the default; a binary columnar body
    (``application/x-lo-columnar``) decodes to ``{"rows": <float32
    matrix>}`` — the zero-copy predict fast path — and malformation maps
    to the same 406 a malformed JSON row gets, never a 500."""
    if not raw:
        return None
    base = (content_type or "").split(";", 1)[0].strip().lower()
    if base == "application/x-lo-columnar":
        from learningorchestra_tpu_torch.serving.rowchannel import (
            decode_columnar)

        try:
            return {"rows": decode_columnar(raw)}
        except ValueError as e:
            raise HttpError(406, str(e)) from None
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        raise HttpError(400, "invalid JSON body") from None


class HttpError(Exception):
    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        #: Extra response headers — e.g. the 503 pod-degraded answer
        #: carries Retry-After so clients back off for a restart window
        #: instead of hammering a pod mid-recovery.
        self.headers = dict(headers or {})


class Request:
    def __init__(self, method: str, path: str, params: Dict[str, str],
                 query: Dict[str, List[str]], body: Optional[Dict[str, Any]],
                 headers: Optional[Dict[str, str]] = None):
        self.method = method
        self.path = path
        self.params = params
        self.query = query
        self.body = body or {}
        #: Request headers, case-insensitively readable via ``header()``.
        self.headers = dict(headers or {})
        self._headers_lower = {k.lower(): v for k, v in self.headers.items()}

    def header(self, name: str, default: Optional[str] = None):
        return self._headers_lower.get(name.lower(), default)

    def q(self, name: str, default=None, cast=None):
        vals = self.query.get(name)
        if not vals:
            return default
        return cast(vals[0]) if cast else vals[0]

    def require(self, *names: str) -> List[Any]:
        out = []
        for n in names:
            if n not in self.body:
                raise HttpError(400, f"missing required field: {n}")
            out.append(self.body[n])
        return out


class FileResponse:
    def __init__(self, path: str, content_type: str = "image/png"):
        self.path = path
        self.content_type = content_type


class HtmlResponse:
    """An HTML page body — the cluster status view (the stand-in for the
    reference's dockersamples/visualizer on :80, docker-compose.yml:109-121)
    is the only non-JSON, non-file surface."""

    def __init__(self, html: str, status: int = 200):
        self.html = html
        self.status = status


class TextResponse:
    """A plain-text body — the Prometheus exposition surface
    (``GET /metrics?format=prometheus``); the version suffix in the
    default content type is the exposition-format handshake scrapers
    expect."""

    def __init__(self, text: str,
                 content_type: str =
                 "text/plain; version=0.0.4; charset=utf-8",
                 status: int = 200):
        self.text = text
        self.content_type = content_type
        self.status = status


class Router:
    def __init__(self):
        self._routes: List[Tuple[str, re.Pattern, str, Callable]] = []

    def route(self, method: str, pattern: str):
        """Register ``pattern`` like "/files/{name}"."""
        regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$")

        def deco(fn):
            self._routes.append((method.upper(), regex, pattern, fn))
            return fn

        return deco

    def dispatch(self, req_method: str, url: str, body: Optional[Dict],
                 headers: Optional[Dict[str, str]] = None,
                 attrs: Optional[Dict[str, Any]] = None) -> Tuple[int, Any]:
        """``attrs`` (the request's root-span attribute dict, recorded
        by reference at span exit) receives the matched route PATTERN —
        so per-route latency attribution aggregates
        ``/trained-models/{name}/predict`` as ONE label instead of one
        per model name (bounded cardinality by construction)."""
        parsed = urlparse(url)
        for method, regex, pattern, fn in self._routes:
            if method != req_method:
                continue
            m = regex.match(parsed.path)
            if not m:
                continue
            if attrs is not None:
                attrs["route"] = pattern
            req = Request(req_method, parsed.path, m.groupdict(),
                          parse_qs(parsed.query), body, headers)
            return fn(req)
        raise HttpError(404, f"no route: {req_method} {parsed.path}")


class IdempotencyCache:
    """Replay cache keyed by the client's ``Idempotency-Key`` header.

    Closes the POST-retry gap: a create whose response was lost to a
    connection drop (or a pod-recovery window) can be retried with the
    same key and receives the FIRST attempt's recorded outcome — success
    or error — instead of a spurious 409 from the already-landed create.
    A concurrent duplicate (client retried while the first attempt is
    still executing) waits for the original instead of racing it.
    Bounded FIFO so a long-lived server doesn't leak a record per create.
    """

    def __init__(self, cap: int = 1024, wait_timeout_s: float = 600.0):
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._cap = cap
        self._wait_timeout_s = wait_timeout_s

    def run(self, key: Optional[str], fn: Callable[[], Tuple[int, Any]]):
        if not key:
            return fn()
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                ent = {"done": threading.Event(), "outcome": None}
                self._entries[key] = ent
                while len(self._entries) > self._cap:
                    # Evict the oldest *completed* entry — in-flight
                    # ones must stay visible to their duplicates, but a
                    # long-running oldest entry (a minutes-long sync
                    # build) must not block eviction behind it.
                    victim = next((k for k, e in self._entries.items()
                                   if e["done"].is_set()), None)
                    if victim is None:
                        break
                    del self._entries[victim]
                owner = True
            else:
                owner = False
        if not owner:
            if not ent["done"].wait(self._wait_timeout_s):
                raise HttpError(
                    409, "duplicate request still in flight "
                    f"(Idempotency-Key {key})")
            kind, val = ent["outcome"]
            if kind == "ok":
                return val
            raise HttpError(val.status, val.message, headers=val.headers)
        try:
            out = fn()
            ent["outcome"] = ("ok", out)
            return out
        except HttpError as e:
            if e.status == 503:
                # Transient (pod mid-recovery): drop the entry so the
                # client's Retry-After retry RE-EXECUTES against the
                # recovered pod instead of replaying the 503 forever.
                with self._lock:
                    self._entries.pop(key, None)
            ent["outcome"] = ("err", e)
            raise
        except Exception as e:  # noqa: BLE001 — replay as a 500
            ent["outcome"] = ("err", HttpError(500, f"internal error: {e}"))
            raise
        finally:
            ent["done"].set()


def _make_handler(router: Router, request_timeout_s: Optional[float] = None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        #: TCP_NODELAY on every connection: a response goes out as two
        #: writes (headers, then body), and with Nagle's algorithm the
        #: body waits for the client's delayed ACK of the headers — about
        #: 40 ms added to every keep-alive request.
        disable_nagle_algorithm = True
        #: Per-connection socket timeout (socketserver.StreamRequestHandler
        #: applies it in setup()): a client that sends a Content-Length it
        #: never delivers — or goes dark mid-request — times out instead
        #: of pinning a handler thread forever.
        timeout = request_timeout_s or None

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _read_body(self) -> Optional[Dict]:
            length = int(self.headers.get("Content-Length") or 0)
            if not length:
                return None
            raw = self.rfile.read(length)
            # Shared parse (JSON or binary columnar) — identical to the
            # multi-worker proxy path's, so a client needn't know the
            # server's topology to pick a body format.
            return parse_body(raw,
                              self.headers.get("Content-Type") or "")

        def _send_bytes(self, status: int, content_type: str,
                        data: bytes,
                        headers: Optional[Dict[str, str]] = None) -> None:
            failpoints.fire(FP_PRE_RESPONSE)
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            # Every response carries the request's trace id: a client
            # (or a human with curl) can quote it against GET /trace/{id}
            # and the structured logs without any luck in timing.
            rid = getattr(self, "_request_id", None)
            if rid:
                self.send_header("X-Request-Id", rid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
                if k.lower() == "connection" and v.lower() == "close":
                    # Honor an explicit Connection: close (the draining
                    # 503 sends one): mark the keep-alive connection for
                    # teardown after this response so a draining server
                    # sheds its persistent connections instead of
                    # re-answering 503 on each until the socket times
                    # out.
                    self.close_connection = True
            self.end_headers()
            self.wfile.write(data)

        def _send_json(self, status: int, payload: Any,
                       headers: Optional[Dict[str, str]] = None) -> None:
            self._send_bytes(status, "application/json",
                             json.dumps(payload, default=str).encode(),
                             headers)

        def _send_file(self, resp: FileResponse) -> None:
            with open(resp.path, "rb") as f:
                data = f.read()
            self._send_bytes(200, resp.content_type, data)

        def _send_html(self, resp: HtmlResponse) -> None:
            self._send_bytes(resp.status, "text/html; charset=utf-8",
                             resp.html.encode())

        def _send_text(self, resp: TextResponse) -> None:
            self._send_bytes(resp.status, resp.content_type,
                             resp.text.encode())

        def _handle(self, method: str) -> None:
            # The trace id for this request: the client's X-Request-Id
            # when it looks like one (so retries/evidence quote a stable
            # id end to end), else freshly minted.
            inbound = self.headers.get("X-Request-Id") or ""
            rid = (inbound if _REQUEST_ID_RE.match(inbound)
                   else tracing.new_id())
            self._request_id = rid
            # "path" is the raw URL; "route" is stamped by a MATCHED
            # dispatch with the route PATTERN — what the span and the
            # per-route latency attribution carry, so
            # "/trained-models/{name}/predict" stays one label however
            # many models exist. Unmatched requests (404s) carry no
            # route at all: attribution collapses them into one "-"
            # label instead of letting a URL scanner mint an entry per
            # bogus path and exhaust the bounded table.
            attrs = {"method": method,
                     "path": self.path.split("?", 1)[0]}
            with tracing.trace("http.handle", trace_id=rid, attrs=attrs):
                try:
                    body = self._read_body()
                    status, payload = router.dispatch(
                        method, self.path, body, dict(self.headers.items()),
                        attrs=attrs)
                    attrs["status"] = status
                    if isinstance(payload, FileResponse):
                        self._send_file(payload)
                    elif isinstance(payload, HtmlResponse):
                        self._send_html(payload)
                    elif isinstance(payload, TextResponse):
                        self._send_text(payload)
                    else:
                        self._send_json(status, payload)
                except HttpError as e:
                    attrs["status"] = e.status
                    attrs["error"] = e.message
                    self._send_json(e.status, {"result": e.message},
                                    headers=e.headers)
                except (socket.timeout, TimeoutError):
                    # Connection-level timeout (half-sent body from a hung
                    # or dead client): re-raise so handle_one_request
                    # closes the connection — answering 500 here would
                    # treat a dead peer as a server bug and keep the
                    # handler thread engaged. (The root span records the
                    # error status on its way out.)
                    raise
                except Exception as e:  # noqa: BLE001 — request boundary
                    attrs["status"] = 500
                    traceback.print_exc()
                    self._send_json(500, {"result": f"internal error: {e}"})

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

        def do_PATCH(self):
            self._handle("PATCH")

        def do_DELETE(self):
            self._handle("DELETE")

    return Handler


class Server:
    """Threaded HTTP server wrapper with programmatic start/stop (tests run
    it in-process; production runs it via ``python -m
    learningorchestra_tpu_torch.serving``)."""

    def __init__(self, router: Router, host: str, port: int,
                 request_timeout_s: Optional[float] = None):
        self.httpd = ThreadingHTTPServer(
            (host, port), _make_handler(router, request_timeout_s))
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._stop_callbacks: List[Callable[[], None]] = []

    def on_stop(self, fn: Callable[[], None]) -> None:
        """Register a teardown hook run by :meth:`stop` — the app wires
        its background workers (the predict batcher's dispatcher
        threads) here so stopping the server stops them too."""
        self._stop_callbacks.append(fn)

    def start_background(self) -> "Server":
        # thread-lifecycle: owner=Server; exits when stop() calls
        # httpd.shutdown() (serve_forever returns); daemon so a test
        # that never stops cannot hang interpreter exit.
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="lo-http")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        # Teardown hooks run BEFORE server_close(): ThreadingHTTPServer
        # joins in-flight handler threads on close (block_on_close), and
        # handlers may be blocked awaiting a batcher result — stopping
        # the workers first fails those requests fast instead of
        # stalling shutdown behind their full serve timeout.
        for fn in self._stop_callbacks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — teardown best-effort
                traceback.print_exc()
        self.httpd.server_close()
