"""Python client SDK.

Mirrors the reference pip package ``learning_orchestra_client`` (reference
learning_orchestra_client/__init__.py): one class per service —
``DatabaseApi``, ``Projection``, ``Histogram``, ``DataTypeHandler``,
``Tsne``, ``Pca``, ``Model`` — sharing a ``Context`` and an
``AsyncronousWait`` helper that polls a dataset's metadata until
``finished`` flips true (reference __init__.py:14-32, 3-second cadence).

Differences from the reference, by design:
- one base URL instead of seven hard-coded ports (__init__.py:56-333) —
  the server hosts every surface under path prefixes;
- polling raises ``JobFailed`` when metadata carries ``error`` (the
  reference would poll forever on a crashed job, SURVEY.md §5);
- ``Model.create_model`` takes declarative ``steps`` in place of
  arbitrary ``preprocessor_code`` (exec is opt-in server-side).
"""

from __future__ import annotations

import json
import random
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

import requests

DEFAULT_POLL_SECONDS = 3.0  # reference cadence (__init__.py:31)


class JobFailed(RuntimeError):
    pass


class JobDeadlineExpired(JobFailed):
    """A server-side job was killed by the liveness watchdog: it made no
    progress for ``LO_TPU_JOB_DEADLINE_S`` (hung device program). The
    failure is retryable INFRASTRUCTURE — the supervisor restarts the
    pod and the rescan re-runs the job, which resumes from its fit
    checkpoint — so polling the same dataset again after the pod
    recovers may find it finished. Subclasses :class:`JobFailed` so
    existing handlers keep working."""


class DeadlineExpired(RuntimeError):
    """A per-call deadline budget ran out client-side: raised instead of
    sending (or retrying) a request whose answer the caller no longer
    wants. The server's 504 for the same condition also surfaces as
    this, so callers handle one type either way."""


class Context:
    """Connection context shared by the service clients.

    ``timeout`` bounds job polling (and the synchronous model build, which
    legitimately runs for the whole fit); ``request_timeout`` bounds every
    other HTTP call so a hung server can never hang the client forever.
    Connection errors and 503s (pod mid-recovery) retry with capped,
    full-jitter exponential backoff on every method: GET/DELETE are
    idempotent by nature, and POSTs carry an ``Idempotency-Key`` header
    the server dedupes on, so a retried create whose first attempt
    actually landed replays the original response instead of surfacing a
    spurious 409 (this closes the old "POSTs never auto-retry" carve-out).

    Backoff discipline (every sleep is bounded):
    - per-attempt sleep is ``uniform(0, min(backoff_cap, base * 2^n))``
      (full jitter — a fleet of clients retrying a recovering pod must
      not stampede it in lockstep);
    - a server ``Retry-After`` hint is honored but clamped to
      ``retry_after_cap`` (a confused server must not park clients for
      an hour);
    - cumulative sleep across one logical request never exceeds
      ``max_retry_wait``: past it, the last response/error is returned/
      raised even if retries remain.
    """

    def __init__(self, base_url: str, poll_seconds: float =
                 DEFAULT_POLL_SECONDS, timeout: float = 600.0,
                 request_timeout: float = 30.0, retries: int = 3,
                 backoff_seconds: float = 0.5,
                 backoff_cap_seconds: float = 15.0,
                 retry_after_cap: float = 30.0,
                 max_retry_wait: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.poll_seconds = poll_seconds
        self.timeout = timeout
        self.request_timeout = request_timeout
        self.retries = retries
        self.backoff_seconds = backoff_seconds
        self.backoff_cap_seconds = backoff_cap_seconds
        self.retry_after_cap = retry_after_cap
        self.max_retry_wait = max_retry_wait
        self._tls = threading.local()

    def url(self, path: str) -> str:
        return f"{self.base_url}{path}"

    def _session(self) -> requests.Session:
        """One keep-alive session per (Context, thread) — connection
        reuse instead of a TCP handshake + a fresh server handler
        thread per call. Thread-local because
        ``requests.Session`` is not thread-safe."""
        s = getattr(self._tls, "session", None)
        if s is None:
            s = self._tls.session = requests.Session()
        return s

    def _backoff(self, attempt: int) -> float:
        return random.uniform(0.0, min(self.backoff_cap_seconds,
                                       self.backoff_seconds * (2 ** attempt)))

    def request(self, method: str, path: str,
                timeout: Optional[float] = None,
                retry_503: bool = True,
                deadline_ms: Optional[float] = None, **kwargs):
        """``retry_503=False`` returns a 503 response immediately instead
        of backing off: a health probe's 503 IS the answer (degraded),
        not backpressure to wait out. Connection-error retries keep
        their normal budget either way.

        ``deadline_ms`` is an END-TO-END budget for this logical call:
        every attempt carries the REMAINING budget in ``X-Deadline-Ms``
        (the server's admission control and in-queue expiry honor it),
        retry sleeps and per-attempt socket timeouts are clamped so the
        retry loop can never outlive the budget, and a spent budget
        raises :class:`DeadlineExpired` client-side rather than sending
        a request whose answer nobody will read. A 504 (the server's
        terminal deadline answer) is NEVER retried — re-sending
        already-abandoned work only deepens the overload that caused
        the miss."""
        deadline = timeout if timeout is not None else self.request_timeout
        retries = self.retries
        hard_deadline = (time.monotonic() + deadline_ms / 1e3
                         if deadline_ms is not None else None)
        if method.upper() == "POST":
            # One key per LOGICAL create, shared by all its retries: the
            # server replays the first landed attempt's response.
            headers = dict(kwargs.pop("headers", None) or {})
            headers.setdefault("Idempotency-Key", uuid.uuid4().hex)
            kwargs["headers"] = headers
        attempt = 0
        slept = 0.0

        def remaining_ms() -> Optional[float]:
            if hard_deadline is None:
                return None
            return (hard_deadline - time.monotonic()) * 1e3

        def sleep(wait: float) -> bool:
            """Sleep within the total-wait budget; False = budget spent
            (either the jitter budget or the caller's deadline)."""
            nonlocal slept
            wait = min(wait, max(0.0, self.max_retry_wait - slept))
            rem = remaining_ms()
            if rem is not None:
                # A sleep that would consume the whole remaining budget
                # guarantees the next attempt dies at admission: stop
                # retrying instead.
                if wait * 1e3 >= rem:
                    return False
                wait = min(wait, max(0.0, rem / 1e3))
            if wait <= 0 and slept >= self.max_retry_wait:
                return False
            time.sleep(wait)
            slept += wait
            return True

        while True:
            rem = remaining_ms()
            attempt_timeout = deadline
            if rem is not None:
                if rem <= 0:
                    raise DeadlineExpired(
                        f"deadline budget ({deadline_ms:.0f}ms) spent "
                        f"before {method} {path} could complete")
                # Fresh copy per attempt: mutating a caller-supplied
                # headers dict would leak this call's (stale, shrinking)
                # budget into the caller's later requests.
                headers = dict(kwargs.get("headers") or {})
                headers["X-Deadline-Ms"] = str(int(max(1, rem)))
                kwargs["headers"] = headers
                # Small slack past the remaining budget: the server
                # answers its terminal 504 AT the deadline, and cutting
                # the socket exactly there loses the typed answer to a
                # photo-finish race.
                attempt_timeout = min(deadline, rem / 1e3 + 0.5)
            try:
                resp = self._session().request(method, self.url(path),
                                               timeout=attempt_timeout,
                                               **kwargs)
            except requests.ConnectionError as e:
                # ConnectTimeout is BOTH ConnectionError and Timeout: it
                # is terminal-as-deadline only when the budget is
                # actually gone; with budget left it keeps a connection
                # error's normal retry behavior.
                if hard_deadline is not None and isinstance(
                        e, requests.Timeout) and (remaining_ms() or 0) <= 0:
                    raise DeadlineExpired(
                        f"deadline budget ({deadline_ms:.0f}ms) spent "
                        f"connecting for {method} {path}") from None
                if attempt >= retries or not sleep(self._backoff(attempt)):
                    raise
                attempt += 1
                continue
            except requests.Timeout:
                # Terminal DeadlineExpired ONLY when the budget really
                # is gone (the attempt's socket timeout was the clamped
                # remaining budget). A plain request_timeout firing with
                # budget to spare stays a Timeout — misreporting it as
                # a deadline miss would hide a retryable stall.
                if hard_deadline is not None and (remaining_ms() or 0) <= 0:
                    raise DeadlineExpired(
                        f"deadline budget ({deadline_ms:.0f}ms) spent "
                        f"waiting on {method} {path}") from None
                raise
            if resp.status_code == 503 and retry_503 and attempt < retries:
                # Pod mid-recovery (supervisor restart): honor the
                # server's backoff hint, clamped.
                try:
                    wait = float(resp.headers.get("Retry-After", ""))
                except ValueError:
                    wait = self._backoff(attempt)
                if not sleep(min(max(wait, 0.0), self.retry_after_cap)):
                    return resp
                attempt += 1
                continue
            return resp

    def get(self, path: str, **kw):
        return self.request("GET", path, **kw)

    def post(self, path: str, **kw):
        return self.request("POST", path, **kw)

    def patch(self, path: str, **kw):
        return self.request("PATCH", path, **kw)

    def delete(self, path: str, **kw):
        return self.request("DELETE", path, **kw)

    # -- tracing (GET /traces, GET /trace/{id}) ------------------------------

    def traces(self, route: Optional[str] = None,
               kind: Optional[str] = None,
               min_ms: Optional[float] = None,
               limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Recent traces from the server's ring buffer, newest first —
        filterable by route substring (HTTP traces), job kind, and
        minimum root-span duration (ms)."""
        params = {k: v for k, v in (("route", route), ("kind", kind),
                                    ("min_ms", min_ms), ("limit", limit))
                  if v is not None}
        return ResponseTreat.treatment(self.get("/traces", params=params))

    def trace(self, trace_id: str) -> Dict[str, Any]:
        """One trace's span tree (``GET /trace/{id}``). Every response
        carries its trace id in ``X-Request-Id`` — and every error this
        client raises quotes it — so the id to pass here is always at
        hand."""
        return ResponseTreat.treatment(self.get(f"/trace/{trace_id}"))


class ResponseTreat:
    """Uniform response handling (reference __init__.py:35-52)."""

    @staticmethod
    def treatment(response, pretty: bool = False):
        payload = response.json()
        if response.status_code >= 400:
            # Quote the server's X-Request-Id: the trace id of the failed
            # call, resolvable via GET /trace/{id} and greppable in the
            # server's structured logs.
            rid = response.headers.get("X-Request-Id")
            msg = (f"HTTP {response.status_code}: {payload.get('result')}"
                   + (f" [request-id {rid}]" if rid else ""))
            if response.status_code == 504:
                # The server's terminal deadline answer: typed so
                # callers handle client-side and server-side budget
                # expiry identically — and so nothing upstream is
                # tempted to retry it.
                raise DeadlineExpired(msg)
            raise RuntimeError(msg)
        return json.dumps(payload, indent=2) if pretty else payload


class AsyncronousWait:
    """Polls dataset metadata until finished (reference __init__.py:14-32;
    the misspelling is the reference's own public API name)."""

    def __init__(self, context: Context):
        self.context = context

    def wait(self, dataset_name: str,
             tolerate_missing: bool = False) -> Dict[str, Any]:
        """Poll until the dataset's metadata reports ``finished``.

        ``tolerate_missing`` keeps polling through 404s until the deadline —
        for datasets the server has *promised* to create (an async model
        build creates its prediction datasets only after preprocessing), as
        opposed to datasets that must already exist.
        """
        deadline = time.time() + self.context.timeout
        while True:
            resp = self.context.get(f"/files/{dataset_name}",
                                    params={"limit": 1})
            if resp.status_code == 404:
                if not tolerate_missing:
                    raise KeyError(f"dataset not found: {dataset_name}")
                if time.time() > deadline:
                    raise TimeoutError(
                        f"timed out waiting for {dataset_name} to appear")
                time.sleep(self.context.poll_seconds)
                continue
            docs = ResponseTreat.treatment(resp)
            if docs:
                meta = docs[0]
                if meta.get("error"):
                    retries = meta.get("retries")
                    suffix = (f" (retries={retries})"
                              if retries else "")
                    msg = f"{dataset_name}: {meta['error']}{suffix}"
                    # The watchdog's kill is typed: callers can treat
                    # "the job hung and will be retried after the pod
                    # restarts" differently from a deterministic input
                    # error that would fail identically again.
                    if str(meta["error"]).startswith(
                            "interrupted: watchdog"):
                        raise JobDeadlineExpired(msg)
                    raise JobFailed(msg)
                if meta.get("finished"):
                    return meta
            if time.time() > deadline:
                raise TimeoutError(f"timed out waiting for {dataset_name}")
            time.sleep(self.context.poll_seconds)


def micro_batches(rows: Sequence[Any],
                  max_batch: int) -> List[Sequence[Any]]:
    """Split an inline-rows payload into server-acceptable micro-batches
    (the server rejects requests above its ``serve_max_batch`` with 406;
    splitting client-side lets ``predict_online`` take any size input)."""
    if max_batch <= 0:
        raise ValueError("max_batch must be positive")
    return [rows[i:i + max_batch] for i in range(0, len(rows), max_batch)]


class _ServiceClient:
    def __init__(self, context: Context):
        self.context = context
        self.waiter = AsyncronousWait(context)


class DatabaseApi(_ServiceClient):
    """Dataset CRUD (reference __init__.py:55-101)."""

    def create_file(self, filename: str, url: str, wait: bool = False,
                    partitions: Optional[int] = None) -> Dict:
        """``partitions`` opts this ingest into the server's
        range-partitioned path (N concurrent per-host byte-range
        fetches); None defers to the server's configured default."""
        body: Dict = {"filename": filename, "url": url}
        if partitions is not None:
            body["partitions"] = int(partitions)
        resp = self.context.post("/files", json=body)
        out = ResponseTreat.treatment(resp)
        if wait:
            self.waiter.wait(filename)
        return out

    def read_file(self, filename: str, skip: int = 0, limit: int = 10,
                  query: Optional[Dict] = None) -> List[Dict]:
        params = {"skip": skip, "limit": limit}
        if query:
            params["query"] = json.dumps(query)
        return ResponseTreat.treatment(
            self.context.get(f"/files/{filename}", params=params))

    def read_files_descriptor(self) -> List[Dict]:
        return ResponseTreat.treatment(self.context.get("/files"))

    def delete_file(self, filename: str) -> Dict:
        return ResponseTreat.treatment(
            self.context.delete(f"/files/{filename}"))


class Projection(_ServiceClient):
    """Column projection (reference __init__.py:104-135)."""

    def create_projection(self, parent_filename: str,
                          projection_filename: str,
                          fields: Sequence[str],
                          wait: bool = True) -> Dict:
        self.waiter.wait(parent_filename)
        resp = self.context.post(
            f"/projections/{parent_filename}",
            json={"projection_filename": projection_filename,
                  "fields": list(fields)})
        out = ResponseTreat.treatment(resp)
        if wait:
            self.waiter.wait(projection_filename)
        return out


class Histogram(_ServiceClient):
    """Histogram creation (reference __init__.py:138-169)."""

    def create_histogram(self, parent_filename: str,
                         histogram_filename: str, fields: Sequence[str],
                         wait: bool = True) -> Dict:
        self.waiter.wait(parent_filename)
        resp = self.context.post(
            f"/histograms/{parent_filename}",
            json={"histogram_filename": histogram_filename,
                  "fields": list(fields)})
        out = ResponseTreat.treatment(resp)
        if wait:
            self.waiter.wait(histogram_filename)
        return out


class DataTypeHandler(_ServiceClient):
    """Field type coercion (reference __init__.py:311-329)."""

    def change_file_type(self, filename: str,
                         fields_dict: Dict[str, str]) -> Dict:
        self.waiter.wait(filename)
        return ResponseTreat.treatment(self.context.patch(
            f"/fieldtypes/{filename}", json=fields_dict))


class _ImageClient(_ServiceClient):
    method = ""

    def create_image_plot(self, image_name: str, parent_filename: str,
                          label_name: Optional[str] = None,
                          wait: bool = True, **kwargs) -> Dict:
        self.waiter.wait(parent_filename)
        body = {"image_name": image_name, **kwargs}
        if label_name:
            body["label_name"] = label_name
        resp = self.context.post(
            f"/{self.method}/images/{parent_filename}", json=body)
        out = ResponseTreat.treatment(resp)
        if wait and "poll" in out:
            self.waiter.wait(out["poll"])
        return out

    def read_image_plot(self, image_name: str) -> bytes:
        resp = self.context.get(f"/{self.method}/images/{image_name}")
        if resp.status_code >= 400:
            raise RuntimeError(f"HTTP {resp.status_code}")
        return resp.content

    def read_image_plots(self) -> List[str]:
        return ResponseTreat.treatment(
            self.context.get(f"/{self.method}/images"))

    def delete_image_plot(self, image_name: str) -> Dict:
        return ResponseTreat.treatment(
            self.context.delete(f"/{self.method}/images/{image_name}"))


class Tsne(_ImageClient):
    """t-SNE image service (reference __init__.py:172-240)."""

    method = "tsne"


class Pca(_ImageClient):
    """PCA image service (reference __init__.py:243-308)."""

    method = "pca"


class Observability(_ServiceClient):
    """Server-side job and metrics introspection (upgrade over the
    reference, which exposed only Spark's web UIs — SURVEY.md §5)."""

    def jobs(self) -> List[Dict]:
        return ResponseTreat.treatment(self.context.get("/jobs"))

    def metrics(self) -> Dict:
        return ResponseTreat.treatment(self.context.get("/metrics"))

    def cluster(self) -> Dict:
        return ResponseTreat.treatment(self.context.get("/cluster"))

    def traces(self, **filters) -> List[Dict]:
        return self.context.traces(**filters)

    def trace(self, trace_id: str) -> Dict:
        return self.context.trace(trace_id)

    # -- resource & capacity plane (GET /resources, /alerts, /healthz) -------

    def resources(self) -> Dict:
        """Per-device HBM + host + disk + compile snapshot of the server
        process (plus last-known worker snapshots on a pod)."""
        return ResponseTreat.treatment(self.context.get("/resources"))

    def alerts(self) -> Dict:
        """The SLO alert engine's state: firing rule names plus every
        rule's value/threshold/streaks (docs/observability.md has the
        rule table), and ``flightrec_latest`` — the freshest flight-
        recorder bundle id, when one exists."""
        return ResponseTreat.treatment(self.context.get("/alerts"))

    def replication(self) -> Dict:
        """The cross-host replication plane (``GET /replication``):
        per-dataset journal lag against each peer's acked watermark,
        the under-replicated list, push/fetch/repair counters, and the
        local ReplicaServer's counters when one is running."""
        return ResponseTreat.treatment(self.context.get("/replication"))

    def healthz(self) -> Dict:
        """The deep health rollup. Returns the check document on 200;
        raises on 503 with the FIRING ALERT NAMES in the message — a
        degraded service names its reasons instead of a bare status
        code — plus the freshest flight-recorder bundle id, so the
        error itself points at the frozen evidence. The probe never
        retries the 503 (the 503 is the answer)."""
        resp = self.context.get("/healthz", retry_503=False)
        try:
            doc = resp.json()
        except ValueError:
            doc = {}
        if resp.status_code == 503:
            checks = doc.get("checks") or {}
            firing = (checks.get("alerts") or {}).get("firing") or []
            failed = sorted(k for k, c in checks.items()
                            if isinstance(c, dict) and not c.get("ok"))
            rid = resp.headers.get("X-Request-Id")
            bundle = doc.get("flightrec_latest")
            # Under-replication names its datasets with their lag: the
            # operator reading this error knows exactly which data a
            # host loss would cost, without a second round trip.
            under = (checks.get("replication") or {}).get(
                "under_replicated") or []
            under_msg = "; under-replicated " + ", ".join(
                f"{u.get('dataset')} ({u.get('lag_bytes')}B behind "
                f"{u.get('peer')})" for u in under) if under else ""
            raise RuntimeError(
                "healthz degraded: failing checks "
                f"{failed or ['unknown']}; firing alerts "
                f"{firing or ['none']}" + under_msg
                + (f" [flight recording {bundle}]" if bundle else "")
                + (f" [request-id {rid}]" if rid else ""))
        return ResponseTreat.treatment(resp)

    # -- telemetry history & flight recorder ---------------------------------

    def history(self, series: Optional[Sequence[str]] = None,
                window_s: Optional[float] = None) -> Dict:
        """Retained metric time-series (``GET /metrics/history``):
        per-series ``[t, value]`` points merged from the server's
        in-memory ring and on-disk segments — including windows from
        BEFORE its last restart. ``series`` filters by exact name or
        dotted prefix (``serving`` matches every ``serving.*``)."""
        params: Dict[str, Any] = {}
        if series:
            params["series"] = ",".join(series)
        if window_s is not None:
            params["window"] = window_s
        return ResponseTreat.treatment(
            self.context.get("/metrics/history", params=params))

    def flight_recordings(self) -> List[Dict]:
        """Flight-recorder bundle summaries, newest first
        (``GET /debug/flightrec``) — each names its reason, wall time
        and on-disk files under ``<store_root>/_flightrec/``."""
        return ResponseTreat.treatment(
            self.context.get("/debug/flightrec"))

    def record_flight(self, reason: str = "manual") -> Dict:
        """Force a flight-recorder bundle right now
        (``POST /debug/flightrec``) — the operator's "freeze the
        evidence" button; returns the bundle id and directory."""
        return ResponseTreat.treatment(self.context.post(
            "/debug/flightrec", json={"reason": reason}))


class Model(_ServiceClient):
    """Model builder (reference __init__.py:332-370)."""

    #: Server-side per-request row cap, learned from the first 406 an
    #: oversized ``predict_online`` gets back (see there).
    _server_max_batch: Optional[int] = None

    def create_model(self, training_filename: str, test_filename: str,
                     prediction_filename: str,
                     classificators_list: Sequence[str], label: str,
                     steps: Sequence[Dict[str, Any]] = (),
                     preprocessor_code: Optional[str] = None,
                     hparams: Optional[Dict] = None,
                     sync: bool = True) -> Dict:
        # Wait on both input datasets first (reference __init__.py:358-359).
        self.waiter.wait(training_filename)
        self.waiter.wait(test_filename)
        body: Dict[str, Any] = {
            "training_filename": training_filename,
            "test_filename": test_filename,
            "prediction_filename": prediction_filename,
            "classificators_list": list(classificators_list),
            "label": label, "sync": sync,
        }
        if steps:
            body["steps"] = list(steps)
        if preprocessor_code is not None:
            body["preprocessor_code"] = preprocessor_code
        if hparams:
            body["hparams"] = hparams
        out = ResponseTreat.treatment(self.context.post(
            "/models", json=body,
            timeout=self.context.timeout if sync else None))
        if not sync:
            for c in classificators_list:
                self.waiter.wait(f"{prediction_filename}_{c}",
                                 tolerate_missing=True)
        return out

    def tune(self, training_filename: str, tune_filename: str,
             classificator: str, configs: Sequence[Dict[str, Any]],
             label: str, steps: Sequence[Dict[str, Any]] = (),
             folds: Optional[int] = None, rungs: Optional[int] = None,
             promote: bool = False, sync: bool = True) -> Dict:
        """Device-resident hyperparameter search (``POST /tune``): fit a
        population of same-family ``configs`` as ONE vmapped device
        program with masked k-fold cross-validation and successive
        halving. The leaderboard (per-config fold scores, fit seconds,
        rung survival, winner) lands in ``tune_filename``'s metadata;
        ``promote=True`` additionally refits the winner on all rows and
        persists it under ``tune_filename`` in the trained-model
        registry (servable via :meth:`predict` / :meth:`predict_online`).
        """
        self.waiter.wait(training_filename)
        body: Dict[str, Any] = {
            "training_filename": training_filename,
            "tune_filename": tune_filename,
            "classificator": classificator,
            "configs": list(configs),
            "label": label, "promote": promote, "sync": sync,
        }
        if steps:
            body["steps"] = list(steps)
        if folds is not None:
            body["folds"] = folds
        if rungs is not None:
            body["rungs"] = rungs
        out = ResponseTreat.treatment(self.context.post(
            "/tune", json=body,
            timeout=self.context.timeout if sync else None))
        if not sync:
            self.waiter.wait(tune_filename, tolerate_missing=True)
        return out

    # -- persisted-model registry (upgrade: reference discards models) ------

    def list_trained_models(self) -> List[Dict]:
        return ResponseTreat.treatment(self.context.get("/trained-models"))

    def predict(self, model_name: str, dataset_name: str,
                prediction_filename: str, wait: bool = True) -> Dict:
        """Apply a persisted model (``<prediction>_<classifier>`` from a
        previous create_model) to any stored dataset. The server runs the
        predict as an async job; ``wait`` polls the output dataset."""
        self.waiter.wait(dataset_name)
        out = ResponseTreat.treatment(self.context.post(
            f"/trained-models/{model_name}/predictions",
            json={"dataset_name": dataset_name,
                  "prediction_filename": prediction_filename}))
        if wait:
            self.waiter.wait(prediction_filename)
        return out

    def predict_online(self, model_name: str, rows: Sequence[Any],
                       max_batch: int = 256,
                       deadline_ms: Optional[float] = None
                       ) -> Dict[str, Any]:
        """Request/response predictions from the online inference tier
        (``POST /trained-models/<name>/predict`` — no dataset, no job,
        no polling; inline feature rows in, predictions out).

        Rides the standard retry machinery: a 503 from a full predict
        queue carries Retry-After, which ``Context.request`` honors
        with capped jittered backoff — so under server backpressure this
        call paces itself instead of failing. The endpoint is exempt
        from server-side idempotency replay (it is read-like), so every
        retry genuinely re-executes against the model.

        Inputs larger than ``max_batch`` (the server's per-request cap,
        ``LO_TPU_SERVE_MAX_BATCH``) split into sequential micro-batches
        client-side. A server configured with a SMALLER cap than
        ``max_batch`` rejects the oversized request with a 406 naming
        its cap; the client reads it and re-splits once instead of
        failing — so the default call works against any server
        configuration. Results concatenate in row order.

        ``deadline_ms`` is an end-to-end budget across the WHOLE call —
        all micro-batches and any retries share it. Each POST carries
        the remaining budget (``X-Deadline-Ms``; the server's admission
        control and in-queue expiry honor it), retry backoff can never
        outlive it, and expiry — client-side or the server's terminal
        504 — raises :class:`DeadlineExpired` immediately, never
        retrying (re-sending work the caller abandoned only deepens
        the overload that caused the miss).

        **Body format**: list-form numeric rows (already-assembled
        design rows) are sent as the binary columnar body
        (``application/x-lo-columnar`` — a packed float32 matrix the
        server feeds to the device with zero per-row JSON decode);
        anything else (dict rows, non-numeric values) falls back to the
        JSON body. Responses are bit-identical either way, and both
        formats work against any server topology
        (``LO_TPU_HTTP_WORKERS``).
        """
        rows = list(rows)
        # One eligibility decision per call: a clean float32 matrix
        # means every micro-batch ships binary.
        columnar = None
        if rows and isinstance(rows[0], (list, tuple)):
            import numpy as _np

            try:
                X = _np.asarray(rows, dtype=_np.float32)
                if X.ndim == 2:
                    columnar = X
            except (TypeError, ValueError):
                columnar = None
        hard_deadline = (time.monotonic() + deadline_ms / 1e3
                         if deadline_ms is not None else None)
        if self._server_max_batch is not None:
            max_batch = min(max_batch, self._server_max_batch)
        for _ in range(2):                   # second pass: server's cap
            preds: List[int] = []
            probs: List[List[float]] = []
            out: Dict[str, Any] = {}
            try:
                # An empty input still makes one POST: the server's
                # contract for empty rows (406) must surface — returning
                # a fabricated empty success would mask e.g. a typo'd
                # model name.
                for idx, chunk in enumerate(
                        micro_batches(rows, max_batch) or [rows]):
                    lo = idx * max_batch
                    rem = None
                    if hard_deadline is not None:
                        rem = (hard_deadline - time.monotonic()) * 1e3
                        if rem <= 0:
                            raise DeadlineExpired(
                                f"deadline budget ({deadline_ms:.0f}ms) "
                                "spent mid-call; "
                                f"{len(preds)}/{len(rows)} rows answered")
                    if columnar is not None:
                        from learningorchestra_tpu_torch.serving.rowchannel \
                            import (COLUMNAR_CONTENT_TYPE,
                                    encode_columnar)

                        resp = self.context.post(
                            f"/trained-models/{model_name}/predict",
                            data=encode_columnar(
                                columnar[lo:lo + max_batch]),
                            headers={"Content-Type":
                                     COLUMNAR_CONTENT_TYPE},
                            deadline_ms=rem)
                    else:
                        resp = self.context.post(
                            f"/trained-models/{model_name}/predict",
                            json={"rows": list(chunk)}, deadline_ms=rem)
                    out = ResponseTreat.treatment(resp)
                    preds.extend(out["predictions"])
                    probs.extend(out["probabilities"])
            except RuntimeError as e:
                m = re.search(r"serve_max_batch=(\d+)", str(e))
                if m and int(m.group(1)) < max_batch:
                    # Remember the server's cap so later calls split
                    # correctly up front instead of paying a guaranteed
                    # 406 round trip each time.
                    max_batch = self._server_max_batch = int(m.group(1))
                    continue
                raise
            return {"model": model_name, "kind": out.get("kind"),
                    "predictions": preds, "probabilities": probs}
        raise RuntimeError(      # pragma: no cover — loop always returns
            "predict_online failed to satisfy the server's batch cap")

    def delete_trained_model(self, model_name: str) -> Dict:
        return ResponseTreat.treatment(
            self.context.delete(f"/trained-models/{model_name}"))
