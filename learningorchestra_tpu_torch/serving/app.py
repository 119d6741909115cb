"""The service application: all 7 reference API surfaces on one server.

The reference deploys 7 Flask microservices on ports 5000-5006 (client
__init__.py:56-333; docker-compose.yml) — database_api, projection,
data_type_handler, histogram, model_builder, tsne, pca. Here each becomes a
router section of one process that embeds the engine (SURVEY.md §7: "one
service binary with the same 7 API surfaces"); per-service ports are
replaced by path prefixes. Status-code conventions follow the reference:
201 for accepted creates, 406 invalid input, 409 duplicate, 404 missing
(e.g. model_builder_image/server.py:52-115).

Async contract preserved: creates return immediately; completion is
observed by polling the dataset metadata ``finished`` flag (GET /files/...),
exactly like the reference client does (client __init__.py:14-32) — with
the upgrade that failed jobs set ``error`` and still flip ``finished``.

The JAX package's ``App`` on this package's catalog, runtime, builder,
image service and online predict tier, on one CUDA device (``device``,
``"cuda"`` unless the caller passes ``"cpu"``), with its observability
planes (``/status``, ``/metrics/history``, ``/resources``, ``/alerts``,
``/debug/flightrec``, ``/debug/profile``, ``/metrics?format=prometheus``)
the multi-process front end (``http_workers > 1``,
serving/frontend.py) and the device-resident hyperparameter search
(``POST /tune``, models/tune.py) and the pod planes: ``/cluster``,
``/replication``, the replica receive server (``replica_port``), the
``PodDegraded`` 503 and the pod-health gates of the dispatching routes
(parallel/spmd.py).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Optional

from learningorchestra_tpu_torch.catalog.dataset import ChunkCorrupt
from learningorchestra_tpu_torch.catalog.ingest import ingest_csv_url
from learningorchestra_tpu_torch.catalog.store import (
    DatasetExists, DatasetNotFound, DatasetStore)
from learningorchestra_tpu_torch import config
from learningorchestra_tpu_torch.config import (
    Settings, settings as global_settings)
from learningorchestra_tpu_torch.jobs import JobManager, select_retry_groups
from learningorchestra_tpu_torch.models.builder import ModelBuilder
from learningorchestra_tpu_torch.models.registry import validate_hparams
from learningorchestra_tpu_torch.ops.dtypes import convert_fields
from learningorchestra_tpu_torch.ops.histogram import create_histogram
from learningorchestra_tpu_torch.ops.projection import create_projection
from learningorchestra_tpu_torch.parallel import distributed, spmd
from learningorchestra_tpu_torch.parallel.mesh import collective_counts
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.serving.batcher import (
    BatcherStopped, DeadlineExceeded, DispatcherCrashed, ModelQuarantined,
    PredictBatcher, PredictTimeout, QueueFull)
from learningorchestra_tpu_torch.serving.http import (
    FileResponse, HtmlResponse, HttpError, IdempotencyCache, Router,
    Server, TextResponse)
from learningorchestra_tpu_torch.utils import (
    alerts, flightrec, resources, timeseries, tracing)
from learningorchestra_tpu_torch.utils.structlog import get_logger
from learningorchestra_tpu_torch.viz.service import (
    ImageExists, ImageNotFound, ImageService, create_embedding_image)

log = get_logger("serving")


class App:
    def __init__(self, cfg: Optional[Settings] = None, recover: bool = True,
                 device: str = "cuda"):
        self.cfg = cfg or global_settings
        # The device first: without a CUDA device the default refuses
        # before any store is loaded or job submitted.
        self.runtime = DeviceRuntime(self.cfg, device=device)
        self.store = DatasetStore(self.cfg)
        if recover and self.cfg.persist:
            self.store.load_all(resume_ingests=True)
        self.jobs = JobManager(self.store, cfg=self.cfg)
        # Interrupted ingests restart from their last journal-committed
        # source byte instead of failing (the reference restarted a crashed
        # ingest from zero — or rather, never: finished stayed false
        # forever, SURVEY.md §5).
        for rname in self.store.resumable_ingests:
            from learningorchestra_tpu_torch.catalog.ingest import (
                resume_ingest)

            self.jobs.submit(
                "ingest_resume", rname,
                lambda rname=rname: resume_ingest(self.store, rname,
                                                  self.cfg))
        self.builder = ModelBuilder(self.store, self.runtime, self.cfg)
        # The online inference tier: request handlers are thin
        # enqueue/await shims into this worker, which owns the device
        # (serving/batcher.py). Shares the builder's model registry, so
        # a fresh fit is immediately servable.
        self.predictor = PredictBatcher(self.builder.registry, self.cfg,
                                        device=str(self.runtime.device))
        self.images = {m: ImageService(m, self.cfg) for m in ("tsne", "pca")}
        #: Telemetry history (utils/timeseries.py): the background
        #: sampler snapshots _metrics_doc on its own clock (started in
        #: serve(), so bare App construction spawns no threads), and
        #: every registry read contributes a sample too, gated to the
        #: same cadence — history accrues whether or not anything
        #: scrapes the server, and survives restarts via the rotating
        #: delta segments under <store_root>/_telemetry/.
        self.history = timeseries.TelemetryHistory(
            self.cfg, source=self._metrics_doc)
        #: The SLO alert engine (utils/alerts.py), evaluated over the
        #: same registry snapshot both /metrics formats render — reads
        #: of /metrics, /alerts, /healthz and the status page drive its
        #: evaluation windows (the Prometheus scrape-window model).
        #: With the history store attached, the serving SLO rules run
        #: as multi-window burn rates over it.
        self.alerts = alerts.default_engine(self.cfg,
                                            history=self.history)
        #: Flight recorder (utils/flightrec.py): on an alert firing, a
        #: /healthz flip to 503, a dispatcher quarantine or a watchdog
        #: expiry, a bounded-retention evidence bundle (spans, history
        #: window, resources, alerts, config, versions) lands under
        #: <store_root>/_flightrec/.
        self.flightrec = flightrec.FlightRecorder(self.cfg, gather={
            "spans": lambda: tracing.recent_span_docs(2048),
            "history": lambda: self.history.query(
                window_s=self.cfg.flightrec_window_s),
            "resources": lambda: resources.process_snapshot(self.cfg),
            "alerts": self.alerts.snapshot,
        })
        flightrec.set_recorder(self.flightrec)
        #: Last /healthz verdict — the firing edge (healthy → 503) is a
        #: flight-recorder trigger.
        self._was_healthy: Optional[bool] = None
        #: POST replay cache: a create retried with the same
        #: Idempotency-Key (the client SDK sends one per logical create)
        #: returns the first attempt's outcome instead of a spurious 409.
        self.idempotency = IdempotencyCache()
        #: Graceful-drain latch (SIGTERM / App.drain): once set, new
        #: work answers 503 + Retry-After + Connection: close while
        #: in-flight predicts and queued jobs run to completion —
        #: a planned restart loses zero accepted requests.
        self._draining = threading.Event()
        #: This host's ReplicaServer (catalog/replicate.py) when
        #: ``LO_TPU_REPLICA_PORT`` is set, started by :meth:`serve` —
        #: its push/fetch counters ride the ``replication`` metrics
        #: section.
        self._replica_server = None
        #: The multi-worker front end when ``http_workers > 1``
        #: (serving/frontend.py FrontendServer), set by :meth:`serve` —
        #: its worker/channel counters feed ``/metrics`` (``frontend``
        #: section → ``lo_frontend_*``) and the health rollup.
        self._frontend = None
        self.router = Router()
        self._register()
        if recover and self.cfg.persist:
            # Jobs killed by infrastructure (a pod worker death, a process
            # restart mid-job) re-run automatically from their recorded
            # specs — the Spark lost-task re-execution analogue. Must run
            # after _register: the retry runners reuse the same builder /
            # op entry points the routes do.
            self._rescan_failed_jobs()

    # -- helpers -------------------------------------------------------------

    def drain_error(self) -> HttpError:
        """The draining 503: Retry-After sized to the drain window,
        ``Connection: close`` so the keep-alive socket is shed and the
        client's retry lands on a healthy peer instead of this exiting
        process."""
        return HttpError(
            503, "server draining for shutdown; retry elsewhere",
            headers={"Retry-After": str(max(
                1, math.ceil(self.cfg.drain_timeout_s))),
                "Connection": "close"})

    def map_exception(self, e: Exception) -> Optional[HttpError]:
        """Domain exception → the reference's status codes — THE one
        mapping, shared by the threaded handler stack (``_wrap``) and
        the multi-worker row-channel path (serving/frontend.py), so the
        process hop can never answer a different status than the
        single-process oracle. Returns None for exceptions the serving
        layer does not own (the caller re-raises → 500 boundary)."""
        try:
            raise e
        except HttpError as he:
            return he
        except QueueFull as qe:
            # Predict queue at capacity: backpressure, not failure.
            # Retry-After + 503 is the contract the client's jittered
            # backoff honors; the hint is COMPUTED from predicted queue
            # wait (depth × recent per-row service rate,
            # serving/batcher.py) — when to come back, not a constant.
            return HttpError(
                503, str(qe),
                headers={"Retry-After":
                         str(max(1, math.ceil(qe.retry_after_s)))})
        except DeadlineExceeded as de:
            # The caller's end-to-end budget is unmeetable or already
            # spent: a TERMINAL 504 — distinct from the retryable 503
            # family on purpose (the client never retries it). No
            # Retry-After: there is nothing to wait for.
            return HttpError(504, str(de))
        except ModelQuarantined as me:
            # Terminal until an operator (or a re-save) lifts it — a
            # long Retry-After so stock clients' bounded backoff gives
            # up fast instead of hammering a dead model.
            return HttpError(
                503, str(me),
                headers={"Retry-After": str(max(
                    1, math.ceil(self.cfg.restart_backoff_max_s)))})
        except DispatcherCrashed as ce:
            # The dispatcher crashed after this request's batch hit the
            # device; the supervised restart is already under way —
            # hint its first backoff step.
            return HttpError(
                503, str(ce),
                headers={"Retry-After": str(max(
                    1, math.ceil(self.cfg.serve_restart_backoff_s)))})
        except PredictTimeout as te:
            return HttpError(503, str(te), headers={"Retry-After": "5"})
        except BatcherStopped as se:
            # A request raced the model's dispatcher teardown (DELETE
            # or shutdown): transient — the retry gets the terminal
            # answer (404 if deleted, a fresh dispatcher otherwise).
            return HttpError(503, str(se), headers={"Retry-After": "1"})
        except spmd.PodDegraded as pe:
            # A degraded pod is mid-recovery (its supervisor restarts
            # it under a new mesh epoch): answer 503 + Retry-After
            # COMPUTED from the recovery machinery's own knobs — the
            # supervisor needs a health-poll interval to notice plus
            # its first restart backoff — instead of a hard-coded
            # constant.
            return HttpError(
                503, str(pe),
                headers={"Retry-After": str(max(1, math.ceil(
                    self.cfg.health_interval_s
                    + self.cfg.restart_backoff_s)))})
        except resources.ProfilerBusy as pb:
            # One profiler trace at a time per process: the operator's
            # second capture conflicts with the running one.
            return HttpError(409, str(pb))
        except ChunkCorrupt as xe:
            # Integrity failure the replica couldn't heal: a precise
            # 500 naming the chunk/checksums, not a parse traceback.
            return HttpError(500, str(xe))
        except DatasetNotFound as ne:
            return HttpError(404, f"dataset not found: {ne}")
        except ImageNotFound as ie:
            return HttpError(404, f"image not found: {ie}")
        except (DatasetExists, ImageExists) as ee:
            return HttpError(409, f"duplicate: {ee}")
        except KeyError as ke:
            return HttpError(404, str(ke))
        except PermissionError as pr:
            return HttpError(403, str(pr))
        except ValueError as ve:
            return HttpError(406, str(ve))
        except Exception:  # noqa: BLE001 — not serving-owned: 500 boundary
            return None

    def _wrap(self, fn, replay_posts: bool = True):
        """Translate domain exceptions to the reference's status codes.

        The conversion runs INSIDE the idempotency replay boundary: a
        duplicate create replays the first attempt's mapped status
        (e.g. 409), never a generic 500 wrapper around the raw domain
        exception. ``replay_posts=False`` exempts a POST route from the
        replay cache entirely — the online ``/predict`` endpoint is
        read-like (it creates nothing), so a retried request must hit
        the model again, never replay a cached response.
        """

        def convert(req):
            if req.method in ("POST", "PATCH", "DELETE") and \
                    self._draining.is_set():
                # Draining: no NEW work — in-flight requests finish,
                # reads keep serving (operators watch the drain through
                # them).
                raise self.drain_error()
            try:
                return fn(req)
            except HttpError:
                raise
            except Exception as e:  # noqa: BLE001 — mapped or re-raised
                mapped = self.map_exception(e)
                if mapped is None:
                    raise
                raise mapped from e

        def inner(req):
            if req.method == "POST" and replay_posts:
                key = req.header("Idempotency-Key")
                # Key scoped per path: a client reusing one key against a
                # different endpoint must not replay the wrong response.
                return self.idempotency.run(
                    f"{req.path}|{key}" if key else None,
                    lambda: convert(req))
            return convert(req)

        return inner

    def _route(self, method: str, pattern: str, replay_posts: bool = True):
        def deco(fn):
            return self.router.route(method, pattern)(
                self._wrap(fn, replay_posts=replay_posts))

        return deco

    def _deadline_ms(self, header: Optional[str]) -> Optional[float]:
        """The effective deadline budget for one predict request:
        client header clamped to ``serve_deadline_cap_ms``, falling back
        to ``serve_deadline_default_ms`` (0 = none). A malformed header
        is a client error worth naming, not silently ignoring."""
        cap = float(self.cfg.serve_deadline_cap_ms)
        if cap <= 0:
            return None                    # deadline handling disabled
        if header is None or not str(header).strip():
            default = float(self.cfg.serve_deadline_default_ms)
            return min(default, cap) if default > 0 else None
        try:
            budget = float(header)
        except ValueError:
            raise ValueError(
                f"X-Deadline-Ms must be a number of milliseconds, got "
                f"{header!r}") from None
        if budget <= 0:
            # The caller's budget is already spent: pass it through —
            # the predict tier answers the terminal 504 WITH per-model
            # accounting (deadline_exceeded counter + trace record),
            # which raising here would silently skip.
            return budget
        return min(budget, cap)

    # -- routes --------------------------------------------------------------

    def _register(self) -> None:
        app = self

        # ---- database_api (reference database_api_image/server.py:33-96)
        @self._route("POST", "/files")
        def create_file(req):
            filename, url = req.require("filename", "url")
            # Optional per-request override of the range-partitioned
            # ingest fan-out (LO_TPU_INGEST_PARTITIONS supplies the
            # default); 0/1 forces the serial path for this file.
            partitions = req.body.get("partitions")
            cfg = app.cfg
            if partitions is not None:
                cfg = cfg.replace(ingest_partitions=int(partitions))
            app.store.create(filename, url=url)
            app.jobs.submit(
                "ingest", filename,
                lambda: ingest_csv_url(app.store, filename, url, cfg))
            return 201, {"result": f"file {filename} created",
                         "filename": filename}

        @self._route("GET", "/files")
        def list_files(_req):
            return 200, app.store.metadata_docs()

        @self._route("GET", "/files/{name}")
        def read_file(req):
            limit = min(req.q("limit", 10, int), app.cfg.read_limit_cap)
            skip = req.q("skip", 0, int)
            query = req.q("query")
            query = json.loads(query) if query else {}
            return 200, app.store.read(req.params["name"], skip=skip,
                                       limit=limit, query=query)

        @self._route("DELETE", "/files/{name}")
        def delete_file(req):
            app.store.delete(req.params["name"])
            return 200, {"result": "deleted"}

        # ---- projection (reference projection_image/server.py:50-115)
        @self._route("POST", "/projections/{parent}")
        def projection(req):
            parent = req.params["parent"]
            name, fields = req.require("projection_filename", "fields")
            if not app.store.exists(parent):
                raise DatasetNotFound(parent)
            # Validate fields synchronously (reference returns 406 inline).
            parent_fields = app.store.get(parent).metadata.fields
            missing = [f for f in fields if f not in parent_fields]
            if missing:
                raise ValueError(f"fields not in dataset: {missing}")
            app.store.create(name, parent=parent, extra={"job": {
                "kind": "projection", "parent": parent, "name": name,
                "fields": list(fields)}})
            app.jobs.submit(
                "projection", name,
                lambda: create_projection(app.store, parent, name, fields,
                                          existing=True))
            return 201, {"result": f"projection {name} created"}

        # ---- histogram (reference histogram_image/server.py)
        @self._route("POST", "/histograms/{parent}")
        def histogram(req):
            spmd.require_pod_health()
            parent = req.params["parent"]
            name, fields = req.require("histogram_filename", "fields")
            if not app.store.exists(parent):
                raise DatasetNotFound(parent)
            parent_fields = app.store.get(parent).metadata.fields
            missing = [f for f in fields if f not in parent_fields]
            if missing:
                raise ValueError(f"fields not in dataset: {missing}")
            app.store.create(name, parent=parent, extra={"job": {
                "kind": "histogram", "parent": parent, "name": name,
                "fields": list(fields)}})
            app.jobs.submit(
                "histogram", name,
                lambda: create_histogram(app.store, parent, name, fields,
                                         existing=True,
                                         runtime=app.runtime))
            return 201, {"result": f"histogram {name} created"}

        # ---- data_type_handler (reference data_type_handler server.py:46-76)
        @self._route("PATCH", "/fieldtypes/{name}")
        def fieldtypes(req):
            convert_fields(app.store, req.params["name"], req.body)
            return 200, {"result": "types converted"}

        # ---- model_builder (reference model_builder_image/server.py:52-115)
        @self._route("POST", "/models")
        def models(req):
            spmd.require_pod_health()
            (train, test, pred_name, classifiers, label) = req.require(
                "training_filename", "test_filename", "prediction_filename",
                "classificators_list", "label")
            steps = req.body.get("steps", ())
            code = req.body.get("preprocessor_code")
            hparams = req.body.get("hparams")
            sync = bool(req.body.get("sync", True))
            app.builder.validate(train, test, classifiers, pred_name)
            # Hyperparameter admission: unknown names / out-of-range
            # values 406 HERE, naming the offending key — never a
            # TypeError-500 from a **kwargs splat deep inside a trainer
            # (or worse, a stranded async prediction dataset).
            for c in classifiers:
                validate_hparams(c, (hparams or {}).get(c))

            if sync:
                # The reference's POST /models blocks until all fits finish
                # (SURVEY.md §3.2 "synchronous 201").
                reports = app.builder.build(train, test, pred_name,
                                            classifiers, label, steps=steps,
                                            preprocessor_code=code,
                                            hparams=hparams)
                return 201, {"result": [
                    {"classifier": r.kind, "fit_time": r.fit_time,
                     **r.metrics} for r in reports]}

            # Create every prediction dataset up front (metadata-first), so
            # a failure at ANY point of the async build is pollable on all
            # of them — never the reference's finished:false-forever state.
            # Each carries the job spec that created it: if the process
            # dies mid-build, the restarted one re-runs the build from
            # this record (exec preprocessor code is excluded — an exec
            # job is not provably re-runnable, so it fails permanently).
            pred_datasets = [f"{pred_name}_{c}" for c in classifiers]
            job_spec = None if code is not None else {
                "kind": "model_builder", "train": train, "test": test,
                "pred_name": pred_name, "classifiers": list(classifiers),
                "label": label, "steps": list(steps),
                "hparams": hparams or {}}
            for c in classifiers:
                extra = {"classifier": c, "label": label}
                if job_spec is not None:
                    extra["job"] = job_spec
                app.store.create(f"{pred_name}_{c}", parent=test,
                                 extra=extra)

            def run():
                app.builder.build(train, test, pred_name, classifiers, label,
                                  steps=steps, preprocessor_code=code,
                                  hparams=hparams, existing=True)

            app.jobs.submit("model_builder", pred_datasets, run)
            return 201, {"result": "model build started",
                         "prediction_datasets": pred_datasets}

        # ---- device-resident hyperparameter search (models/tune.py):
        # one family, a population of configs fitted together on the
        # card, masked k-fold CV over the resident design, successive
        # halving on checkpoint rungs. The leaderboard lands in the
        # marker dataset's metadata; promote=true also refits the winner
        # on all rows and persists it under tune_filename in the
        # trained-model registry.
        @self._route("POST", "/tune")
        def tune_sweep(req):
            spmd.require_pod_health()
            (train, out, classifier, configs, label) = req.require(
                "training_filename", "tune_filename", "classificator",
                "configs", "label")
            steps = req.body.get("steps", ())
            folds = req.body.get("folds")
            rungs = req.body.get("rungs")
            promote = bool(req.body.get("promote", False))
            sync = bool(req.body.get("sync", True))
            # Admission BEFORE any dataset exists: a bad config 406s
            # naming the offending key (models/registry.HPARAM_SPECS)
            # instead of stranding a doomed async marker.
            app.builder.validate_tune(train, out, classifier, configs)

            if sync:
                board = app.builder.tune(train, out, classifier, configs,
                                         label, steps=steps, folds=folds,
                                         rungs=rungs, promote=promote)
                return 201, {"result": board}

            # Metadata-first marker + recorded job spec: a process death
            # mid-sweep re-runs the sweep from this record, and the
            # rung-boundary fit checkpoints make the re-run resume
            # instead of restarting (builder.tune → tune.sweep).
            job_spec = {"kind": "tune", "train": train, "out": out,
                        "classifier": classifier,
                        "configs": list(configs), "label": label,
                        "steps": list(steps), "folds": folds,
                        "rungs": rungs, "promote": promote}
            app.store.create(out, parent=train,
                             extra={"classifier": classifier,
                                    "label": label, "tune": True,
                                    "job": job_spec})

            def run():
                app.builder.tune(train, out, classifier, configs, label,
                                 steps=steps, folds=folds, rungs=rungs,
                                 promote=promote, existing=True)

            app.jobs.submit("tune", out, run)
            return 201, {"result": "tune sweep started", "poll": out}

        # ---- trained-model registry (upgrade: the reference discards
        # fitted models, SURVEY.md §5; here they persist + re-serve)
        @self._route("GET", "/trained-models")
        def list_trained_models(_req):
            return 200, app.builder.registry.list()

        @self._route("DELETE", "/trained-models/{name}")
        def delete_trained_model(req):
            app.builder.registry.delete(req.params["name"])
            # The loaded entry for the deleted model is stale; the next
            # /predict re-stats the manifest and 404s cleanly.
            app.predictor.invalidate(req.params["name"])
            return 200, {"result": "deleted"}

        # ---- online inference (the request/response path the reference
        # never had: predictions only ever materialized as batch jobs).
        # NOT idempotency-replayed: /predict is read-like — two identical
        # POSTs must both hit the model, never a cached response.
        @self._route("POST", "/trained-models/{name}/predict",
                     replay_posts=False)
        def model_predict_online(req):
            spmd.require_pod_health()
            (rows,) = req.require("rows")
            # End-to-end deadline: the client's remaining budget rides
            # the X-Deadline-Ms header (clamped; absent → the server
            # default, 0 = none). Admission, queueing and dispatch all
            # honor it (serving/batcher.py) — expiry is a terminal 504.
            deadline_ms = app._deadline_ms(req.header("X-Deadline-Ms"))
            # Thin enqueue/await shim: feature prep runs here on the
            # handler thread; the per-model dispatcher thread coalesces
            # concurrent requests into one padded device dispatch and
            # scatters the rows back (serving/batcher.py).
            return 200, app.predictor.predict(req.params["name"], rows,
                                              deadline_ms=deadline_ms)

        @self._route("POST", "/trained-models/{name}/predictions")
        def model_predict(req):
            spmd.require_pod_health()
            name = req.params["name"]
            dataset, out = req.require("dataset_name", "prediction_filename")
            if app.store.exists(out):
                raise DatasetExists(out)
            man = app.builder.registry.manifest(name)   # 404 when missing
            if not app.store.exists(dataset):
                raise DatasetNotFound(dataset)
            if man.get("preprocess") is None:
                # Keep the synchronous 406 contract: a model without
                # preprocessing state can never re-serve, so failing
                # inside the job would just strand a doomed dataset under
                # the requested name.
                raise ValueError(
                    f"model {name} was exec-preprocessed; it carries no "
                    "reproducible preprocessing state to apply to new "
                    "datasets")
            # Metadata-first + async job, like every other compute route: a
            # long predict must not block the HTTP worker, duplicate
            # requests collide on the created dataset (409), and a crash
            # mid-predict leaves a pollable failure record.
            app.store.create(out, parent=dataset,
                             extra={"model": name, "kind": man["kind"],
                                    "job": {"kind": "model_predict",
                                            "model": name,
                                            "dataset": dataset,
                                            "out": out}})
            app.jobs.submit(
                "model_predict", out,
                lambda: app.builder.predict(name, dataset, out,
                                            existing=True))
            return 201, {"result": f"prediction dataset {out} created",
                         "prediction_filename": out}

        # ---- tsne / pca images (reference tsne_image/server.py:57-155)
        for method in ("tsne", "pca"):
            self._register_images(method)

        # ---- catalog administration
        @self._route("POST", "/catalog/scrub")
        def catalog_scrub(req):
            # Proactive integrity pass over the journaled chunk store:
            # verify every chunk checksum, repair from the replica where
            # possible, report what couldn't be healed. Synchronous by
            # design — an admin operation whose caller wants the verdict.
            name = req.body.get("dataset")
            if name is not None and not app.store.exists(name):
                raise DatasetNotFound(name)
            return 200, app.store.scrub(name)

        # ---- observability (upgrade; reference exposed Spark UIs only)
        @self._route("GET", "/jobs")
        def jobs(_req):
            return 200, app.jobs.records()

        @self._route("GET", "/cluster")
        def cluster(_req):
            # The supervisor polls this: ``pod_error`` non-null means the
            # pod is degraded and should be restarted under a new epoch.
            info = distributed.process_info(str(app.runtime.device))
            info["mesh"] = dict(app.runtime.mesh.shape)
            info["mesh_epoch"] = spmd.mesh_epoch()
            info["pod_error"] = spmd.pod_error()
            info["healthy"] = info["pod_error"] is None
            info["restarts"] = config.restart_count()
            # Per-process resource snapshots: this process sampled live,
            # workers from their last job-channel shipment — so a
            # multi-process pod's host RSS / device memory is comparable
            # at a glance (lite form: no per-dataset disk walk). Each
            # carries its process's kernel launches by wrapper and its
            # collectives by kind and mesh axis.
            info["resources"] = {
                str(info["process_index"]): dict(
                    resources.process_snapshot(app.cfg, lite=True),
                    launches=spmd.kernel_launches(),
                    collectives=collective_counts()),
                **{str(k): v
                   for k, v in resources.remote_snapshots().items()},
            }
            return 200, info

        @self._route("GET", "/status")
        def status_page(_req):
            # HTML operator view of the same data /jobs and /files
            # serve — the reference's Swarm visualizer equivalent
            # (docker-compose.yml:109-121).
            from learningorchestra_tpu_torch.serving.status_page import (
                render_status)

            dev = app.runtime.device
            proc = distributed.process_info(str(dev))
            info = {"process_index": proc["process_index"],
                    "process_count": proc["process_count"],
                    "device": str(dev), "platform": dev.type,
                    "mesh_epoch": config.mesh_epoch(),
                    "state": "draining" if app.draining else "serving"}
            # The page's 5 s auto-refresh doubles as the alert engine's
            # heartbeat on watched deployments (_metrics_doc evaluates).
            mdoc = app._metrics_doc()
            return 200, HtmlResponse(render_status(
                info, app.jobs.records(), app.store.metadata_docs(),
                serving=mdoc.get("serving"),
                alerts=mdoc.get("alerts"),
                resources=mdoc.get("resources"),
                attribution=mdoc.get("latency_attribution"),
                # Bounded window: the sparklines render ~140px — serve
                # them from the in-memory ring, never a decode of every
                # retained disk segment per 5 s auto-refresh.
                history=app.history.query(series=[
                    "serving.qps", "serving.queue_rows",
                    "serving.requests", "resources.host.rss_bytes"],
                    window_s=3600)))

        @self._route("GET", "/metrics")
        def metrics(req):
            doc = app._metrics_doc()
            if req.q("format") == "prometheus":
                from learningorchestra_tpu_torch.utils import prometheus

                # Same registry snapshot, second format: the exposition
                # text is rendered from the identical doc the JSON view
                # serves, so the two can never disagree.
                return 200, TextResponse(prometheus.render(doc))
            return 200, doc

        @self._route("GET", "/metrics/history")
        def metrics_history(req):
            # The retained time-series behind the instantaneous
            # /metrics view: ring + on-disk delta segments, so the
            # answer covers windows no scrape happened to observe —
            # including pre-restart ones.
            app._metrics_doc()          # contribute a sample (gated)
            series = req.q("series")
            window = req.q("window", cast=float)
            return 200, app.history.query(
                series=[s.strip() for s in series.split(",") if s.strip()]
                if series else None,
                window_s=window)

        # ---- tracing (the request/job-scoped view /metrics can't give:
        # "where did THIS request spend its time")
        @self._route("GET", "/traces")
        def traces(req):
            return 200, tracing.recent_traces(
                route=req.q("route"),
                kind=req.q("kind"),
                min_ms=req.q("min_ms", cast=float),
                limit=req.q("limit", 50, int))

        @self._route("GET", "/trace/{trace_id}")
        def trace_by_id(req):
            tree = tracing.trace_tree(req.params["trace_id"])
            if tree is None:
                raise HttpError(
                    404, f"no spans for trace {req.params['trace_id']} "
                    "(expired from the ring buffer, unsampled, or never "
                    "existed)")
            return 200, tree

        # ---- resource & capacity plane (utils/resources.py, /alerts.py)
        @self._route("GET", "/resources")
        def resources_view(_req):
            # Device memory + host + disk + compile accounting for THIS
            # process, plus last-known worker snapshots on a pod.
            doc = resources.process_snapshot(app.cfg)
            workers = resources.remote_snapshots()
            if workers:
                doc["workers"] = {str(k): v for k, v in workers.items()}
            return 200, doc

        @self._route("GET", "/replication")
        def replication_view(_req):
            # The replication section of /metrics, standalone (the
            # client SDK's Observability.replication() passthrough):
            # per-dataset lag against each peer's acked watermark, the
            # under-replicated list, push/fetch/repair counters. Reading
            # it ticks the push committer's retry check like a scrape.
            doc = app.store.replication_snapshot()
            if app._replica_server is not None:
                doc["server"] = app._replica_server.snapshot()
            return 200, doc

        @self._route("GET", "/alerts")
        def alerts_view(_req):
            # Reading /alerts advances an evaluation window like every
            # other registry read — an operator polling this page IS the
            # alert engine's clock.
            app._metrics_doc()
            doc = app.alerts.snapshot()
            # The freshest evidence bundle rides along so anything that
            # reports a firing alert can point at it (the client SDK
            # quotes it in raised errors).
            doc["flightrec_latest"] = app.flightrec.latest()
            return 200, doc

        @self._route("GET", "/healthz")
        def healthz(_req):
            doc = app._health_doc()
            healthy = doc["healthy"]
            if app._was_healthy is not False and not healthy:
                # The healthy → 503 edge is itself an incident worth
                # freezing: by the time a human reads the page, the
                # trace ring has moved on.
                app.flightrec.dump(
                    "healthz:503",
                    detail={"checks": {
                        k: c for k, c in doc["checks"].items()
                        if isinstance(c, dict) and not c.get("ok")}})
                doc["flightrec_latest"] = app.flightrec.latest()
            app._was_healthy = healthy
            return (200 if healthy else 503), doc

        @self._route("GET", "/debug/flightrec")
        def flightrec_list(_req):
            return 200, app.flightrec.list()

        @self._route("POST", "/debug/flightrec", replay_posts=False)
        def flightrec_dump(req):
            # Manual trigger: bypasses the automatic-dump rate limit
            # (an operator asking for evidence should get it), still
            # bounded by retention. Read-like — never idempotency-
            # replayed.
            reason = str(req.body.get("reason") or "manual")
            bundle = app.flightrec.dump(f"manual:{reason}", force=True)
            if bundle is None:
                raise ValueError(
                    "flight recorder disabled (LO_TPU_FLIGHTREC_KEEP=0) "
                    "or dump failed — see server logs")
            return 201, {"result": "flight-recorder bundle dumped",
                         "bundle": bundle,
                         "dir": os.path.join(app.flightrec.root, bundle)}

        @self._route("POST", "/debug/profile")
        def debug_profile(req):
            # Knob-gated (LO_TPU_DEBUG_PROFILE): profiling costs real
            # overhead and writes operator-readable traces to disk, so
            # it is an explicit opt-in → 403 otherwise.
            if not app.cfg.debug_profile:
                raise PermissionError(
                    "on-demand profiling is disabled; set "
                    "LO_TPU_DEBUG_PROFILE=1 to enable POST /debug/profile")
            try:
                seconds = float(req.body.get("seconds", 2.0))
            except (TypeError, ValueError):
                raise ValueError("seconds must be a number") from None
            if seconds <= 0 or seconds > resources.PROFILE_MAX_SECONDS:
                raise ValueError(
                    f"seconds must be in (0, "
                    f"{resources.PROFILE_MAX_SECONDS:.0f}]")
            if resources.profiler_busy():
                raise resources.ProfilerBusy(
                    "a profiler trace is already running in this "
                    "process; retry when it ends")
            out_dir = os.path.join(
                app.cfg.store_root, "_profiles",
                time.strftime("%Y%m%d-%H%M%S"))
            rec = app.jobs.submit(
                "debug_profile", [],
                lambda: resources.capture_profile(out_dir, seconds))
            return 201, {"result": "profile capture started",
                         "dir": out_dir, "seconds": seconds,
                         "job_id": rec.job_id}

    def _metrics_doc(self) -> dict:
        """The one metrics registry snapshot both /metrics formats render
        (JSON as-is; ?format=prometheus through utils/prometheus): the
        JAX package's sections for the planes this package has. The
        alert engine evaluates over this exact snapshot — window-gated,
        so scrape cadence is evaluation cadence — and its state rides
        back in the same document, so an alert can never fire on a
        number the operator cannot see."""
        from learningorchestra_tpu_torch import jobs as jobs_module
        from learningorchestra_tpu_torch.catalog import ingest as ingest_module
        from learningorchestra_tpu_torch.catalog import readpipe
        from learningorchestra_tpu_torch.models import tune as tune_module
        from learningorchestra_tpu_torch.utils import fitckpt
        from learningorchestra_tpu_torch.utils.profiling import op_timer

        pod_error = spmd.pod_error()
        by_status: dict = {}
        for r in self.jobs.records():
            by_status[r["status"]] = by_status.get(r["status"], 0) + 1
        doc = {"state": "draining" if self.draining else "serving",
               "ops": op_timer.snapshot(),
               "jobs": by_status,
               "job_fault": jobs_module.fault_snapshot(),
               # The resumable-fit plane: the fit-checkpoint store's
               # disk footprint and its write/resume/discard counters.
               "fit_checkpoints": fitckpt.disk_snapshot(self.cfg),
               # Hyperparameter-search plane: populations fitted,
               # candidates evaluated, halving drops, memory-budget wave
               # spills (rendered as lo_tune_* on the exposition
               # surface).
               "tune": tune_module.counters_snapshot(),
               "integrity": self.store.integrity_snapshot(),
               "read_pipeline": readpipe.snapshot(),
               "ingest": ingest_module.counters_snapshot(),
               "shard": readpipe.shard_snapshot(),
               "serving": self.predictor.snapshot(),
               "tracing": tracing.counters_snapshot(),
               # The span-taxonomy aggregation: per-model queue-wait /
               # device / design histograms, per-family fit sub-phases,
               # per-route handling — "where did the p99 go" without
               # grepping /traces.
               "latency_attribution": tracing.attribution_snapshot(),
               "pod": {"error": pod_error,
                       "degraded": pod_error is not None},
               "profile_dir": self.cfg.profile_dir or None,
               "resources": resources.process_snapshot(self.cfg),
               "compile": resources.compile_snapshot(),
               # Cross-host replication plane: per-dataset lag against
               # each peer's acked watermark, push/fetch/repair
               # counters, the under-replicated list. Snapshotting
               # doubles as the read-driven retry tick.
               "replication": self.store.replication_snapshot()}
        if self._replica_server is not None:
            doc["replication"]["server"] = self._replica_server.snapshot()
        if self._frontend is not None:
            # Multi-worker topology only: accept-process liveness,
            # respawn accounting and row-channel frame counters
            # (rendered as lo_frontend_* on the exposition surface).
            doc["frontend"] = self._frontend.snapshot()
        # History BEFORE alert evaluation: the burn-rate rules read the
        # store, so the sample that triggered this read must be in it.
        self.history.observe(doc)
        doc["telemetry"] = self.history.snapshot()
        transitions = self.alerts.observe(doc)
        doc["alerts"] = self.alerts.snapshot()
        for t in transitions:
            if t["to"] == "firing":
                # Freeze the evidence at the transition: rate-limited
                # (flightrec_min_interval_s), so a flapping rule
                # records its first edge, not one bundle per flap.
                self.flightrec.dump(f"alert:{t['alert']}", detail=t,
                                    doc=doc)
        doc["flightrec"] = self.flightrec.snapshot()
        return doc

    def _health_doc(self) -> dict:
        """The deep ``GET /healthz`` rollup: pod health, disk headroom,
        predict-dispatcher liveness, lifecycle state, the alert summary,
        the front end's workers and (with peers) replication — 200 when
        every check passes and no critical alert fires, 503 (with this
        same JSON detail) otherwise. A DRAINING server reports ``state:
        draining`` and is unhealthy by design: load balancers must stop
        routing to a process about to exit, while the in-flight work it
        still owes completes behind the gate."""
        mdoc = self._metrics_doc()
        disk = (mdoc.get("resources") or {}).get("disk") or {}
        watermark = int(self.cfg.disk_free_watermark_mb) * (1 << 20)
        free = disk.get("free_bytes")
        disk_ok = (watermark <= 0 or free is None or free >= watermark)
        firing = self.alerts.firing()
        critical = self.alerts.firing(severity="critical")
        draining = self._draining.is_set()
        pod_error = (mdoc.get("pod") or {}).get("error")
        checks = {
            "pod": {"ok": pod_error is None, "error": pod_error},
            "disk": {"ok": disk_ok, "free_bytes": free,
                     "watermark_bytes": watermark},
            "dispatchers": self.predictor.health(),
            "lifecycle": {"ok": not draining,
                          "state": "draining" if draining else "serving"},
            "alerts": {"ok": not critical, "firing": firing,
                       "critical": critical},
        }
        if self._frontend is not None:
            # At least one accept process must be alive for the port to
            # answer at all; a respawn window (some dead, some alive)
            # degrades capacity, not health — the kernel routes around
            # dead listeners and the supervisor is already respawning.
            fr = mdoc.get("frontend") or {}
            checks["frontend"] = {
                "ok": (fr.get("workers_alive") or 0) > 0,
                "workers": fr.get("workers"),
                "workers_alive": fr.get("workers_alive"),
                "slots_abandoned": fr.get("slots_abandoned"),
            }
        rep = mdoc.get("replication") or {}
        if rep.get("enabled"):
            # Peer topology only (check absent otherwise, so single-host
            # deployments keep their healthz schema): a host that cannot
            # replicate committed data is a durability incident.
            under = rep.get("under_replicated") or []
            checks["replication"] = {
                "ok": not under,
                "peers": rep.get("peers"),
                "max_lag_bytes": rep.get("max_lag_bytes"),
                "under_replicated": under,
            }
        return {"healthy": all(c["ok"] for c in checks.values()),
                "state": "draining" if draining else "serving",
                "checks": checks,
                "mesh_epoch": spmd.mesh_epoch(),
                # The freshest evidence bundle, if any: a degraded
                # verdict points at its black box (the client SDK
                # quotes this id in the error it raises).
                "flightrec_latest": self.flightrec.latest()}

    def _register_images(self, method: str) -> None:
        app = self
        svc = self.images[method]

        @self._route("POST", f"/{method}/images/{{parent}}")
        def create_image(req, method=method, svc=svc):
            spmd.require_pod_health()
            name = req.body.get("image_name") or req.body.get(
                f"{method}_filename")
            if not name:
                raise ValueError("missing image_name")
            label = req.body.get("label_name")
            svc.validate_new(name)
            if not app.store.exists(req.params["parent"]):
                raise DatasetNotFound(req.params["parent"])
            parent = req.params["parent"]
            # Validate label synchronously like the reference (tsne.py:154-186)
            if label is not None and label not in app.store.get(
                    parent).metadata.fields:
                raise ValueError(f"label field not in dataset: {label}")
            marker = f"img.{method}.{name}"
            # A finished marker whose PNG is gone (deleted, or the job
            # failed) is stale — clear it so the name is reusable. An
            # unfinished marker means a build is in flight: 409.
            if app.store.exists(marker):
                if not app.store.get(marker).metadata.finished:
                    raise DatasetExists(
                        f"{method} image {name} build in progress")
                app.store.delete(marker)
            app.store.create(marker, parent=parent)
            kwargs = {k: req.body[k] for k in
                      ("perplexity", "iters") if k in req.body}

            def run():
                create_embedding_image(app.store, app.runtime, method,
                                       parent, name, label=label,
                                       image_root=app.cfg.image_root,
                                       marker=marker, **kwargs)
                app.store.finish(marker)

            app.jobs.submit(f"{method}_image", marker, run)
            return 201, {"result": f"{method} image {name} started",
                         "poll": marker}

        @self._route("GET", f"/{method}/images")
        def list_images(_req, svc=svc):
            return 200, svc.list_names()

        @self._route("GET", f"/{method}/images/{{name}}")
        def get_image(req, svc=svc):
            return 200, FileResponse(svc.get_path(req.params["name"]))

        @self._route("DELETE", f"/{method}/images/{{name}}")
        def delete_image(req, method=method, svc=svc):
            svc.delete(req.params["name"])
            # Drop the poll-marker dataset too, so the name can be reused.
            marker = f"img.{method}.{req.params['name']}"
            if app.store.exists(marker):
                app.store.delete(marker)
            return 200, {"result": "deleted"}

    # -- automatic job retry -------------------------------------------------

    def _retry_runner(self, spec, names):
        """The re-run callable for one recorded job spec (owning the
        failed output datasets ``names``), or None for a kind this
        package cannot re-run (leave it failed)."""
        kind = spec.get("kind")
        if kind == "model_builder":
            # Re-fit only the classifiers whose outputs failed: ones that
            # finished before the process died keep their results
            # (re-running them would append duplicate prediction rows).
            pred = spec["pred_name"]
            classifiers = [c for c in spec["classifiers"]
                           if f"{pred}_{c}" in set(names)]
            return lambda: self.builder.build(
                spec["train"], spec["test"], pred,
                classifiers, spec["label"],
                steps=spec.get("steps") or (),
                hparams=spec.get("hparams") or {}, existing=True)
        if kind == "histogram":
            return lambda: create_histogram(
                self.store, spec["parent"], spec["name"], spec["fields"],
                existing=True, runtime=self.runtime)
        if kind == "projection":
            return lambda: create_projection(
                self.store, spec["parent"], spec["name"], spec["fields"],
                existing=True)
        if kind == "model_predict":
            return lambda: self.builder.predict(
                spec["model"], spec["dataset"], spec["out"], existing=True)
        if kind == "tune":
            # The re-run resumes from the sweep's rung-boundary fit
            # checkpoints (same config key), so a process death at rung k
            # costs rung k, not the whole population.
            return lambda: self.builder.tune(
                spec["train"], spec["out"], spec["classifier"],
                spec["configs"], spec["label"],
                steps=spec.get("steps") or (),
                folds=spec.get("folds"), rungs=spec.get("rungs"),
                promote=bool(spec.get("promote")), existing=True)
        return None

    def _rescan_failed_jobs(self) -> None:
        """Re-run jobs the previous incarnation lost to infrastructure.

        The watchdog fails a dispatched job's outputs with ``pod
        failure:`` when a worker dies; a process restart mid-job marks
        unfinished outputs ``interrupted:`` (catalog load_all). Both mean
        the JOB was sound but the pod wasn't — so after the supervisor
        restarts the pod, re-run each such job from the spec recorded in
        its outputs' metadata, up to ``Settings.job_retries`` attempts
        per output (tracked in its ``retries`` counter). Outputs are
        reset via ``DatasetStore.reopen`` first, so pollers see them go
        back in flight and a partial write never duplicates rows.
        """
        if self.cfg.job_retries <= 0:
            return
        groups = select_retry_groups(self.store.metadata_docs(),
                                     self.cfg.job_retries)
        for group in groups:
            spec, names = group["spec"], group["datasets"]
            runner = self._retry_runner(spec, names)
            if runner is None:
                log.warning("not retrying %s: unknown job kind %r",
                            names, spec.get("kind"))
                continue
            for name in names:
                self.store.reopen(name)
            log.info("retrying %s job for %s (process recovered)",
                     spec["kind"], names)
            self.jobs.submit(f"retry_{spec['kind']}", names, runner)

    # -- lifecycle -----------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def begin_drain(self) -> None:
        """Flip the app into the draining state: new work (POST/PATCH/
        DELETE) answers 503 + Retry-After + ``Connection: close``,
        reads and already-accepted work continue, ``/healthz`` reports
        ``draining`` (→ 503, so load balancers depool this process).
        Idempotent."""
        if not self._draining.is_set():
            self._draining.set()
            log.warning("draining: new work rejected 503; waiting for "
                        "in-flight predicts and queued jobs")

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Gate off new work, then wait (up to ``timeout_s``, default
        ``LO_TPU_DRAIN_TIMEOUT_S``) for every accepted predict to
        scatter back and every queued job to reach a terminal state —
        job completion implies its journal fsyncs committed, so nothing
        durable is in flight when this returns. Then stop the predict
        dispatchers. Returns True when fully quiesced within the
        window, False when the timeout expired with work still running
        (the caller exits anyway — bounded beats perfect on the way
        down)."""
        self.begin_drain()
        deadline = time.monotonic() + float(
            self.cfg.drain_timeout_s if timeout_s is None else timeout_s)
        quiesced = False
        while time.monotonic() < deadline:
            if self.predictor.quiesced() and self.jobs.running_count() == 0:
                quiesced = True
                break
            time.sleep(0.05)
        if quiesced:
            log.info("drain complete: all accepted work finished")
        else:
            log.error("drain timeout: exiting with work still in flight "
                      "(predict queues quiesced=%s, running jobs=%d)",
                      self.predictor.quiesced(), self.jobs.running_count())
        self.predictor.stop()
        return quiesced

    def serve(self, background: bool = False):
        if int(self.cfg.http_workers) > 1:
            # Multi-worker front end: N SO_REUSEPORT accept processes own
            # the HTTP sockets, THIS process owns the device and every
            # serving semantic, and the two meet on the row channel
            # (serving/frontend.py). Same start/stop/port surface as the
            # threaded Server, so callers cannot tell the topologies
            # apart.
            from learningorchestra_tpu_torch.serving.frontend import (
                FrontendServer)

            server = FrontendServer(self, self.cfg.host, self.cfg.port)
            self._frontend = server
        else:
            # http_workers 1: the single-process topology — the oracle
            # the multi-worker path is tested against.
            server = Server(self.router, self.cfg.host, self.cfg.port,
                            request_timeout_s=self.cfg.http_timeout_s)
            self._frontend = None
        # Stopping the server stops the predict dispatcher threads too
        # (queued requests fail fast instead of waiting out their
        # timeout against a dead worker).
        server.on_stop(self.predictor.stop)
        # The push committer (if peers are configured) dies with the
        # server so a drain never strands a half-pushed journal suffix
        # silently — the watermark keeps it resumable on restart.
        server.on_stop(self.store.stop_replication)
        if int(self.cfg.replica_port) > 0:
            # This host's receive side of the replication plane: peers
            # push journal prefixes here and fetch chunks back out for
            # remote repair. Writes land under replica_root (or
            # <store_root>/_replicas), the same layout the local-mirror
            # restore path already reads; fetches also consult the
            # primary store_root so peers can heal from datasets this
            # host natively owns.
            from learningorchestra_tpu_torch.catalog import replicate

            self._replica_server = replicate.ReplicaServer(
                root=(self.cfg.replica_root
                      or os.path.join(self.cfg.store_root, "_replicas")),
                host=self.cfg.host, port=int(self.cfg.replica_port),
                extra_roots=(self.cfg.store_root,),
                timeout_s=self.cfg.replica_timeout_s)
            server.on_stop(self._replica_server.stop)
        # The telemetry sampler lives exactly as long as the server:
        # started here (bare App construction spawns no threads — tests
        # drive history via reads), stopped with it — and the stop
        # flushes the partial segment so a restarted process serves the
        # pre-shutdown window from disk.
        self.history.start()
        server.on_stop(self.history.stop)
        if background:
            return server.start_background()
        server.serve_forever()
        return server
