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
``"cuda"`` unless the caller passes ``"cpu"``). Not ported yet, and so
not routed: ``/tune``; ``/cluster`` and ``/replication`` (multi-device
and pod planes); ``/status``, ``/metrics/history``, ``/alerts``,
``/resources``, ``/debug/flightrec`` and ``/debug/profile`` (the
observability planes), nor the sections of ``/metrics`` and ``/healthz``
those planes feed; the multi-process front end (``http_workers > 1``);
the replication receive server (``replica_port``).
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Optional

from learningorchestra_tpu_torch.catalog.dataset import ChunkCorrupt
from learningorchestra_tpu_torch.catalog.ingest import ingest_csv_url
from learningorchestra_tpu_torch.catalog.store import (
    DatasetExists, DatasetNotFound, DatasetStore)
from learningorchestra_tpu_torch.config import (
    Settings, settings as global_settings)
from learningorchestra_tpu_torch.jobs import JobManager, select_retry_groups
from learningorchestra_tpu_torch.models.builder import ModelBuilder
from learningorchestra_tpu_torch.models.registry import validate_hparams
from learningorchestra_tpu_torch.ops.dtypes import convert_fields
from learningorchestra_tpu_torch.ops.histogram import create_histogram
from learningorchestra_tpu_torch.ops.projection import create_projection
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.serving.batcher import (
    BatcherStopped, DeadlineExceeded, DispatcherCrashed, ModelQuarantined,
    PredictBatcher, PredictTimeout, QueueFull)
from learningorchestra_tpu_torch.serving.http import (
    FileResponse, HttpError, IdempotencyCache, Router, Server)
from learningorchestra_tpu_torch.utils import tracing
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
        #: POST replay cache: a create retried with the same
        #: Idempotency-Key (the client SDK sends one per logical create)
        #: returns the first attempt's outcome instead of a spurious 409.
        self.idempotency = IdempotencyCache()
        #: Graceful-drain latch (SIGTERM / App.drain): once set, new
        #: work answers 503 + Retry-After + Connection: close while
        #: in-flight predicts and queued jobs run to completion —
        #: a planned restart loses zero accepted requests.
        self._draining = threading.Event()
        self.router = Router()
        self._register()
        if recover and self.cfg.persist:
            # Jobs killed by infrastructure (a process restart mid-job)
            # re-run automatically from their recorded specs — the Spark
            # lost-task re-execution analogue. Must run after _register:
            # the retry runners reuse the same builder / op entry points
            # the routes do.
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
        mapping of the handler stack (``_wrap``). Returns None for
        exceptions the serving layer does not own (the caller re-raises
        → 500 boundary)."""
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
                                         existing=True))
            return 201, {"result": f"histogram {name} created"}

        # ---- data_type_handler (reference data_type_handler server.py:46-76)
        @self._route("PATCH", "/fieldtypes/{name}")
        def fieldtypes(req):
            convert_fields(app.store, req.params["name"], req.body)
            return 200, {"result": "types converted"}

        # ---- model_builder (reference model_builder_image/server.py:52-115)
        @self._route("POST", "/models")
        def models(req):
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

        @self._route("GET", "/metrics")
        def metrics(_req):
            return 200, app._metrics_doc()

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

        @self._route("GET", "/healthz")
        def healthz(_req):
            doc = app._health_doc()
            return (200 if doc["healthy"] else 503), doc

    def _metrics_doc(self) -> dict:
        """The metrics registry snapshot ``GET /metrics`` serves: the JAX
        package's sections for the planes this package has — serving
        (with the ``aot`` cache), jobs and the catalog (integrity, read
        pipeline, ingest, shard, replication) — plus ops, tracing and
        the latency attribution."""
        from learningorchestra_tpu_torch import jobs as jobs_module
        from learningorchestra_tpu_torch.catalog import ingest as ingest_module
        from learningorchestra_tpu_torch.catalog import readpipe
        from learningorchestra_tpu_torch.utils import fitckpt
        from learningorchestra_tpu_torch.utils.profiling import op_timer

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
               "profile_dir": self.cfg.profile_dir or None,
               # Cross-host replication plane: per-dataset lag against
               # each peer's acked watermark, push/fetch/repair
               # counters, the under-replicated list. Snapshotting
               # doubles as the read-driven retry tick.
               "replication": self.store.replication_snapshot()}
        return doc

    def _health_doc(self) -> dict:
        """The ``GET /healthz`` rollup: predict-dispatcher liveness,
        lifecycle state and (with peers) replication — 200 when every
        check passes, 503 (with this same JSON detail) otherwise. A
        DRAINING server reports ``state: draining`` and is unhealthy by
        design: load balancers must stop routing to a process about to
        exit, while the in-flight work it still owes completes behind
        the gate."""
        draining = self._draining.is_set()
        checks = {
            "dispatchers": self.predictor.health(),
            "lifecycle": {"ok": not draining,
                          "state": "draining" if draining else "serving"},
        }
        rep = self.store.replication_snapshot()
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
                "checks": checks}

    def _register_images(self, method: str) -> None:
        app = self
        svc = self.images[method]

        @self._route("POST", f"/{method}/images/{{parent}}")
        def create_image(req, method=method, svc=svc):
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
                existing=True)
        if kind == "projection":
            return lambda: create_projection(
                self.store, spec["parent"], spec["name"], spec["fields"],
                existing=True)
        if kind == "model_predict":
            return lambda: self.builder.predict(
                spec["model"], spec["dataset"], spec["out"], existing=True)
        return None

    def _rescan_failed_jobs(self) -> None:
        """Re-run jobs the previous incarnation lost to infrastructure.

        A process restart mid-job marks unfinished outputs
        ``interrupted:`` (catalog load_all): the JOB was sound but the
        process wasn't — so re-run each such job from the spec recorded
        in its outputs' metadata, up to ``Settings.job_retries`` attempts
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
            raise NotImplementedError(
                "http_workers > 1 needs the multi-process front end "
                "(serving/frontend.py), which is not ported to the PyTorch "
                "package yet (ROADMAP.md A.1); run with LO_TPU_HTTP_WORKERS=1")
        server = Server(self.router, self.cfg.host, self.cfg.port,
                        request_timeout_s=self.cfg.http_timeout_s)
        # Stopping the server stops the predict dispatcher threads too
        # (queued requests fail fast instead of waiting out their
        # timeout against a dead worker).
        server.on_stop(self.predictor.stop)
        # The push committer (if peers are configured) dies with the
        # server so a drain never strands a half-pushed journal suffix
        # silently — the watermark keeps it resumable on restart.
        server.on_stop(self.store.stop_replication)
        if background:
            return server.start_background()
        server.serve_forever()
        return server
