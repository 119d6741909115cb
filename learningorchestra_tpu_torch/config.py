"""Typed configuration for the framework.

The reference configures everything through env vars scattered across
Dockerfiles and docker-compose service blocks with no validation layer
(reference docker-compose.yml:23-25,188-192; model_builder_image/Dockerfile:8-13).
Here a single dataclass holds every knob, reads the environment once, and is
importable everywhere — the "typed pydantic-style settings" upgrade called for
in SURVEY.md §7 without taking a pydantic dependency.

Only the knobs that this package reads are here. A subsystem that is not
ported yet brings its knobs along when it is.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from typing import Optional


def _env(name: str, default, cast=None):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is None:
        cast = type(default) if default is not None else str
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclass
class Settings:
    """All framework knobs, env-overridable with the ``LO_TPU_`` prefix."""

    # --- storage -----------------------------------------------------------
    #: On-disk root for persisted datasets (parquet + metadata.json). The
    #: catalog always keeps hot data in host RAM; this is the durability tier
    #: replacing the reference's MongoDB volumes (docker-compose.yml:335-340).
    store_root: str = field(
        default_factory=lambda: _env("LO_TPU_STORE_ROOT", "/tmp/lo_tpu_store")
    )
    #: Persist datasets to disk on every commit (finished-flip).
    persist: bool = field(default_factory=lambda: _env("LO_TPU_PERSIST", True, bool))
    #: Soft cap (MiB) on column data resident in host RAM *per dataset*;
    #: 0 = unlimited. Over budget, chunks flush to immutable parquet chunk
    #: files and are evicted — the out-of-core tier replacing the
    #: reference's disk-backed Mongo collections (database.py:133-216).
    ram_budget_mb: int = field(
        default_factory=lambda: _env("LO_TPU_RAM_BUDGET_MB", 0)
    )
    #: Force the streamed design-matrix path for every build
    #: (ops/preprocess.design_matrix_streamed + the runtime's
    #: double-buffered device feed). Datasets over their RAM budget take
    #: that path regardless; this flag makes it the default even for
    #: small ones.
    stream_design: bool = field(
        default_factory=lambda: _env("LO_TPU_STREAM_DESIGN", False, bool)
    )
    #: Optional second directory mirroring every committed dataset (chunk
    #: files + journal + metadata). Standing in for the reference's Mongo
    #: primary/secondary replica set (docker-compose.yml:27-91): if the
    #: primary store_root is lost, load_all() restores from the replica.
    replica_root: str = field(
        default_factory=lambda: _env("LO_TPU_REPLICA_ROOT", "")
    )
    #: Comma-separated ``host:port`` list of peer replica servers
    #: (catalog/replicate.py). Each committed journal prefix is pushed to
    #: every peer by an async single-slot committer; `_repair_chunk` adds
    #: a CRC-verified remote fetch rung so reads heal whole-host loss
    #: through the same ChunkCorrupt path as local bit-rot. Empty (the
    #: default) keeps replica_root-only behavior byte-for-byte unchanged.
    replica_peers: str = field(
        default_factory=lambda: _env("LO_TPU_REPLICA_PEERS", "")
    )
    #: Port for this host's ReplicaServer (the receive side of the
    #: replication plane). 0 (default) does not start one — set it on
    #: every host that should hold peers' replicas. Bound on
    #: LO_TPU_HOST.
    replica_port: int = field(
        default_factory=lambda: _env("LO_TPU_REPLICA_PORT", 0)
    )
    #: Socket timeout, seconds, for every replication frame exchange
    #: (push, fetch, probe). A dead peer costs at most this long per
    #: attempt before the push is recorded as failed and the dataset
    #: counted under-replicated.
    replica_timeout_s: float = field(
        default_factory=lambda: _env("LO_TPU_REPLICA_TIMEOUT_S", 10.0)
    )
    #: Minimum seconds between re-push attempts for an under-replicated
    #: dataset. Failed pushes leave the dataset on the push queue's
    #: retry list; each /metrics scrape (or replication_snapshot call)
    #: re-queues datasets whose last attempt is older than this.
    replica_push_retry_s: float = field(
        default_factory=lambda: _env("LO_TPU_REPLICA_PUSH_RETRY_S", 2.0)
    )
    #: Chunks read ahead of the consumer by the prefetching read pipeline
    #: (catalog/readpipe.py): while a streaming consumer (iter_chunks /
    #: snapshot scans) computes on chunk i, a background worker pool
    #: reads + CRC-verifies + decodes chunks i+1..i+K. 0 disables
    #: prefetch entirely — the strictly synchronous read path is kept as
    #: the parity oracle (docs/performance.md).
    prefetch_chunks: int = field(
        default_factory=lambda: _env("LO_TPU_PREFETCH_CHUNKS", 2)
    )
    #: Byte budget for the host-RAM LRU chunk cache shared across
    #: passes/datasets: decoded chunk reads are kept keyed by
    #: (chunk file, journal CRC, field selection) so the second scan of a
    #: streamed-fit pipeline and repeated histogram/projection calls hit
    #: warm memory instead of re-reading disk. 0 disables caching.
    chunk_cache_bytes: int = field(
        default_factory=lambda: _env("LO_TPU_CHUNK_CACHE_BYTES", 256 << 20)
    )
    #: Run a full checksum scrub (DatasetStore.scrub) as part of
    #: load_all's recovery scan: every journaled chunk file is re-read
    #: and verified against its journal CRC32, repairing from the
    #: replica on mismatch. Off by default — it reads every chunk at
    #: startup; the lazy first-read verification covers the default
    #: path, and POST /catalog/scrub runs the same pass on demand.
    scrub_on_load: bool = field(
        default_factory=lambda: _env("LO_TPU_SCRUB_ON_LOAD", False, bool)
    )
    #: Commit (journal-fsync + metadata write) cadence, in bytes of
    #: appended chunk data, for ops that stream a dataset into a new one
    #: (ops/projection.py); 0 = commit every chunk (max durability).
    ingest_commit_bytes: int = field(
        default_factory=lambda: _env("LO_TPU_INGEST_COMMIT_BYTES", 64 << 20)
    )
    #: Directory where viz services write PNGs (reference volumes
    #: tsne:/images, pca:/images, docker-compose.yml:289-290).
    image_root: str = field(
        default_factory=lambda: _env("LO_TPU_IMAGE_ROOT", "/tmp/lo_tpu_images")
    )

    # --- ingestion (catalog/ingest.py) --------------------------------------
    #: CSV ingest chunk size (rows) for the streaming loader.
    ingest_chunk_rows: int = field(
        default_factory=lambda: _env("LO_TPU_INGEST_CHUNK_ROWS", 262144)
    )
    #: HTTP timeout for CSV downloads, seconds.
    download_timeout: float = field(
        default_factory=lambda: _env("LO_TPU_DOWNLOAD_TIMEOUT", 60.0)
    )
    #: Use the native C++ CSV parser (``native/``) when its shared library
    #: is built; pandas parses otherwise.
    use_native_csv: bool = field(
        default_factory=lambda: _env("LO_TPU_USE_NATIVE_CSV", True, bool)
    )
    #: Parser threads for streaming ingest. 0 = automatic: os.cpu_count()
    #: clamped to [4, 8].
    ingest_parse_threads: int = field(
        default_factory=lambda: _env("LO_TPU_INGEST_PARSE_THREADS", 0)
    )
    #: Range-partitioned ingest: split a sized source into this many
    #: partitions fetched and parsed concurrently. 0 or 1 = one stream.
    ingest_partitions: int = field(
        default_factory=lambda: _env("LO_TPU_INGEST_PARTITIONS", 0)
    )
    #: Sources smaller than twice this never split.
    ingest_partition_min_bytes: int = field(
        default_factory=lambda: _env("LO_TPU_INGEST_PARTITION_MIN_BYTES",
                                     4 << 20)
    )

    # --- mesh / parallelism (parallel/mesh.py) -------------------------------
    #: Optional forced mesh shape "D,M" or "D,M,S" (data × model × seq)
    #: over the ranks of the process group; empty = every rank on the
    #: data axis.
    mesh_shape: str = field(default_factory=lambda: _env("LO_TPU_MESH_SHAPE", ""))

    # --- serving (serving/app.py, serving/http.py) ---------------------------
    #: The one service port; the reference's seven Flask ports become
    #: path prefixes of this server.
    port: int = field(default_factory=lambda: _env("LO_TPU_PORT", 5000))
    host: str = field(default_factory=lambda: _env("LO_TPU_HOST", "127.0.0.1"))
    #: Page-size cap for dataset reads; the reference hard-caps at 20
    #: (database_api_image/server.py:28,69-70).
    read_limit_cap: int = field(default_factory=lambda: _env("LO_TPU_READ_CAP", 20))
    #: Per-connection socket timeout (seconds) on the HTTP server, so a
    #: client that never delivers its body cannot pin a handler thread.
    #: 0 disables.
    http_timeout_s: float = field(
        default_factory=lambda: _env("LO_TPU_HTTP_TIMEOUT_S", 30.0)
    )
    #: HTTP accept processes. ``1`` (the default): the device-owning
    #: process serves HTTP itself through the threaded stdlib server.
    #: ``N > 1`` binds N front-end worker processes to the same host:port
    #: via ``SO_REUSEPORT``; each decodes requests in its own interpreter
    #: and forwards predict rows and proxied requests to the
    #: device-owning process over the row channel (serving/frontend.py).
    http_workers: int = field(
        default_factory=lambda: _env("LO_TPU_HTTP_WORKERS", 1)
    )
    #: Handler threads the device-owning process runs for row-channel
    #: frames from front-end workers: how many forwarded requests execute
    #: at once inside it. Only read when ``http_workers > 1``.
    frontend_channel_threads: int = field(
        default_factory=lambda: _env("LO_TPU_FRONTEND_CHANNEL_THREADS", 16)
    )

    # --- online inference (serving/batcher.py, models/aot.py) --------------
    #: Largest coalesced micro-batch (rows) per device dispatch, and the
    #: top of the padding-bucket ladder (1/8/64/…/max). Requests carrying
    #: more rows are rejected 406; the client SDK splits client-side.
    serve_max_batch: int = field(
        default_factory=lambda: _env("LO_TPU_SERVE_MAX_BATCH", 256)
    )
    #: Bound (rows) on each model's predict queue; a request that would
    #: overflow it answers 503 + Retry-After. 0 disables the online tier.
    serve_queue_depth: int = field(
        default_factory=lambda: _env("LO_TPU_SERVE_QUEUE_DEPTH", 1024)
    )
    #: Optional coalescing linger (milliseconds) before dispatching a
    #: batch that is not full. 0 = dispatch at once: the queue refills
    #: while the device runs the previous batch.
    serve_max_wait_ms: float = field(
        default_factory=lambda: _env("LO_TPU_SERVE_MAX_WAIT_MS", 0.0)
    )
    #: How long a queued request may wait for its batch before 503.
    serve_timeout_s: float = field(
        default_factory=lambda: _env("LO_TPU_SERVE_TIMEOUT_S", 30.0)
    )
    #: Default deadline budget (milliseconds) of a predict request that
    #: carries no ``X-Deadline-Ms``; 0 = none. Expiry answers 504.
    serve_deadline_default_ms: float = field(
        default_factory=lambda: _env("LO_TPU_SERVE_DEADLINE_DEFAULT_MS", 0.0)
    )
    #: Upper clamp (milliseconds) on client deadline budgets; 0 disables
    #: deadline handling.
    serve_deadline_cap_ms: float = field(
        default_factory=lambda: _env("LO_TPU_SERVE_DEADLINE_CAP_MS",
                                     600000.0)
    )
    #: Device replicas of the online tier: 1 (the default) is one card;
    #: 0 means every visible CUDA device; N clamps to the device count.
    serve_replicas: int = field(
        default_factory=lambda: _env("LO_TPU_SERVE_REPLICAS", 1)
    )
    #: Consecutive dispatcher crashes before a model is quarantined
    #: (terminal 503 until DELETE or re-save).
    serve_quarantine_crashes: int = field(
        default_factory=lambda: _env("LO_TPU_SERVE_QUARANTINE_CRASHES", 3)
    )
    #: First restart backoff (seconds) after a dispatcher crash; doubles
    #: per consecutive crash, capped at 5 s.
    serve_restart_backoff_s: float = field(
        default_factory=lambda: _env("LO_TPU_SERVE_RESTART_BACKOFF_S", 0.2)
    )
    #: Restarts the pod supervisor (supervisor.py) attempts before it
    #: declares the pod failed, and of a front-end worker slot
    #: (serving/frontend.py ``WorkerSupervisor``) before the slot is
    #: abandoned; each slot has its own budget.
    restart_budget: int = field(
        default_factory=lambda: _env("LO_TPU_RESTART_BUDGET", 5)
    )
    #: First pod or worker restart delay (seconds); doubles per restart
    #: up to ``restart_backoff_max_s``.
    restart_backoff_s: float = field(
        default_factory=lambda: _env("LO_TPU_RESTART_BACKOFF_S", 1.0)
    )
    #: Cap on the worker restart delay, and the Retry-After (seconds) of
    #: a quarantined model's 503.
    restart_backoff_max_s: float = field(
        default_factory=lambda: _env("LO_TPU_RESTART_BACKOFF_MAX_S", 30.0)
    )
    #: After this many seconds of continuous health the pod supervisor
    #: and the worker supervisor restore their restart budgets. 0
    #: disables it.
    restart_healthy_s: float = field(
        default_factory=lambda: _env("LO_TPU_RESTART_HEALTHY_S", 300.0)
    )
    #: Cadence of the pod supervisor's /cluster health poll, seconds
    #: (supervisor.py) — catches degradations where no supervised process
    #: died (a worker vanished and the watchdog poisoned the pod).
    health_interval_s: float = field(
        default_factory=lambda: _env("LO_TPU_HEALTH_INTERVAL_S", 2.0)
    )
    #: Graceful-drain window (seconds): on SIGTERM or ``App.drain`` the
    #: server answers new work 503 and lets accepted work finish for up
    #: to this long.
    drain_timeout_s: float = field(
        default_factory=lambda: _env("LO_TPU_DRAIN_TIMEOUT_S", 30.0)
    )

    # --- training ----------------------------------------------------------
    #: Max concurrently running model fits (reference: 5 classifiers through
    #: a ThreadPoolExecutor + Spark FAIR pool, model_builder.py:95,160-176).
    max_concurrent_fits: int = field(
        default_factory=lambda: _env("LO_TPU_MAX_CONCURRENT_FITS", 5)
    )
    #: Allow user-supplied preprocessing code via exec(). The reference does
    #: this unconditionally (model_builder.py:145-150); here it is opt-in and
    #: off by default — the declarative preprocessing API is the default path.
    allow_exec_preprocessing: bool = field(
        default_factory=lambda: _env("LO_TPU_ALLOW_EXEC", False, bool)
    )
    #: Resource jail for exec preprocessing (ops/exec_jail.py): wall-clock
    #: timeout, CPU seconds, and address-space cap for the child process.
    #: 0 disables the respective limit.
    exec_timeout_seconds: float = field(
        default_factory=lambda: _env("LO_TPU_EXEC_TIMEOUT_S", 300.0)
    )
    exec_cpu_seconds: int = field(
        default_factory=lambda: _env("LO_TPU_EXEC_CPU_S", 300)
    )
    exec_memory_mb: int = field(
        default_factory=lambda: _env("LO_TPU_EXEC_MEM_MB", 4096)
    )
    #: Save fitted models (npz + manifest) into store_root/_models so they can
    #: be listed and re-used for prediction. The reference discards models
    #: after use (model_builder.py:227-248) — this is the §5 upgrade.
    persist_models: bool = field(
        default_factory=lambda: _env("LO_TPU_PERSIST_MODELS", True, bool)
    )
    #: Mid-fit checkpoint cadence (utils/fitckpt.py): persist per-family
    #: fit progress every N natural units (gb boost rounds; rf checkpoints
    #: at its tree-batch boundaries; the streamed design state at its
    #: fitting-pass boundaries) so an interrupted build resumes instead of
    #: restarting. 0 (default) disables checkpointing.
    fit_ckpt_rounds: int = field(
        default_factory=lambda: _env("LO_TPU_FIT_CKPT_ROUNDS", 0)
    )
    #: Successive-halving rungs for a hyperparameter sweep (models/
    #: tune.py): the sweep's total unit budget (boost rounds / adam
    #: iterations / tree batches) is cut into this many segments; after
    #: each, every candidate's k-fold scores are taken and the bottom
    #: half of the surviving configs is dropped (the survivors'
    #: arithmetic is untouched). ``1`` disables halving.
    tune_rungs: int = field(
        default_factory=lambda: _env("LO_TPU_TUNE_RUNGS", 3)
    )
    #: Cross-validation folds for tune sweeps: fold membership is an
    #: index mask over the one resident design matrix (row i belongs to
    #: fold ``i % folds``), never a data copy. ``1`` disables CV — each
    #: candidate trains on all rows and is scored on them too.
    tune_folds: int = field(
        default_factory=lambda: _env("LO_TPU_TUNE_FOLDS", 3)
    )
    #: Device-memory budget (MB) for sizing a tune population wave: the
    #: largest candidate count whose modeled per-member footprint (raised
    #: to the family's recorded ``peak_hbm_bytes`` watermark when one
    #: exists) fits runs as one wave; extra candidates spill into
    #: sequential waves (counted on ``/metrics``). ``0`` = unlimited.
    tune_hbm_budget_mb: int = field(
        default_factory=lambda: _env("LO_TPU_TUNE_HBM_BUDGET_MB", 0)
    )
    #: Hard cap on population members (configs × folds) per wave.
    tune_max_population: int = field(
        default_factory=lambda: _env("LO_TPU_TUNE_MAX_POPULATION", 64)
    )

    # --- job-tier fault domain (jobs.py watchdog) ---------------------------
    #: Per-job liveness deadline (seconds): a managed job whose BODY has
    #: started and then makes no PROGRESS for this long — progress marks
    #: (``jobs.heartbeat``) fire at boost-round / tree-batch /
    #: fitting-pass / dispatch boundaries — is failed by the watchdog
    #: thread with the retryable ``interrupted: watchdog`` prefix. Marks
    #: land at PROGRAM boundaries (a running device program is opaque),
    #: so size this above the longest single fit program plus the kernel
    #: build. ``0`` (the default) disables the watchdog.
    job_deadline_s: float = field(
        default_factory=lambda: _env("LO_TPU_JOB_DEADLINE_S", 0.0)
    )

    #: Automatic re-runs per job whose outputs failed from
    #: infrastructure (``pod failure:`` / ``interrupted:`` marks): on
    #: start the server rescans the store and resubmits such jobs from
    #: their recorded specs. 0 disables retry.
    job_retries: int = field(
        default_factory=lambda: _env("LO_TPU_JOB_RETRIES", 1)
    )

    # --- observability -----------------------------------------------------
    #: When set, compute jobs run under a torch.profiler trace writing
    #: Chrome-trace files here (utils/profiling.device_trace).
    profile_dir: str = field(
        default_factory=lambda: _env("LO_TPU_PROFILE_DIR", "")
    )
    #: Capacity (spans) of the in-process trace ring buffer
    #: (utils/tracing.py). Old spans evict FIFO past this, so a long-lived
    #: server holds a bounded window of recent traces. 0 disables span
    #: retention entirely (trace ids still mint and propagate).
    trace_buffer_spans: int = field(
        default_factory=lambda: _env("LO_TPU_TRACE_BUFFER_SPANS", 4096)
    )
    #: Probability (0.0-1.0) that a new trace records spans. 1.0 traces
    #: every request/job; 0.0 disables recording (ids still propagate,
    #: which is what the bench's overhead A/B toggles).
    trace_sample: float = field(
        default_factory=lambda: _env("LO_TPU_TRACE_SAMPLE", 1.0)
    )
    #: Log line format for the structured logger (utils/structlog.py):
    #: "text" (human-readable, trace ids appended) or "json" (one JSON
    #: doc per line, trace/span ids as fields).
    log_format: str = field(
        default_factory=lambda: _env("LO_TPU_LOG_FORMAT", "text")
    )
    #: Log level for the framework's ``lo_tpu`` logger tree.
    log_level: str = field(
        default_factory=lambda: _env("LO_TPU_LOG_LEVEL", "INFO")
    )


    # --- telemetry history (utils/timeseries.py) ----------------------------
    #: Cadence (seconds) of the background telemetry sampler, which
    #: snapshots the server's ``/metrics`` document into the history ring.
    #: ``0`` disables the sampler thread and records one sample per
    #: registry read instead; negative disables history entirely.
    telemetry_sample_s: float = field(
        default_factory=lambda: _env("LO_TPU_TELEMETRY_SAMPLE_S", 5.0)
    )
    #: In-memory history ring capacity (samples).
    telemetry_ring_samples: int = field(
        default_factory=lambda: _env("LO_TPU_TELEMETRY_RING_SAMPLES", 720)
    )
    #: Samples per on-disk delta-encoded segment under
    #: ``<store_root>/_telemetry/``.
    telemetry_segment_samples: int = field(
        default_factory=lambda: _env("LO_TPU_TELEMETRY_SEGMENT_SAMPLES",
                                     120)
    )
    #: Newest on-disk segments kept; older ones are unlinked at rotation.
    telemetry_retention_segments: int = field(
        default_factory=lambda: _env(
            "LO_TPU_TELEMETRY_RETENTION_SEGMENTS", 48)
    )

    # --- flight recorder (utils/flightrec.py) -------------------------------
    #: Newest bundles kept under ``<store_root>/_flightrec/``; 0 disables
    #: the recorder.
    flightrec_keep: int = field(
        default_factory=lambda: _env("LO_TPU_FLIGHTREC_KEEP", 8)
    )
    #: Minimum seconds between automatic dumps (alert firing, healthz
    #: flip, quarantine, watchdog); ``POST /debug/flightrec`` ignores it.
    flightrec_min_interval_s: float = field(
        default_factory=lambda: _env("LO_TPU_FLIGHTREC_MIN_INTERVAL_S",
                                     30.0)
    )
    #: Seconds of telemetry history captured into each bundle.
    flightrec_window_s: float = field(
        default_factory=lambda: _env("LO_TPU_FLIGHTREC_WINDOW_S", 600.0)
    )

    # --- resource & capacity plane (utils/resources.py, utils/alerts.py) ---
    #: Evaluation-window length (seconds) of the alert engine; rules are
    #: checked at most once a window, driven by registry reads. 0
    #: evaluates on every read.
    alert_window_s: float = field(
        default_factory=lambda: _env("LO_TPU_ALERT_WINDOW_S", 15.0)
    )
    #: Consecutive bad windows before a threshold rule fires.
    alert_for_windows: int = field(
        default_factory=lambda: _env("LO_TPU_ALERT_FOR_WINDOWS", 2)
    )
    #: Consecutive clean windows before a firing alert resolves.
    alert_clear_windows: int = field(
        default_factory=lambda: _env("LO_TPU_ALERT_CLEAR_WINDOWS", 2)
    )
    #: Online-tier p99 SLO (milliseconds, worst model); 0 drops the rule.
    slo_p99_ms: float = field(
        default_factory=lambda: _env("LO_TPU_SLO_P99_MS", 500.0)
    )
    #: Queue-rejection-rate SLO (rejected / offered a window); 0 drops it.
    slo_reject_rate: float = field(
        default_factory=lambda: _env("LO_TPU_SLO_REJECT_RATE", 0.05)
    )
    #: Deadline-miss-rate SLO (expired / offered a window); 0 drops it.
    slo_deadline_rate: float = field(
        default_factory=lambda: _env("LO_TPU_SLO_DEADLINE_RATE", 0.05)
    )
    #: Fast burn-rate window (seconds) of the serving SLO rules over the
    #: telemetry history; 0 keeps single-window evaluation.
    slo_burn_fast_s: float = field(
        default_factory=lambda: _env("LO_TPU_SLO_BURN_FAST_S", 300.0)
    )
    #: Slow burn-rate window (seconds); 0 keeps single-window evaluation.
    slo_burn_slow_s: float = field(
        default_factory=lambda: _env("LO_TPU_SLO_BURN_SLOW_S", 3600.0)
    )
    #: Error budget: the fraction of a window that may be out of SLO
    #: before its burn rate reads 1.0.
    slo_burn_budget: float = field(
        default_factory=lambda: _env("LO_TPU_SLO_BURN_BUDGET", 0.02)
    )
    #: Free-disk watermark (MiB) of the chunk store's filesystem: under
    #: it ``disk_free_low`` fires and ``GET /healthz`` degrades. 0
    #: disables the check.
    disk_free_watermark_mb: int = field(
        default_factory=lambda: _env("LO_TPU_DISK_FREE_WATERMARK_MB", 512)
    )
    #: Allow ``POST /debug/profile`` to capture an on-demand
    #: ``torch.profiler`` trace (N seconds, Chrome trace under
    #: ``<store_root>/_profiles``). Off by default: an explicit opt-in.
    debug_profile: bool = field(
        default_factory=lambda: _env("LO_TPU_DEBUG_PROFILE", False, bool)
    )

    def replace(self, **kw) -> "Settings":
        new = Settings()
        for f in fields(self):
            setattr(new, f.name, kw.get(f.name, getattr(self, f.name)))
        return new


#: Process-global settings instance. Tests construct their own.
settings = Settings()


def restart_count() -> int:
    """This incarnation's supervisor restart ordinal
    (``LO_TPU_RESTART_COUNT``, set by supervisor.py for each supervised
    child; 0 = first launch). Served on ``/cluster`` as ``restarts``."""
    try:
        return int(os.environ.get("LO_TPU_RESTART_COUNT", "0") or 0)
    except ValueError:
        return 0


def mesh_epoch() -> int:
    """The pod's mesh generation (``LO_TPU_MESH_EPOCH``) — bumped by the
    supervisor on every restart so the SPMD job channel can reject
    workers from a previous incarnation (parallel/spmd.py); fit
    checkpoints record it too (utils/fitckpt.py). Read per call, never
    cached: the epoch-scoped pod poison follows the env."""
    try:
        return int(os.environ.get("LO_TPU_MESH_EPOCH", "0") or 0)
    except ValueError:
        return 0


def coordinator_address(default: Optional[str] = None) -> Optional[str]:
    """``host:port`` of process 0's rendezvous for the process group
    (``LO_TPU_COORDINATOR``, parallel/distributed.py). None/default =
    single-process."""
    return os.environ.get("LO_TPU_COORDINATOR") or default


def job_port(default: int) -> int:
    """Explicit SPMD job-channel port (``LO_TPU_JOB_PORT``); defaults to
    the coordinator port + 1 computed by the caller. A malformed value
    raises immediately: silently falling back would have coordinator and
    workers listening on different ports, surfacing as an opaque
    handshake timeout instead of a config error."""
    raw = os.environ.get("LO_TPU_JOB_PORT")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"LO_TPU_JOB_PORT must be an integer, got {raw!r}") from None


def num_processes() -> Optional[int]:
    """Process count of the process group (``LO_TPU_NUM_PROCESSES``);
    None = unset (single-process)."""
    raw = os.environ.get("LO_TPU_NUM_PROCESSES")
    return int(raw) if raw else None


def process_id() -> Optional[int]:
    """This process's rank in the process group (``LO_TPU_PROCESS_ID``);
    None = unset (single-process)."""
    raw = os.environ.get("LO_TPU_PROCESS_ID")
    return int(raw) if raw is not None and raw != "" else None


def failpoint_spec() -> str:
    """The deterministic fault-injection arming spec
    (``LO_TPU_FAILPOINTS=site=mode[:nth],...``), read at
    utils/failpoints.py import — before any Settings exists."""
    return os.environ.get("LO_TPU_FAILPOINTS", "")


def peak_flops() -> float:
    """Override for the card's peak FLOP/s used as the MFU denominator
    (``LO_TPU_PEAK_FLOPS``; models/flops.py defaults to the H100's
    float32 figure). 0.0 = unset."""
    try:
        return float(os.environ.get("LO_TPU_PEAK_FLOPS", "") or 0.0)
    except ValueError:
        return 0.0


def peak_bw() -> float:
    """Override for the card's peak memory bandwidth used as the
    ``bw_util`` denominator (``LO_TPU_PEAK_BW``). 0.0 = unset."""
    try:
        return float(os.environ.get("LO_TPU_PEAK_BW", "") or 0.0)
    except ValueError:
        return 0.0


def shard_host() -> Optional[int]:
    """Explicit placement identity of this host for shard-map planning
    (``LO_TPU_SHARD_HOST``): which ingest-partition owner's chunks count
    as host-local when the runtime's streamed feed classifies its rows.
    None = unset — pods use the process group's rank
    (parallel/spmd.local_host_id)."""
    raw = os.environ.get("LO_TPU_SHARD_HOST")
    return int(raw) if raw is not None and raw != "" else None
