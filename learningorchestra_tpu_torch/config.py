"""Typed configuration for the framework.

The reference configures everything through env vars scattered across
Dockerfiles and docker-compose service blocks with no validation layer
(reference docker-compose.yml:23-25,188-192; model_builder_image/Dockerfile:8-13).
Here a single dataclass holds every knob, reads the environment once, and is
importable everywhere — the "typed pydantic-style settings" upgrade called for
in SURVEY.md §7 without taking a pydantic dependency.

Only the knobs that this package reads are here. A subsystem that is not
ported yet brings its knobs along when it is; the two knobs of unported
paths kept below (``stream_design``, ``fit_ckpt_rounds``) are refused by
the model builder with a "not yet ported" error instead of being ignored.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


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
    #: Force the streamed design-matrix path for every build. That path
    #: is not ported: the builder refuses a build with this set, or with
    #: a dataset over its RAM budget.
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

    # --- training ----------------------------------------------------------
    #: Max concurrently running model fits (reference: 5 classifiers through
    #: a ThreadPoolExecutor + Spark FAIR pool, model_builder.py:95,160-176).
    max_concurrent_fits: int = field(
        default_factory=lambda: _env("LO_TPU_MAX_CONCURRENT_FITS", 5)
    )
    #: Save fitted models (npz + manifest) into store_root/_models so they can
    #: be listed and re-used for prediction. The reference discards models
    #: after use (model_builder.py:227-248) — this is the §5 upgrade.
    persist_models: bool = field(
        default_factory=lambda: _env("LO_TPU_PERSIST_MODELS", True, bool)
    )
    #: Mid-fit checkpoint cadence. Fit checkpoints are not ported: ``0``
    #: (the default) is the only value the builder accepts.
    fit_ckpt_rounds: int = field(
        default_factory=lambda: _env("LO_TPU_FIT_CKPT_ROUNDS", 0)
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


#: Process-global settings instance. Tests construct their own.
settings = Settings()


def failpoint_spec() -> str:
    """The deterministic fault-injection arming spec
    (``LO_TPU_FAILPOINTS=site=mode[:nth],...``), read at
    utils/failpoints.py import — before any Settings exists."""
    return os.environ.get("LO_TPU_FAILPOINTS", "")
