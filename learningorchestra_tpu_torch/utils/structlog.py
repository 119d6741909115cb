"""Structured logging — every line stamped with its trace/span ids.

The third leg of the observability plane (docs/observability.md): traces
answer "where did this request spend its time", metrics answer "how is
the fleet doing", and logs carry the narrative — but only if the three
cross-reference. This module makes every log line emitted inside a
traced operation carry that operation's ``trace_id``/``span_id``, so
``grep <trace_id> server.log`` reconstructs a request's story and a log
line's trace is one ``GET /trace/{id}`` away.

Usage: package modules take ``log = structlog.get_logger("spmd")``
(a stdlib logger under the ``lo_tpu`` tree — all the stdlib machinery,
levels, and test caplog integration keep working); entry points call
:func:`configure` once, which installs a single stream handler whose
format follows ``LO_TPU_LOG_FORMAT``:

- ``text`` (default): classic one-liner with `` trace=<id> span=<id>``
  appended when ambient;
- ``json``: one JSON doc per line — ``ts``, ``level``, ``logger``,
  ``msg``, ``trace_id``/``span_id``, ``process``, and ``exc`` on
  exception records — the machine-parseable form log shippers want.

A record may carry fields of its own: ``log.info(msg, extra=
structlog.fields(rank=1, code=0))`` puts them in the JSON doc as keys,
and after the text line as `` key=value`` pairs.

lolint's ``log-discipline`` rule (docs/static_analysis.md) bans bare
``print(`` and root-logger ``logging.*`` calls in package code so
nothing bypasses this funnel.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import IO, Optional

from learningorchestra_tpu_torch.config import Settings, settings as global_settings
from learningorchestra_tpu_torch.utils import tracing

#: Root of the framework's logger tree; every get_logger() name nests
#: under it so one handler + level governs the whole package.
ROOT = "lo_tpu"


def fields(**values) -> dict:
    """The ``extra`` of a log call whose record carries ``values`` as
    fields of its own (see the module docstring)."""
    return {"fields": values}


def get_logger(name: str) -> logging.Logger:
    """The framework logger for one component: ``get_logger("spmd")`` →
    ``lo_tpu.spmd``. Idempotent with stdlib semantics (same object per
    name)."""
    if name == ROOT or name.startswith(ROOT + "."):
        return logging.getLogger(name)
    return logging.getLogger(f"{ROOT}.{name}")


class JsonFormatter(logging.Formatter):
    """One JSON doc per line; trace ids from the ambient tracing context
    at EMIT time (the log site needs no plumbing)."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        ctx = tracing.current()
        if ctx is not None:
            doc["trace_id"] = ctx.trace_id
            doc["span_id"] = ctx.span_id
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        doc.update(getattr(record, "fields", None) or {})
        return json.dumps(doc, default=str)


class TextFormatter(logging.Formatter):
    """Human-readable one-liner, trace ids appended when ambient so an
    operator can paste the id straight into ``GET /trace/{id}``."""

    def __init__(self):
        super().__init__("%(asctime)s %(name)s %(levelname)s %(message)s")
        self.converter = time.localtime

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        for key, value in (getattr(record, "fields", None) or {}).items():
            line += f" {key}={value}"
        ctx = tracing.current()
        if ctx is not None:
            line += f" trace={ctx.trace_id} span={ctx.span_id}"
        return line


def configure(cfg: Optional[Settings] = None,
              stream: Optional[IO[str]] = None) -> logging.Logger:
    """Install the ``lo_tpu`` tree's single handler per
    ``LO_TPU_LOG_FORMAT`` / ``LO_TPU_LOG_LEVEL``. Idempotent: re-calls
    replace the handler (tests reconfigure against a StringIO), never
    stack duplicates. Returns the tree root logger."""
    cfg = cfg or global_settings
    root = logging.getLogger(ROOT)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None
                                    else sys.stderr)
    handler.setFormatter(JsonFormatter()
                         if str(cfg.log_format).lower() == "json"
                         else TextFormatter())
    root.addHandler(handler)
    level = getattr(logging, str(cfg.log_level).upper(), None)
    root.setLevel(level if isinstance(level, int) else logging.INFO)
    #: One funnel: the tree must not double-emit through the stdlib root
    #: logger's handlers (pytest installs its own there).
    root.propagate = False
    return root
