"""Span attributes that per-layer readers sum (``Run.span_seconds`` sums
their durations)."""

from __future__ import annotations

import bisect
import statistics
from typing import Optional


def attr_total(run, name: str, key: str) -> Optional[float]:
    """The sum of attribute ``key`` over the window's spans called
    ``name``, or None when no such span carries it."""
    values = [sp["attrs"][key] for sp in run.spans
              if sp["name"] == name and key in (sp.get("attrs") or {})]
    return float(sum(values)) if values else None


def median_step(run, name: str, key: Optional[str] = None
                ) -> Optional[float]:
    """The median over the window's steps of each step's sum over the
    spans called ``name`` that start in it: their seconds, or their
    attribute ``key``. A step with none sums to 0, so work that only the
    window's first step does (a copy that set-up did not warm) leaves
    the median. None when no such span was recorded."""
    spans = [sp for sp in run.spans if sp["name"] == name
             and (key is None or key in (sp.get("attrs") or {}))]
    if not spans or not run.steps:
        return None
    starts = [step[0] for step in run.steps]
    totals = [0.0] * len(starts)
    for sp in spans:
        i = max(0, bisect.bisect_right(starts, sp["start"]) - 1)
        totals[i] += (sp["duration_ms"] / 1e3 if key is None
                      else float(sp["attrs"][key]))
    return float(statistics.median(totals))
