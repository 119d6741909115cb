"""expert layer: the median over training steps of the busiest expert's
tokens over the mean, the largest over the expert layers (the
`load_ratio` attribute of the `tx.step` spans)."""

import statistics


def read(run):
    ratios = [sp["attrs"]["load_ratio"] for sp in run.spans
              if sp["name"] == "tx.step"
              and "load_ratio" in (sp.get("attrs") or {})]
    return statistics.median(ratios) if ratios else None
