"""trainers: the median seconds of the `tx.step` span (one training step
of the tx fit, ending when its loss has been read back)."""

import statistics


def read(run):
    durs = [sp["duration_ms"] / 1e3 for sp in run.spans
            if sp["name"] == "tx.step"]
    return statistics.median(durs) if durs else None
