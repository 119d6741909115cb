"""expert layer: the expert layers' device seconds per build, forward and
backward (the `moe_ms` attribute of the `tx.step` spans: CUDA events at
the layers' boundaries)."""

from portbench.readers import per_step
from portbench.spans import attr_total


def read(run):
    ms = attr_total(run, "tx.step", "moe_ms")
    return per_step(run, None if ms is None else ms / 1e3)
