"""linear attention: the KDA layers' device seconds per build, forward,
recomputation and backward, projections included (the `kda_ms` attribute
of the `tx.step` spans: CUDA events at the layers' attention
boundaries)."""

from portbench.readers import per_step
from portbench.spans import attr_total


def read(run):
    ms = attr_total(run, "tx.step", "kda_ms")
    return per_step(run, None if ms is None else ms / 1e3)
