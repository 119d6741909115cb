"""latent attention: the attention's device seconds per build, forward
and backward, projections included (the `mla_ms` attribute of the
`tx.step` spans: CUDA events at the attention's boundaries)."""

from portbench.readers import per_step
from portbench.spans import attr_total


def read(run):
    ms = attr_total(run, "tx.step", "mla_ms")
    return per_step(run, None if ms is None else ms / 1e3)
