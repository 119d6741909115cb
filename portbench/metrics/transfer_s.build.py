"""catalog, transfer, builder: seconds of the `runtime.put` spans (the
host side of each host-to-device copy) per build."""

from portbench.readers import per_step


def read(run):
    return per_step(run, run.span_seconds("runtime.put"))
