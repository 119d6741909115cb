"""catalog, transfer, builder: GB (1e9 bytes) that the `runtime.put` spans
copied to the card per build."""

from portbench.readers import per_step
from portbench.spans import attr_total


def read(run):
    nbytes = attr_total(run, "runtime.put", "bytes")
    return per_step(run, None if nbytes is None else nbytes / 1e9)
