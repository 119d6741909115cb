"""tune: the port's kernel launches per sweep, from its launch counters."""

from portbench.readers import per_step


def read(run):
    return per_step(run, run.state.get("launches"))
