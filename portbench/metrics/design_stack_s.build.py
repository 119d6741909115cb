"""design matrix: seconds of the `design.stack` span (the float32 stack of
the feature columns) per build."""

from portbench.readers import per_step


def read(run):
    return per_step(run, run.span_seconds("design.stack"))
