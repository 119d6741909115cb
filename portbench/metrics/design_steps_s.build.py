"""design matrix: seconds of the `design.steps` span (label handling and
the preprocessing steps) per build."""

from portbench.readers import per_step


def read(run):
    return per_step(run, run.span_seconds("design.steps"))
