"""design matrix: seconds of the `design.build` span per build."""

from portbench.readers import per_step


def read(run):
    return per_step(run, run.span_seconds("design.build"))
