"""design matrix: seconds of the `design.build` span (the embed's design
matrix) per image."""

from portbench.readers import per_step


def read(run):
    return per_step(run, run.span_seconds("design.build"))
