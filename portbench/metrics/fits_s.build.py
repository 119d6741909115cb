"""trainers: seconds of a build outside its `design.build` span (the
fits, their probability passes, metrics and prediction datasets)."""

from portbench.readers import per_step


def read(run):
    design = run.span_seconds("design.build")
    if design is None:
        return None
    return per_step(run, sum(run.step_seconds()) - design)
