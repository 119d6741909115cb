"""whole step: a sweep's needed work (each member's forest on its
training rows and the promoted refit, as roofline seconds) over its wall
seconds, in percent."""

from portbench.readers import step_mfu, tune_bound_s


def read(run):
    return step_mfu(run, tune_bound_s(run))
