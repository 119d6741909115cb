"""whole step: a build's needed work (each family's fit and probability
pass, as roofline seconds) over its wall seconds, in percent."""

from portbench.readers import build_bound_s, step_mfu


def read(run):
    return step_mfu(run, build_bound_s(run))
