"""whole step: an embedding's needed descent work (repulsion over every
valid pair and attraction over every table entry, each step, as
roofline seconds) over its wall seconds, in percent."""

from portbench.readers import step_mfu, tsne_bound_s


def read(run):
    return step_mfu(run, tsne_bound_s(run))
