"""kernels: the port's kernel calls' summed bound seconds over their
summed device seconds, in percent."""

from portbench.readers import kernels_roofline


def read(run):
    return kernels_roofline(run)
