"""catalog, transfer, builder: seconds of the `catalog.consolidate` span
(a dataset's chunks made one set of columns) per build."""

from portbench.readers import per_step


def read(run):
    return per_step(run, run.span_seconds("catalog.consolidate"))
