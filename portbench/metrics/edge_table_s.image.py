"""t-SNE stages: seconds of the `viz.edge_table` span per image."""

from portbench.readers import per_step


def read(run):
    return per_step(run, run.span_seconds("viz.edge_table"))
