"""tune: seconds of the `tune.wave` spans (a wave's fold masks, edges,
copies and binning launch) in the window's median sweep (the first
sweep's wave also copies the design matrix)."""

from portbench.spans import median_step


def read(run):
    return median_step(run, "tune.wave")
