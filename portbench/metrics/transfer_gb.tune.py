"""catalog, transfer, builder: GB (1e9 bytes) that the `runtime.put` spans
copied to the card in the window's median sweep (the first sweep also
copies the design matrix, which set-up's smaller warm-up did not)."""

from portbench.spans import median_step


def read(run):
    nbytes = median_step(run, "runtime.put", "bytes")
    return None if nbytes is None else nbytes / 1e9
