"""100 minus the device's busy share of the traced sub-window (pair cells)."""

from cardbench.readings import busy

MOVES = "pairs_per_s"


def read(run):
    b = busy(run)
    if run.unit != "pairs" or b is None or not b[1]:
        return None
    return 100.0 * (1.0 - b[0] / b[1])
