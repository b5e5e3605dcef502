"""Device busy ms (the union of kernels, copies and sets) per VO frame
answered in the traced sub-window."""

from cardbench.readings import busy

MOVES = "frames_per_s"


def read(run):
    b = busy(run)
    if run.unit != "frames" or b is None or not b[2]:
        return None
    return b[0] / 1e6 / b[2]
