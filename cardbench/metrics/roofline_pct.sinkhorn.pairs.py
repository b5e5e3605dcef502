"""The Sinkhorn kernel's share of its roofline: the least time for one
launch's work (``work/sinkhorn.py``: B pairs of (K+1) x (K+1), B the
traffic's pairs per call) at the card's peaks, over the launch's mean
device time in the traced sub-window."""

from cardbench.peaks import least_seconds
from cardbench.readings import kernels
from cardbench.work import sinkhorn

MOVES = "pairs_per_s"
KERNELS = ("sinkhorn_grid_kernel",)


def read(run):
    launches = kernels(run, *KERNELS)
    if run.unit != "pairs" or not launches:
        return None
    s = run.config["settings"]
    k = s["max_keypoints"]
    ops, nbytes = sinkhorn.work(run.pairs_per_call, k, k, s["sinkhorn_iterations"])
    mean_s = sum(ns for _, ns in launches) / len(launches) / 1e9
    return 100.0 * least_seconds(ops, nbytes) / mean_s
