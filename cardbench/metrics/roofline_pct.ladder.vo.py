"""The AKAZE ladder's share of its roofline: the least time for one
extract's ladder (``work/ladder.py`` at B = 1, the streaming extract) at the
card's peaks, over the device time of one launch of the tile-resident
ladder kernel in the traced sub-window."""

from cardbench.peaks import least_seconds
from cardbench.readings import kernels
from cardbench.work import ladder

MOVES = "frames_per_s"
KERNELS = ("ladder_resident_kernel",)


def read(run):
    launches = kernels(run, *KERNELS)
    if run.unit != "frames" or not launches:
        return None
    a = run.config["settings"]["akaze"]
    ops, nbytes = ladder.work(1, run.config["height"], run.config["width"], a["num_scales"],
                              a["diffusion_iterations"], a["nms_size"],
                              a["orientation_patch_size"])
    mean_s = sum(ns for _, ns in launches) / len(launches) / 1e9
    return 100.0 * least_seconds(ops, nbytes) / mean_s
