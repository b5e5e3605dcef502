"""The 95th percentile of the latency of every request answered in the
window: from its hand-over to the entry until its answer is on the host (a
frame: until its pose step is done)."""

import numpy as np


def read(run):
    lat = run.latencies_ms()
    return float(np.percentile(lat, 95)) if lat else None
