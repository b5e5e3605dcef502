"""``latency_p95_ms`` of the VO cell's frames. Read per layer there: the
frames whose pose step finds a pose triangulate (``pose_found_pct.vo``),
about 3 ms more on the host, and their share lies near 5%, so the 95th
percentile sits on the edge between the two kinds of frame."""

from cardbench.bench import reader

MOVES = "frames_per_s"


def read(run):
    return reader("latency_p95_ms")(run) if run.unit == "frames" else None
