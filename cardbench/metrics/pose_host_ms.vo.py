"""Host time per frame in ``vo.recover_pose``."""

from cardbench.readings import span_ms_per_request

MOVES = "frames_per_s"


def read(run):
    return span_ms_per_request(run, "pose") if run.unit == "frames" else None
