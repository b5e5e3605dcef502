"""Host ms per frame in the program's ``pose.chirality`` spans
(``vo.recover_pose``: the four candidates' triangulation and chirality
test), in the traced sub-window."""

from cardbench.program_spans import ms_per_request

MOVES = "frames_per_s"


def read(run):
    return ms_per_request(run, "pose.chirality") if run.unit == "frames" else None
