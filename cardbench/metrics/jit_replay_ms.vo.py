"""Host ms per frame in the program's ``jit.replay`` spans (``core/jit.py``;
the extract and match halves, and the extracts of a walk's first frame), in
the traced sub-window."""

from cardbench.program_spans import ms_per_request

MOVES = "frames_per_s"


def read(run):
    return ms_per_request(run, "jit.replay") if run.unit == "frames" else None
