"""Host ms per pair in the program's ``jit.replay`` spans (``core/jit.py``:
the CUDA graph's launch), in the traced sub-window."""

from cardbench.program_spans import ms_per_request

MOVES = "pairs_per_s"


def read(run):
    return ms_per_request(run, "jit.replay") if run.unit == "pairs" else None
