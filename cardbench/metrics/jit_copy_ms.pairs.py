"""Host ms per pair in the program's ``jit.copy_in`` and ``jit.clone``
spans (``core/jit.py``: the inputs into the graph's static buffers, fresh
copies of its outputs), in the traced sub-window."""

from cardbench.program_spans import ms_per_request

MOVES = "pairs_per_s"


def read(run):
    return ms_per_request(run, "jit.copy_in", "jit.clone") if run.unit == "pairs" else None
