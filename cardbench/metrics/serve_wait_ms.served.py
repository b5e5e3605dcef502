"""Host ms per pair in the program's ``serve.wait`` spans
(``parallel/throughput.py`` ``_drain``: the wait for a chunk's results'
event), in the traced sub-window."""

from cardbench.program_spans import ms_per_request

MOVES = "pairs_per_s.served"


def read(run):
    return ms_per_request(run, "serve.wait") if run.unit == "pairs" else None
