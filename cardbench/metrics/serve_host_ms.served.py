"""Host ms per pair in the program's ``serve.upload`` and ``serve.fetch``
spans (``parallel/throughput.py``: a chunk's pinned stacking and uploads;
its results' pinned buffers, copies and event), in the traced sub-window."""

from cardbench.program_spans import ms_per_request

MOVES = "pairs_per_s.served"


def read(run):
    return ms_per_request(run, "serve.upload", "serve.fetch") if run.unit == "pairs" else None
