"""Device idle ms per pair in the traced sub-window, in the gaps whose
middle falls where the innermost open program span is a ``jit.*`` span
(``core/jit.py``): ``trace.breakdown``'s rule applied to the program's
spans."""

from cardbench.program_spans import idle_ms_per_request

MOVES = "pairs_per_s"


def read(run):
    return idle_ms_per_request(run, "jit.") if run.unit == "pairs" else None
