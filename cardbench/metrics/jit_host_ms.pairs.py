"""Host time per pair in the calls of the ``models.jit`` entry (copy-in,
replay, the clones enqueued; no wait for the device)."""

from cardbench.readings import span_ms_per_request

MOVES = "pairs_per_s"


def read(run):
    return span_ms_per_request(run, "jit_call") if run.unit == "pairs" else None
