"""The program's ``io.sync`` counts per pair, in the traced sub-window:
device-to-host reads that wait for the card (four in the extraction CLI's
``match``, one in the VO CLI's ``to_host``)."""

from cardbench.program_spans import count_per_request

MOVES = "pairs_per_s"


def read(run):
    return count_per_request(run, "io.sync") if run.unit == "pairs" else None
