"""Host ms per pair in the program's ``io.upload`` and ``io.fetch`` spans,
in the traced sub-window: the extraction CLI's ``match`` (two uploads, four
reads) in ``flagship.single``; in ``akaze_essential.pairs`` the harness
uploads the pair itself, so only ``io.fetch``, the VO CLI's ``to_host``."""

from cardbench.program_spans import ms_per_request

MOVES = "pairs_per_s"


def read(run):
    return ms_per_request(run, "io.upload", "io.fetch") if run.unit == "pairs" else None
