"""``jit_host_ms.pairs``, read in the served cell, where it moves ``pairs_per_s.served``."""

from cardbench.bench import reader

MOVES = "pairs_per_s.served"


def read(run):
    return reader("jit_host_ms.pairs")(run)
