"""``roofline_pct.sinkhorn.pairs``, read in the served cell, where it moves ``pairs_per_s.served``."""

from cardbench.bench import reader

MOVES = "pairs_per_s.served"


def read(run):
    return reader("roofline_pct.sinkhorn.pairs")(run)
