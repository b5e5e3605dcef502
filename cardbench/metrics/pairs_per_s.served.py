"""``pairs_per_s`` in the served cell: its own bound, since batching keeps
the card busy and the rate spreads far less than one pair at a time."""

from cardbench.bench import reader


def read(run):
    return reader("pairs_per_s")(run)
