"""Serving's own host time per pair: the spans around each step of
``stream_map_chunked``'s iterator, less those around the calls into the
jitted entry and around the harness's pair generator (it keeps the drain's
wait for the results' event)."""

from cardbench.readings import span_ms_per_request

MOVES = "pairs_per_s.served"


def read(run):
    return span_ms_per_request(run, "serve_next", minus=("jit_call", "pair_gen"))
