"""Pairs whose results reached the host inside the window, per second of it."""


def read(run):
    return run.completed() / run.seconds if run.unit == "pairs" else None
