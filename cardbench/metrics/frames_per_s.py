"""VO frames whose pose step finished inside the window, per second of it."""


def read(run):
    return run.completed() / run.seconds if run.unit == "frames" else None
