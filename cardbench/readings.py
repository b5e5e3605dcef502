"""What the metric readers share: per-request sums of the harness's spans,
the device's busy time over the traced sub-window, and kernel times by
name. Each returns None where the run has nothing to read."""

from __future__ import annotations

from cardbench import trace


def span_ms_per_request(run, *names: str, minus: tuple = ()) -> float | None:
    """(Summed ``names`` spans - summed ``minus`` spans) that start in the
    window, in ms per request answered in it."""
    n = run.completed()
    if run.spans is None or not n:
        return None
    total = sum(run.spans.total_ns(x, run.t0, run.t1) for x in names)
    if not total:
        return None
    total -= sum(run.spans.total_ns(x, run.t0, run.t1) for x in minus)
    return total / 1e6 / n


def busy(run):
    """(busy ns, traced ns, requests answered) of the traced sub-window."""
    if run.traced is None:
        return None
    lo, hi = run.traced
    return trace.busy_ns(run.events, lo, hi), hi - lo, run.completed(lo, hi)


def kernels(run, *names: str) -> list[tuple[str, int]]:
    """(name, ns) of each launch in the traced sub-window of a kernel whose
    name holds one of ``names``."""
    if run.traced is None:
        return []
    lo, hi = run.traced
    return [(n, e - s) for n, s, e in run.events
            if lo <= s and e <= hi and any(x in n for x in names)]
