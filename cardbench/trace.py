"""What a traced run records: the harness's own spans around its calls into
the program, and the device's activity over a fixed sub-window, read from
``torch.profiler``'s CUPTI trace (kernels inside CUDA-graph replays
included).

Spans and device events share one clock: nanoseconds of
``time.perf_counter_ns``. The profiler stamps device events in nanoseconds
since the epoch; :class:`DeviceTrace` shifts them by the offset between the
two clocks, taken when it starts.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

__all__ = ["Spans", "DeviceTrace", "busy_ns", "idle_gaps", "breakdown"]


class Spans:
    """Named host intervals, kept in memory: ``t = spans.now()`` before a
    call, ``spans.add(name, t)`` after it."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []
        self.now = time.perf_counter_ns

    def add(self, name: str, start: int) -> None:
        self.items.append((name, start, time.perf_counter_ns()))

    def total_ns(self, name: str, lo: int, hi: int) -> int:
        """Summed length of the ``name`` spans that start in [lo, hi)."""
        return sum(e - s for n, s, e in self.items if n == name and lo <= s < hi)


class DeviceTrace:
    """CUPTI tracing of the card between :meth:`start` and :meth:`stop`;
    ``events`` are then (name, start, end) of every kernel, copy and set on
    the device, and ``window`` the (start, end) of the tracing, both in
    ``perf_counter_ns`` time."""

    def __init__(self):
        self.events: list[tuple[str, int, int]] = []
        self.window: tuple[int, int] | None = None
        self._offset = 0
        self._t0 = 0

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerConfig, ProfilerState, _enable_profiler,
                                    _prepare_profiler)
        from torch.profiler import ProfilerActivity

        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                _ExperimentalConfig())
        activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        _prepare_profiler(config, activities)
        self._offset = time.time_ns() - time.perf_counter_ns()
        _enable_profiler(config, activities)
        self._t0 = time.perf_counter_ns()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType, _disable_profiler

        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        result = _disable_profiler()
        off = self._offset
        self.events = [(e.name(), e.start_ns() - off, e.end_ns() - off)
                       for e in result.events() if e.device_type() == DeviceType.CUDA]
        self.window = (self._t0, t1)


def _merged(events, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of the events' intervals clipped to [lo, hi], as disjoint
    sorted intervals."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in events if e > lo and s < hi)
    out: list[list[int]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(events, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] in which some device operation ran."""
    return sum(e - s for s, e in _merged(events, lo, hi))


def idle_gaps(events, lo: int, hi: int) -> list[tuple[int, int]]:
    """The intervals of [lo, hi] in which nothing ran on the device."""
    gaps, t = [], lo
    for s, e in _merged(events, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def _innermost(items) -> tuple[list[int], list[str]]:
    """The host's timeline from spans that nest (one thread): segment starts,
    sorted, and each segment's innermost span name (``harness`` outside
    every span)."""
    bounds = []
    for name, s, e in items:
        bounds.append((s, 1, -e, name))
        bounds.append((e, 0, 0, name))
    bounds.sort()
    starts, labels, stack = [], [], []
    for t, opening, _, name in bounds:
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        starts.append(t)
        labels.append(stack[-1] if stack else "harness")
    return starts, labels


def breakdown(events, spans: Spans, lo: int, hi: int, top: int = 10) -> dict:
    """The device operations that took most time in [lo, hi] (summed by
    name), and the device's idle time there summed by what the host was
    doing at the middle of each gap: the innermost harness span around it,
    else ``harness``. Seconds, at most ``top`` of each."""
    ops: dict[str, int] = defaultdict(int)
    for name, s, e in events:
        if e > lo and s < hi:
            ops[name] += min(e, hi) - max(s, lo)
    starts, labels = _innermost(spans.items)
    idle: dict[str, int] = defaultdict(int)
    for s, e in idle_gaps(events, lo, hi):
        i = bisect.bisect_right(starts, (s + e) // 2) - 1
        idle[labels[i] if i >= 0 else "harness"] += e - s

    def ranked(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
