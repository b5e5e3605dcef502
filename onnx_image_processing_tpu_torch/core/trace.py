"""The port's own spans and counts, kept in memory for an operator or a
benchmark to read.

    from onnx_image_processing_tpu_torch.core import trace

    with trace.recording():
        fn(img1, img2)
    for r in trace.records():
        print(r.name, (r.end - r.start) / 1e3, "us", r.parent, r.call)

A span is a named host interval at a layer boundary (``with
trace.span("jit.replay"):``); a count (``trace.count("io.sync")``) is a
record of no length that carries ``n``. Each record keeps its start and end
in ``time.perf_counter_ns`` nanoseconds, the index of the span open around
it on its thread (``parent``, None for an outermost span), the id of its
outermost span (``call``, shared by every record under it) and the span's
attributes.

Recording is on between :func:`start` and :func:`stop`, and while a
``torch.profiler`` is recording, so a profiled window gets the
program's spans on the clock its device trace can be shifted to. While it is
off, :func:`span` hands back one shared no-op after a single check and
:func:`count` returns at once. A span made by :func:`kept` is recorded
either way (``jit.capture``: captures are rare and say which graph was built
again). At most :data:`LIMIT` records are kept; past that :func:`dropped`
counts what was not.

Names, by layer:

- ``jit.call`` (attribute ``pipeline``): one call of a ``models.jit``
  entry, with children ``jit.copy_in`` (inputs into the graph's static
  buffers), ``jit.replay`` (the graph's launch) and ``jit.clone`` (fresh
  copies of the outputs); ``jit.capture`` (``pipeline``, ``signature``) the
  first call of a signature: warm-ups, capture and instantiation.
- ``io.upload``, ``io.fetch``: the CLIs' host-to-device copies and their
  reads of results; ``io.sync`` counts each read that waits for the card.
- ``serve.upload`` (a chunk's stacking in pinned memory and its uploads),
  ``serve.fetch`` (the results' pinned buffers, copies and event),
  ``serve.wait`` (the wait for that event): ``parallel/throughput.py``.
- ``pose.chirality``: ``vo.recover_pose``'s triangulation and chirality
  test of the four candidate poses.

``python -m onnx_image_processing_tpu_torch.core.trace`` prints the cost of
a span and of a count, recording off and on, in ns.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

from torch._C._autograd import _profiler_enabled

__all__ = ["LIMIT", "Record", "count", "dropped", "kept", "records", "clear", "recording",
           "span", "start", "stop"]

# Records kept in memory; past this, :func:`dropped` counts them.
LIMIT = 1_000_000


class Record(NamedTuple):
    name: str
    start: int            # perf_counter_ns
    end: int              # perf_counter_ns; == start for a count
    parent: int | None    # index in :func:`records` of the span open around it
    call: int             # id shared by every record under one outermost span
    n: int = 1            # a count's value
    attrs: dict | None = None


class _Recorder:
    """The records of the process, each kept as a list in
    :class:`Record`'s order (a span's end is written when it closes), and
    each thread's stack of open spans: (the list its record went into, its
    index there)."""

    def __init__(self):
        self.items: list[list] = []
        self.dropped = 0
        self.calls = 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, name: str, t: int, n: int, attrs) -> tuple[list, int | None]:
        """Append a record that starts at ``t`` under the innermost open span
        of this thread; the list and its index there (None past
        :data:`LIMIT`)."""
        stack = self.stack()
        with self.lock:
            items = self.items
            parent = stack[-1][1] if stack and stack[-1][0] is items else None
            if parent is not None:
                call = items[parent][4]
            elif stack:
                call = self.calls   # under a span dropped or cleared
            else:
                self.calls += 1
                call = self.calls
            if len(items) >= LIMIT:
                self.dropped += 1
                return items, None
            items.append([name, t, t, parent, call, n, attrs or None])
            return items, len(items) - 1


_REC = _Recorder()
_started = False   # between start() and stop()


def _on() -> bool:
    return _started or _profiler_enabled()


class _Span:
    __slots__ = ("name", "attrs", "entry", "stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.entry = _REC.add(self.name, time.perf_counter_ns(), 1, self.attrs)
        self.stack = _REC.stack()
        self.stack.append(self.entry)
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        self.stack.pop()
        items, i = self.entry
        if i is not None:
            items[i][2] = t
        return False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _Noop()


def span(name: str, **attrs):
    """A context manager that records ``name`` around its block while
    recording is on."""
    if _started or _profiler_enabled():
        return _Span(name, attrs)
    return _NOOP


def kept(name: str, **attrs):
    """:func:`span` recorded even while recording is off."""
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """A record of no length carrying ``n``, while recording is on."""
    if _started or _profiler_enabled():
        _REC.add(name, time.perf_counter_ns(), n, None)


def start() -> None:
    """Turn recording on until :func:`stop`."""
    global _started
    _started = True


def stop() -> None:
    global _started
    _started = False


@contextlib.contextmanager
def recording():
    """Record the block (as :func:`start` ... :func:`stop`)."""
    global _started
    was, _started = _started, True
    try:
        yield
    finally:
        _started = was


def records() -> list[Record]:
    """The records kept so far, in the order their spans opened."""
    with _REC.lock:
        return [Record(*r) for r in _REC.items]


def dropped() -> int:
    """Records not kept, past :data:`LIMIT`."""
    return _REC.dropped


def clear() -> None:
    """Forget every record. Spans still open close into the forgotten list,
    and what they enclose from now on is recorded without a parent."""
    with _REC.lock:
        _REC.items = []
        _REC.dropped = 0


def _cost_ns(n: int = 200_000, n_on: int = 10_000, repeat: int = 5) -> dict:
    """ns per span and per count, the least of ``repeat`` timings (as
    ``timeit`` reports): off over ``n`` calls less an empty loop step's,
    and recorded over ``n_on`` calls (the records are then cleared)."""
    if _on():
        raise RuntimeError("recording is on: the cost of the off path cannot be read")

    def per_call(k, body):
        best = float("inf")
        for _ in range(repeat):
            t = time.perf_counter_ns()
            body(k)
            best = min(best, (time.perf_counter_ns() - t) / k)
        return best

    def empty(k):
        for _ in range(k):
            pass

    def spans(k):
        for _ in range(k):
            with span("x"):
                pass

    def counts(k):
        for _ in range(k):
            count("x")

    loop = per_call(n, empty)
    out = {"span_off_ns": per_call(n, spans) - loop, "count_off_ns": per_call(n, counts) - loop}
    with recording():
        out["span_on_ns"] = per_call(n_on, spans) - loop
        out["count_on_ns"] = per_call(n_on, counts) - loop
    clear()
    return out


if __name__ == "__main__":
    import json

    print(json.dumps(_cost_ns()))
