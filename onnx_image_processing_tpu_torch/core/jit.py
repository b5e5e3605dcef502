"""Whole calls as CUDA graphs: the port's counterpart of ``jax.jit``.

Every entry point of the JAX package hands its caller a ``jax.jit``
executable: the first call compiles the whole pipeline for its static
shapes, the executable is cached, and each later call is one dispatch.
:func:`jit` gives a module of the port the same contract on the card. The
first call with a new input signature (the inputs' tree and each leaf's
shape, dtype and device, :func:`signature`) captures the whole call in one
CUDA graph over static input buffers. Every call copies its inputs into
those buffers on the current stream, replays the graph and returns clones
of its outputs, so a caller that holds call i's results does not see call
i + 1 overwrite them, as JAX returns fresh arrays. On CPU tensors the module
is called as it is: that is the tests' path, and the caller asked for the
CPU.

What the host computes from input values is frozen into a graph at
capture. A call that reads a value on the host (``.item()``) cannot be
captured: the capture raises, naming the pipeline, and there is no eager
stand-in. A graph's kernels launch in the order they were captured on one
stream, so two graphs must not replay at once on two streams of one card
(the kernels' ticket counters are per device).
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass

import torch

__all__ = ["Captured", "Jitted", "capture", "jit", "signature"]

# Eager calls of a body before its capture (see :func:`capture`).
WARMUP_CALLS = 2

# The module attributes a :class:`Jitted` answers for its module: the
# registry's (``models.build``) and, for ``Batched``, the chunk and pipeline.
_FORWARDED = frozenset({"cfg", "device", "pipeline_name", "capture_blocker",
                        "chunk", "pipeline"})


@dataclass(frozen=True)
class Captured:
    graph: torch.cuda.CUDAGraph
    out: object      # the captured call's outputs, refreshed by each replay
    seconds: float   # capture and instantiation on the host clock


def capture(body, device: torch.device, keep_graph: bool = False, warm=None) -> Captured:
    """``body()`` captured in a CUDA graph on ``device``, after two eager
    calls of ``warm`` (default ``body``) on a side stream, which make
    the kernels' per-device constants, plans and counters outside the
    capture; ``warm`` must run what ``body`` runs, at its shapes. The
    capture runs on that side stream too: ``torch.cuda.graph``'s default
    stream lies on the device current at its first use, and a capture on
    another device's stream is invalidated. ``keep_graph`` keeps the
    captured graph beside its executable (``graph.raw_cuda_graph()``). A
    failing capture raises: there is no eager stand-in."""
    device = torch.device(device)
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                (warm or body)()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=side):
            out = body()
        if keep_graph:
            graph.instantiate()
        seconds = time.perf_counter() - t0
    return Captured(graph, out, seconds)


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the iterator."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    return next(leaves)


def signature(args) -> tuple:
    """The cache key of a call's inputs: their tree of tuples and lists, and
    each leaf's shape, dtype and device. A leaf that is not a tensor raises
    ``TypeError``: its value would be frozen into the graph."""
    if isinstance(args, (tuple, list)):
        return (type(args).__name__, tuple(signature(x) for x in args))
    if not isinstance(args, torch.Tensor):
        raise TypeError(f"jit: every input leaf must be a tensor, got {type(args).__name__}")
    return (tuple(args.shape), args.dtype, args.device)


def _name(module) -> str:
    return getattr(module, "pipeline_name", type(module).__name__)


@dataclass(frozen=True)
class _Graph:
    inputs: list     # the static input buffers, in leaf order
    captured: Captured


class Jitted:
    """``module`` behind a cache of CUDA graphs, one per input signature
    (see the module docstring). ``module`` is the eager module; ``graphs``
    counts the captured signatures, ``replays`` the calls that replayed one
    and ``capture_seconds`` the host time of every first call (warm-ups,
    capture and instantiation). ``cfg``, ``device``, ``pipeline_name``,
    ``capture_blocker``, ``chunk`` and ``pipeline`` are the module's.

    ``copy.deepcopy`` copies the module and starts with no graph; ``to()``
    moves the module and drops every graph, so no graph reaches another
    device or outlives the memory it reads."""

    def __init__(self, module):
        self.module = module
        self._graphs: dict[tuple, _Graph] = {}
        self.replays = 0
        self.capture_seconds = 0.0

    def __getattr__(self, name):
        if name in _FORWARDED:
            return getattr(self.module, name)
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def __deepcopy__(self, memo):
        return Jitted(copy.deepcopy(self.module, memo))

    def to(self, *args, **kwargs) -> Jitted:
        self.module.to(*args, **kwargs)
        self._graphs.clear()
        return self

    @property
    def graphs(self) -> int:
        return len(self._graphs)

    @property
    def captures(self) -> list[Captured]:
        """The captured graphs (kept with their executables), oldest first."""
        return [g.captured for g in self._graphs.values()]

    def __call__(self, *args):
        leaves = _leaves(args)
        key = signature(args)
        devices = {x.device for x in leaves}
        if len(devices) != 1:
            raise ValueError(f"jit: {_name(self.module)} got inputs on "
                             f"{sorted(map(str, devices)) or 'no device'}; "
                             "they must lie on one device")
        (dev,) = devices
        if dev.type != "cuda":
            return self.module(*args)
        with torch.no_grad(), torch.cuda.device(dev):
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture(args, leaves, dev)
            for buf, x in zip(entry.inputs, leaves):
                buf.copy_(x)
            entry.captured.graph.replay()
            self.replays += 1
            return _unflatten(entry.captured.out,
                              iter([t.clone() for t in _leaves(entry.captured.out)]))

    def _capture(self, args, leaves, dev) -> _Graph:
        name = _name(self.module)
        blocker = getattr(self.module, "capture_blocker", None)
        if blocker:
            raise ValueError(f"{name} cannot be captured in a CUDA graph: {blocker}")
        t0 = time.perf_counter()
        # Plain tensors, not inference tensors, so that a later call outside
        # torch.inference_mode may copy into them.
        with torch.inference_mode(False):
            static = [torch.empty_like(x, memory_format=torch.contiguous_format)
                      for x in leaves]
        for buf, x in zip(static, leaves):
            buf.copy_(x)
        tree = _unflatten(args, iter(static))
        try:
            cap = capture(lambda: self.module(*tree), dev, keep_graph=True)
        except RuntimeError as e:
            raise RuntimeError(f"CUDA-graph capture of {name} failed: {e}") from e
        bad = [type(t).__name__ for t in _leaves(cap.out) if not isinstance(t, torch.Tensor)]
        if bad:
            raise TypeError(f"jit: {name} returned non-tensor leaves {bad}; their values "
                            "would be frozen into the graph")
        self.capture_seconds += time.perf_counter() - t0
        return _Graph(static, cap)


def jit(module) -> Jitted:
    """``module`` called through whole-call CUDA graphs on the card, and as
    it is on the CPU: the port's ``jax.jit``. ``module`` is a pipeline of
    ``models.build``, ``build_batched`` or ``build_streaming``, or any
    callable of tensors (trees of tuples and lists of them) that returns
    tensors. A :class:`Jitted` is returned as it is."""
    return module if isinstance(module, Jitted) else Jitted(module)
