"""Latency-hiding stream executor: overlap host I/O with the card's work
(port of ``onnx_image_processing_tpu/parallel/throughput.py``).

PyTorch launches CUDA work asynchronously: a call enqueues kernels and
returns. A serving loop that copies each result to the host before it
prepares the next input (``for x in stream: y = fn(x).cpu()``) serializes
host time with device time. :func:`stream_map` keeps a bounded window of
steps in flight instead: after ``fn``, each CUDA result starts a
non-blocking copy into pinned host memory owned by its step, and a CUDA
event is recorded after the copies; the step is read only when it is
drained (the event synchronized), so the host prepares step k+1 while the
card runs step k. One stream is enough: the overlap comes from the
asynchronous launches.

Three hazards this layout avoids: a non-blocking copy into pageable memory
is synchronous (the overlap would silently vanish); a result read before
its event completes is garbage; a pinned buffer reused while its owner
still reads it is overwritten (each step allocates its own, and the
caller's arrays keep them alive).

Results and their order are those of the sequential loop; only the wall
clock changes. :func:`vmap_pairs` and :func:`chunk_batch` keep the JAX
package's contracts (a single-pair matcher over B pairs; a batched function
in sequential sub-batches) so that code written against them runs here.
In JAX they route around XLA-TPU layout cliffs; here they are loops of
eager calls, and the port's matchers take B stacked pairs themselves
(``models.build_batched``).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``, of the same structure)."""
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, list):
        return [_tree_map(fn, *xs) for xs in zip(tree, *rest)]
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _first_leaf(tree):
    while isinstance(tree, (tuple, list, dict)):
        tree = next(iter(tree.values() if isinstance(tree, dict) else tree))
    return tree


def vmap_pairs(fn: Callable, chunk: int | None = None) -> Callable:
    """A single-pair matcher ``fn`` of (1, 1, H, W) images over B pairs.

    Returns a callable (img1 (B, 1, H, W), img2 (B, 1, H, W)) -> ``fn``'s
    output structure with each leaf's batch-1 axis stacked to B: what the
    stacked-batch call returns. Pair ``i`` is ``fn(img1[i:i+1],
    img2[i:i+1])``; with ``chunk``, the pairs go in sequential sub-batches
    of ``chunk`` (:func:`chunk_batch`), which gives the same result.
    """
    def batched(img1, img2):
        outs = [fn(img1[i:i + 1], img2[i:i + 1]) for i in range(img1.shape[0])]
        return _tree_map(lambda *xs: torch.cat(xs, dim=0), *outs)

    return batched if chunk is None else chunk_batch(batched, chunk)


def chunk_batch(fn: Callable, chunk: int = 8) -> Callable:
    """A batch-parallel ``fn`` over (B, ...) pytrees in sequential
    sub-batches of ``chunk``, the last one the remainder (B % chunk); the
    outputs are concatenated along the batch axis. B <= ``chunk`` passes
    straight through. Every leaf of the arguments and outputs carries the
    same leading batch axis (close over an unbatched extra such as
    ``k_inv``).
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    def chunked(*args):
        b = _first_leaf(args).shape[0]
        if b <= chunk:
            return fn(*args)
        parts = [fn(*_tree_map(lambda x: x[i:i + chunk], args)) for i in range(0, b, chunk)]
        return _tree_map(lambda *xs: torch.cat(xs, dim=0), *parts)

    return chunked


def _fetch(out):
    """Start the host copy of ``out``: each CUDA tensor goes, without
    blocking, into a pinned buffer of this step, and one CUDA event is
    recorded after the copies. Returns (host tree, event or None)."""
    devices = []

    def start(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if not x.is_cuda:
            return x
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x, non_blocking=True)
        devices.append(x.device)
        return buf

    tree = _tree_map(start, out)
    if not devices:
        return tree, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(devices[0]))
    return tree, event


def _drain(step):
    """Wait for a step's copies, then its results as numpy arrays."""
    tree, event = step
    if event is not None:
        event.synchronize()
    return _tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, tree)


def stream_map(fn: Callable, inputs: Iterable, depth: int = 2) -> Iterator:
    """Map ``fn`` over ``inputs`` with at most ``depth`` steps in flight.

    Args:
        fn: a function of one step's inputs, called as ``fn(*x)`` for a
            tuple ``x``, ``fn(x)`` otherwise; its result is a tensor or a
            tuple / list / dict of them.
        inputs: per-step inputs, consumed lazily (pair this with a
            generator that does the host-side decode and preprocessing).
        depth: steps in flight. 1 is the sequential loop; 2 overlaps one
            step of host work with the card's.

    Yields:
        Each step's result on the host, numpy arrays in ``fn``'s structure,
        in input order.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    return _stream(fn, inputs, depth)


def _stream(fn, inputs, depth):
    pending: deque = deque()
    for x in inputs:
        # Drain before dispatching, so at most `depth` steps are in flight
        # and depth=1 overlaps nothing.
        if len(pending) >= depth:
            yield _drain(pending.popleft())
        pending.append(_fetch(fn(*x) if isinstance(x, tuple) else fn(x)))
    while pending:
        yield _drain(pending.popleft())


def _upload(arrays, device: torch.device) -> torch.Tensor:
    """Stack host arrays along axis 0 in one ``np.concatenate``; for a CUDA
    device into pinned memory, then one non-blocking upload."""
    arrays = [np.asarray(a) for a in arrays]
    if device.type != "cuda":
        return torch.from_numpy(np.concatenate(arrays, axis=0))
    shape = (sum(a.shape[0] for a in arrays),) + arrays[0].shape[1:]
    dtype = torch.from_numpy(np.empty(0, dtype=arrays[0].dtype)).dtype
    host = torch.empty(shape, dtype=dtype, pin_memory=True)
    np.concatenate(arrays, axis=0, out=host.numpy())
    return host.to(device, non_blocking=True)


def stream_map_chunked(fn_batched, pairs: Iterable, chunk: int, depth: int = 2) -> Iterator:
    """Serve (img1, img2) pairs through a batched matcher, ``chunk`` pairs
    per call.

    Each chunk is stacked on the host, one array per side (pinned for the
    card), uploaded once per side, run as one batched call and fetched as
    in :func:`stream_map`.

    Args:
        fn_batched: a callable over ((C, 1, H, W), (C, 1, H, W)) batches
            on the device its ``device`` names. The served form is
            ``models.jit(models.build_batched(name, device=...))``, as the
            JAX package serves its jitted ``build_batched``: one CUDA graph
            per chunk shape, replayed on the stream the results are
            fetched on (its outputs are fresh clones, enqueued before the
            fetch's event). ``models.build_batched(...)`` alone runs eager.
        pairs: iterable of (img1, img2) host arrays, (1, 1, H, W) each.
        chunk: pairs per call. The final short chunk is padded to ``chunk``
            by repeating its last pair, and the padding's results dropped.
        depth: chunks in flight (as in :func:`stream_map`).

    Yields:
        One result per input pair, in input order: ``fn_batched``'s
        outputs with the chunk axis indexed away, as numpy arrays.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    return _chunked(fn_batched, pairs, chunk, depth, torch.device(fn_batched.device))


def _chunked(fn_batched, pairs, chunk, depth, dev):
    def chunks():
        buf = []
        for pair in pairs:
            buf.append(pair)
            if len(buf) == chunk:
                yield buf, chunk
                buf = []
        if buf:
            n = len(buf)
            yield buf + [buf[-1]] * (chunk - n), n

    def run(buf, n):
        img1 = _upload([p[0] for p in buf], dev)
        img2 = _upload([p[1] for p in buf], dev)
        return fn_batched(img1, img2), n

    for out, n in _stream(run, chunks(), depth):
        for i in range(n):
            yield _tree_map(lambda x: x[i], out)
