"""Shared CLI plumbing of the port: device selection, image loading, timing.

The port's counterpart of ``onnx_image_processing_tpu/cli/common.py``.
``--device {cuda,cpu}`` takes the place of ``--platform``; the JAX compile
cache has no counterpart here. ``--timing`` keeps the JAX package's two
protocols. ``host`` is the reference's warm-up and timed loop on the host
clock. ``chain`` is the differential chain: whole calls chained by data at
two lengths, n and 3n, and ms per frame = (T(3n) - T(n)) / (2n), which
cancels every fixed cost of a run. JAX compiles the chain into one
``lax.scan``; the port captures each length on the card as one CUDA graph,
so a replay launches the chain's kernels without the host's per-launch
cost, and runs the same chain as a plain loop on the CPU. PIL and OpenCV
are imported where they are used, so importing this module needs neither.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device the pipeline runs on (reference: --provider)")


def select_device(name: str) -> torch.device:
    """The device ``--device`` names; CUDA without a card raises (there is
    no silent switch to the CPU)."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is False; "
                           "pass --device cpu to run on the CPU")
    return torch.device(name)


def load_image(path: str, height: int, width: int):
    """Grayscale (1, 1, H, W) float32 in [0, 255] + resized RGB for viz.

    Parity: `sample/feature_detection.py:27-45` (bilinear resize).
    """
    from PIL import Image

    img = Image.open(path).convert("L").resize((width, height), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32)[None, None]
    return arr, img.convert("RGB")


def load_image_from_array(frame_bgr: np.ndarray, height: int, width: int):
    """BGR frame -> grayscale (1, 1, H, W) float32 (VO loop input,
    `sample/visual_odometry.py:522-539`)."""
    import cv2

    gray = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY) \
        if frame_bgr.ndim == 3 else frame_bgr
    gray = cv2.resize(gray, (width, height), interpolation=cv2.INTER_LINEAR)
    return gray.astype(np.float32)[None, None]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(fn, args, warmup: int = 5, iterations: int = 10) -> float:
    """Reference timing protocol (`sample/image_matching.py:313-328`):
    warm-up, then a timed loop that ends in a device synchronize; returns
    mean ms per call on the host clock. ``args`` are tensors on one device."""
    device = args[0].device
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iterations):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / iterations * 1e3


def add_timing_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--timing", choices=["host", "chain"], default="host",
        help="benchmark protocol: 'host' = reference warmup+timed loop "
             "(client-side latency; launch-inclusive on the card), "
             "'chain' = on-device differential-chain ms/frame (a CUDA graph "
             "on the card)")


def _chain(fn, args, length: int) -> torch.Tensor:
    """``length`` calls of ``fn`` chained by data, the body of the JAX
    package's ``lax.scan`` chain: call ``i`` runs on the carry, its first
    output's first element ``s`` (cast to the carry's dtype) moves every
    input by ``s * 1e-12``, and the ``s`` are summed into one scalar."""
    carry = tuple(args)
    total = None
    for _ in range(length):
        out = fn(*carry)
        leaf = out[0] if isinstance(out, (tuple, list)) else out
        s = leaf.reshape(-1)[0].to(carry[0].dtype)
        carry = tuple(c + s * 1e-12 for c in carry)
        total = s if total is None else total + s
    return total


def _path_name(fn) -> str:
    """The registry name of a pipeline built by ``models.build``, else its
    type's name."""
    return getattr(fn, "pipeline_name", type(fn).__name__)


@dataclass(frozen=True)
class Captured:
    graph: torch.cuda.CUDAGraph
    out: object      # the captured call's outputs, refreshed by each replay
    seconds: float   # capture and instantiation on the host clock


def capture(body, device: torch.device, keep_graph: bool = False, warm=None) -> Captured:
    """``body()`` captured in a CUDA graph on ``device``, after two eager
    calls of ``warm`` (default ``body``) on a side stream, which make
    the kernels' per-device constants, plans and counters outside the
    capture; ``warm`` must run what ``body`` runs, at its shapes. ``keep_graph``
    keeps the captured graph beside its executable
    (``graph.raw_cuda_graph()``). A failing capture raises: there is no
    eager stand-in."""
    device = torch.device(device)
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                (warm or body)()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            out = body()
        if keep_graph:
            graph.instantiate()
        seconds = time.perf_counter() - t0
    return Captured(graph, out, seconds)


@dataclass(frozen=True)
class ChainTimes:
    """What :func:`chain_times` measured. ``peak_bytes`` is the chain's own
    device memory at its peak (both graphs over what was allocated before
    them); ``capture_s`` and ``peak_bytes`` are 0 and None on the CPU."""
    ms_per_frame: float
    short_s: float            # best run of n calls
    long_s: float             # best run of 3n calls
    capture_s: float          # both graphs
    peak_bytes: int | None


def chain_times(fn, args, n: int = 30, reps: int = 3) -> ChainTimes:
    """The chain protocol's measurements of ``fn(*args)``.

    On CUDA tensors each chain length is one CUDA graph, and a timed run is
    its replay, a synchronize and the read of the summed scalar, on the host
    clock. On CPU tensors the chain runs as a plain loop. Each length runs
    once to warm, then ``reps`` times; the best time of each counts.
    """
    device = args[0].device
    if device.type == "cuda":
        blocker = getattr(fn, "capture_blocker", None)
        if blocker:
            raise ValueError(f"{_path_name(fn)} cannot be captured in a CUDA graph: "
                             f"{blocker}; time it with --timing host")
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        runs, capture_s = [], 0.0
        for length in (n, 3 * n):
            try:
                cap = capture(lambda length=length: _chain(fn, args, length), device,
                              warm=lambda: _chain(fn, args, 1))
            except RuntimeError as e:
                raise RuntimeError(f"CUDA-graph capture of {_path_name(fn)} failed: {e}") from e
            capture_s += cap.seconds

            def run(cap=cap):
                cap.graph.replay()
                torch.cuda.synchronize(device)
                return float(cap.out)

            runs.append(run)
        peak = torch.cuda.max_memory_allocated(device) - base
    else:
        runs = [lambda length=length: float(_chain(fn, args, length)) for length in (n, 3 * n)]
        capture_s, peak = 0.0, None
    for run in runs:
        run()

    def best(run):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        return min(times)

    t_short, t_long = best(runs[0]), best(runs[1])
    return ChainTimes(max(t_long - t_short, 1e-9) * 1e3 / (2 * n), t_short, t_long,
                      capture_s, peak)


def benchmark_chain(fn, args, n: int = 30, reps: int = 3) -> float:
    """Device ms per frame of ``fn(*args)`` by the differential chain:
    (T(3n) - T(n)) / (2n), which cancels the fixed cost of a run (see
    :func:`chain_times`). On the card it raises ``ValueError`` for a
    pipeline that cannot be captured, naming why."""
    return chain_times(fn, args, n, reps).ms_per_frame


def run_benchmark(fn, args, timing: str) -> float:
    """Print the benchmark line of ``timing`` ("host" or "chain"), labeled
    with its protocol; returns its ms per frame."""
    if timing == "chain":
        ms = benchmark_chain(fn, args)
        print(f"Elapsed (device, chain protocol): {ms:.3f} ms/frame "
              f"({1e3 / ms:.1f} fps)")
        return ms
    ms = benchmark(fn, args)
    device = args[0].device
    note = (" [host-visible latency incl. kernel launches and host<->device "
            "transfer; use --timing chain for device ms/frame]"
            if device.type != "cpu" else "")
    print(f"Elapsed: {ms:.3f} ms/frame ({1e3 / ms:.1f} fps) on {device}{note}")
    return ms


def report_benchmark(fn, args) -> None:
    run_benchmark(fn, args, "host")
