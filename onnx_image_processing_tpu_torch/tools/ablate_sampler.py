"""Stage ablation of the sparse sampler kernel on the card.

    python -m onnx_image_processing_tpu_torch.tools.ablate_sampler

The port of ``benchmarks/ablate_sampler.py``, which ablates the TPU
kernel's own stages (roll, masks, matmul, epilogue). This one ablates the
CUDA kernel's (``csrc/sparse_sampler.cu``): the window load, the box sums
and the store (``kernels.sparse_sampler.STAGES``). Skipping a stage gives
wrong outputs on purpose; the time it saves is that stage's cost.

Geometry as the JAX harness's: B=2 images, K=512 keypoints, the 512-pair
table's S=805 unique boxes (``ops.sample_layout``), a random 480x640 image
and random window origins and sample coordinates from
``numpy.random.default_rng(0)``, nearest mode. Each variant is timed two
ways: ``ms``, CUDA events around one wrapper call (the median of 25 calls
after 3 warm-up calls), which includes the wrapper's host time whenever the
card waits for the launch; and ``device_ms``, CUDA events around the replay
of a CUDA graph of 20 launches, per launch (the median of 10 replays),
which holds the kernel's own time only. Prints one JSON line per variant:
``variant``, ``ms``, ``device_ms`` and, past the full kernel,
``attributed_ms`` and ``attributed_device_ms`` = full minus variant. Launches
inside the graph are counted once, at capture, not at each replay. Needs a
CUDA device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..kernels import sparse_sampler
from ..ops import BADTable, load_bad_params
from ..ops.bad import _PATCH

VARIANTS = ((), ("load",), ("boxsum",), ("store",))
B, K, H, W = 2, 512, 480, 640


def ablation_inputs(device, seed: int = 0):
    """The harness's sampler arguments, drawn as ``benchmarks/ablate_sampler.py``
    draws them, on ``device``: (image_padded, start_y, start_x, ly, lx,
    radius, groups, ps, r_max)."""
    table = BADTable(load_bad_params(512))
    r_max, s = table.max_radius, table.off_y.shape[0]
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (B, H + 2 * r_max, W + 2 * r_max)).astype(np.float32)
    sy = (rng.integers(0, 52, (B, K)) * 8).astype(np.int32)
    sx = rng.integers(0, 560, (B, K)).astype(np.int32)
    ly = rng.uniform(0, _PATCH - 1, (B, K, s)).astype(np.float32)
    lx = rng.uniform(0, _PATCH - 1, (B, K, s)).astype(np.float32)
    tensors = [torch.from_numpy(a).to(device) for a in (img, sy, sx, ly, lx)]
    return (*tensors, table.sample_radius.to(device), table.groups, _PATCH, r_max)


def cuda_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    """Median time of one call, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in a
    CUDA graph, the graph replayed between two CUDA events, the median of
    ``reps`` replays divided by ``launches``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):   # warm-up off the capture, as CUDA graphs require
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, warmup=2, reps=reps) / launches


def run(device: str | torch.device = "cuda") -> list[dict]:
    """Time every variant on the card; returns the JSON lines as dicts."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the sampler ablation times the CUDA kernel: it needs a "
                           "CUDA device")
    args = ablation_inputs(device)
    lines = []
    for skip in VARIANTS:
        def call():
            return sparse_sampler.box_sample_ablated(*args, skip=skip)

        line = {"variant": "no_" + "_".join(skip) if skip else "full",
                "ms": cuda_ms(call), "device_ms": graph_ms(call)}
        if skip:
            line["attributed_ms"] = lines[0]["ms"] - line["ms"]
            line["attributed_device_ms"] = lines[0]["device_ms"] - line["device_ms"]
        else:
            line["s_axis"] = args[3].shape[-1]
        lines.append(line)
    return lines


def main() -> int:
    for line in run():
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
