"""Launches, device time and busy share per pair of the port's three paths
on one GPU, with the unprofiled ms per pair beside them.

    python -m onnx_image_processing_tpu_torch.tools.profile_paths   # repo root

Each path (the flagship, the flagship with ``fused_detect=True``, the AKAZE
matcher; ``chip_smoke.py``'s pair and settings) is timed unprofiled (median
of 20 synchronized calls after 5 warm-up calls), then traced with
``torch.profiler`` over 10 calls. Each traced call is one ``pair`` range
that ends in a synchronize, so the range spans the call's device work. The
busy share is the union of device intervals (kernels and copies) inside
those ranges over the ranges' summed length: device time and wall time come
from the one traced window. The paths run in order, then in reverse order,
so a drift of the host shows as a difference between the two passes. One
JSON line per path and pass.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

PATHS = {
    "flagship": ("shi_tomasi_angle_sparse_bad_sinkhorn", dict(max_keypoints=512)),
    "fused": ("shi_tomasi_angle_sparse_bad_sinkhorn", dict(max_keypoints=512, fused_detect=True)),
    "AKAZE": ("akaze_sparse_bad_sinkhorn", {}),
}
TRACED = 10


def _union_within(intervals, windows) -> float:
    """Length of the union of ``intervals`` clipped to ``windows`` (us)."""
    total = 0.0
    for w0, w1 in windows:
        spans = sorted((max(a, w0), min(b, w1)) for a, b in intervals if b > w0 and a < w1)
        end = w0
        for a, b in spans:
            if b > end:
                total += b - max(a, end)
                end = b
    return total


def profile_path(fn, pair) -> dict:
    for _ in range(5):
        fn(*pair)
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        fn(*pair)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED):
            with record_function("pair"):
                fn(*pair)
                torch.cuda.synchronize()
    events = prof.events()
    windows = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == "pair" and e.device_type == DeviceType.CPU]
    # The range's own mirror on the device timeline is an annotation, not work.
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name != "pair"]
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    busy_us = _union_within([(e.time_range.start, e.time_range.end) for e in device], windows)
    window_us = sum(b - a for a, b in windows)
    by_name: dict[str, list] = {}
    for e in kernels:
        n = by_name.setdefault(e.name[:60], [0, 0.0])
        n[0] += 1
        n[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "ms_per_pair": float(np.median(times)),
        "kernels_per_pair": len(kernels) / TRACED,
        "copies_per_pair": (len(device) - len(kernels)) / TRACED,
        "device_ms_per_pair": sum(e.time_range.elapsed_us() for e in device) / 1e3 / TRACED,
        "traced_ms_per_pair": window_us / 1e3 / TRACED,
        "busy_share": busy_us / window_us,
        "top_kernels_per_pair": {k: {"launches": v[0] / TRACED, "us": v[1] / TRACED}
                                 for k, v in top},
    }


def main() -> None:
    import chip_smoke  # the repo root's smoke script: its pair and its card line
    from onnx_image_processing_tpu_torch import models

    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    pair = tuple(torch.from_numpy(a).to(dev) for a in chip_smoke.bench_pair())
    for rep, order in enumerate((list(PATHS), list(reversed(PATHS)))):
        for label in order:
            name, kw = PATHS[label]
            fn = models.build(name + "_extraction", max_matches=chip_smoke.MAX_MATCHES,
                              device=dev, **kw)
            print(label, f"pass{rep}", json.dumps(profile_path(fn, pair)), flush=True)


if __name__ == "__main__":
    main()
