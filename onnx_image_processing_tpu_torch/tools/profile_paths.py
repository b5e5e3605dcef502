"""Launches, device time and busy share per call of the port's two-image
paths (a call: one pair) and of its VO paths (a call: one frame, or its
extract, or its essential solve) on one GPU, with the unprofiled ms per
call beside them.

    python -m onnx_image_processing_tpu_torch.tools.profile_paths   # repo root

Each two-image path (the flagship, the flagship with ``fused_detect=True``,
the AKAZE matcher, the dense matcher; ``chip_smoke.py``'s pair and settings)
is one call on the pair. The single-image heads ``fast`` and
``dog_with_score`` are one call on the pair (B = 2), ``voxel_downsampling``
one call on 38,400 points in [-3, 3]^3 (leaf 0.05), and ``served chunk 4``
one call of ``models.build_batched`` on 4 stacked pairs (the flagship at 512
keypoints, the inputs already on the card; a call: one chunk). Each VO path (the AKAZE essential pipeline at its registry defaults,
the flagship essential pipeline with 256 RANSAC hypotheses; phase 7 of
``chip_smoke.py``) is profiled three ways: one VO frame (extract the new
frame, match it against cached reference features, one host copy of the
outputs), its extract alone, and its essential solve alone. Each is timed
unprofiled (median of 20 synchronized calls after 5 warm-up calls), then
traced with ``torch.profiler`` over 10 calls. Each traced call is one ``call`` range
that ends in a synchronize, so the range spans the call's device work. The
busy share is the union of device intervals (kernels and copies) inside
those ranges over the ranges' summed length: device time and wall time come
from the one traced window. ``host_syncs_per_call`` counts the synchronizing
CUDA calls of one call (PyTorch's sync debug mode warns at each): a VO
frame's host copy of its outputs, and nothing in the essential solve, whose
``eigh``, ``svd`` and hypothesis solve are kernels that read nothing on the
host. The paths run in order, then in reverse order,
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
    "dense": ("shi_tomasi_bad_sinkhorn", {}),
}
VO_PATHS = {
    "VO AKAZE": ("akaze_sparse_bad_sinkhorn_essential_matrix", {}),
    "VO RANSAC": ("shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix",
                  dict(essential_ransac_hypotheses=256, essential_irls_iters=2)),
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


def host_syncs(step) -> int:
    """Synchronizing CUDA calls made by one call of ``step``."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def profile_path(step) -> dict:
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED):
            with record_function("call"):
                step()
                torch.cuda.synchronize()
    events = prof.events()
    windows = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == "call" and e.device_type == DeviceType.CPU]
    # The range's own mirror on the device timeline is an annotation, not work.
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name != "call"]
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
        "ms_per_call": float(np.median(times)),
        "kernels_per_call": len(kernels) / TRACED,
        "copies_per_call": (len(device) - len(kernels)) / TRACED,
        "device_ms_per_call": sum(e.time_range.elapsed_us() for e in device) / 1e3 / TRACED,
        "traced_ms_per_call": window_us / 1e3 / TRACED,
        "busy_share": busy_us / window_us,
        "host_syncs_per_call": host_syncs(step),
        "top_kernels_per_call": {k: {"launches": v[0] / TRACED, "us": v[1] / TRACED}
                                 for k, v in top},
    }


def vo_steps(name: str, overrides: dict, dev: torch.device) -> dict:
    """Callables of one VO frame of ``name``'s streaming split on
    ``chip_smoke.py``'s frames 0 and 1: the whole frame as the VO loop runs
    it (extract the new frame, match it against cached reference features,
    one host copy), the extract alone, and the essential solve alone on the
    frame's cached keypoints, scores and P."""
    import chip_smoke
    from onnx_image_processing_tpu_torch import models
    from onnx_image_processing_tpu_torch.cli.visual_odometry import to_host
    from onnx_image_processing_tpu_torch.models.essential_family import essential_from_match

    f0, f1 = (torch.from_numpy(f).to(dev) for f in chip_smoke.vo_sequence()[:2])
    fx, h, w = 0.8 * chip_smoke.W, chip_smoke.H, chip_smoke.W
    k_inv = torch.from_numpy(np.linalg.inv(np.array(
        [[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])).astype(np.float32)).to(dev)
    extract, match = models.build_streaming(
        name + "_extraction", device=dev, max_matches=chip_smoke.VO_MAX_MATCHES,
        match_threshold=chip_smoke.VO_MATCH_THRESHOLD, **overrides)
    ref, cur = extract(f0), extract(f1)
    k1, k2, p, _ = match.matcher.tail(ref, cur, k_inv)
    return {
        "frame": lambda: to_host(match(ref, extract(f1), k_inv)),
        "extract": lambda: extract(f1),
        "solve": lambda: essential_from_match(k1, ref[1], k2, cur[1], p, k_inv, match.cfg),
    }


def aux_steps(dev: torch.device, pair) -> dict:
    """Callables of the heads without a matcher and of one served chunk."""
    import chip_smoke
    from onnx_image_processing_tpu_torch import models

    both = torch.cat(pair)
    steps = {name: (lambda fn=models.build(name, device=dev): fn(both))
             for name in ("fast", "dog_with_score")}
    pts = torch.from_numpy(np.random.default_rng(3).uniform(-3, 3, (38400, 3))
                           .astype(np.float32)).to(dev)
    leaf = torch.tensor(np.float32(chip_smoke.VOXEL_LEAF), device=dev)
    voxel = models.build("voxel_downsampling", device=dev)
    steps["voxel_downsampling"] = lambda: voxel(pts, leaf)
    fb = models.build_batched(PATHS["flagship"][0], device=dev, **PATHS["flagship"][1])
    a4, b4 = (torch.from_numpy(np.concatenate([chip_smoke.texture_pair(100 + i)[side]
                                               for i in range(4)])).to(dev) for side in (0, 1))
    steps["served chunk 4"] = lambda: fb(a4, b4)
    return steps


def main() -> None:
    import chip_smoke  # the repo root's smoke script: its inputs and its card line
    from onnx_image_processing_tpu_torch import models

    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    pair = tuple(torch.from_numpy(a).to(dev) for a in chip_smoke.bench_pair())
    steps = {}
    for label, (name, kw) in PATHS.items():
        fn = models.build(name + "_extraction", max_matches=chip_smoke.MAX_MATCHES,
                          device=dev, **kw)
        steps[label] = lambda fn=fn: fn(*pair)
    for label, (name, kw) in VO_PATHS.items():
        for part, step in vo_steps(name, kw, dev).items():
            steps[f"{label} {part}"] = step
    steps.update(aux_steps(dev, pair))
    for rep, order in enumerate((list(steps), list(reversed(steps)))):
        for label in order:
            print(label, f"pass{rep}", json.dumps(profile_path(steps[label])), flush=True)


if __name__ == "__main__":
    main()
