"""Device times of the Sinkhorn and sampler kernels at the paths' shapes.

    python -m onnx_image_processing_tpu_torch.tools.kernel_times          # repo root
    cd OLD_CHECKOUT && PYTHONPATH=. python NEW/onnx_image_processing_tpu_torch/tools/kernel_times.py --label old

The script imports the port by its absolute name, so run as a file with
another checkout on ``PYTHONPATH`` (and that checkout as the working
directory, for its ``chip_smoke.py`` inputs) it times that checkout's
kernels with the same protocol: two trees compared in one call on one card.

Cases (one JSON line each, with the card's name and power limit):
- ``sinkhorn 513`` / ``sinkhorn 1025``: ``sinkhorn_core`` on (1, N+1, N+1)
  log-scores of random unit descriptors (eps 0.05, 20 sweeps), N = 512 (the
  flagship) and 1024 (AKAZE, dense, VO); ``... B=2`` and ``... B=8``: the
  same with B pairs in one call (``ops.sinkhorn_match`` of a batch);
- ``sampler nearest``: the ablation harness's geometry (B=2, K=512, S=805,
  random coordinates; ``tools/ablate_sampler.py``);
- ``sampler dense bilinear``: the dense matcher's inputs on
  ``chip_smoke.py``'s pair (2 x 1024 keypoints, margin 0, bilinear);
- ``oriented dense map``: ``ops.dense_bad`` at 480x640, P=256, with the
  pair's first image's orientation (7 sampler launches).

``device_ms``: a CUDA graph of 20 calls replayed between CUDA events, per
call (``tools/ablate_sampler.py`` ``graph_ms``); ``ms``: CUDA events around
one call, the wrapper's host time included; ``launches``: device kernels
of one call (``torch.profiler``). The dense map is timed by the host clock
around one synchronized call (median of 5 after a warm-up). Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from onnx_image_processing_tpu_torch import models, ops
from onnx_image_processing_tpu_torch.kernels import sinkhorn_kernel, sparse_sampler
from onnx_image_processing_tpu_torch.tools.ablate_sampler import (ablation_inputs, cuda_ms,
                                                                  graph_ms)


def device_launches(fn, calls: int = 3) -> int:
    """Device kernels one call of ``fn`` launches (copies and fills not
    counted): a ``torch.profiler`` trace of ``calls`` calls after a warm-up
    call, divided by ``calls``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    return round(kernels / calls)


def sinkhorn_case(n: int, dev: torch.device, seed: int = 0, b: int = 1):
    """(log_scores, log_mu, log_nu) of ``b`` (n+1) x (n+1) problems."""
    rng = np.random.default_rng(seed)
    d = rng.normal(0, 1, (2, b, n, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d1, d2 = (torch.from_numpy(a).to(dev) for a in d)
    return ops.sinkhorn_inputs(d1, d2, 0.05)


def dense_sampler_args(dev: torch.device):
    """The dense matcher's sampler arguments on ``chip_smoke.py``'s pair."""
    import chip_smoke

    both = torch.cat([torch.from_numpy(a) for a in chip_smoke.bench_pair()]).to(dev)
    table = models.build(chip_smoke.FLAGSHIP, device=dev).table
    cfg = models.get(chip_smoke.DENSE).defaults
    scores = ops.shi_tomasi_score(both, cfg.block_size)[:, 0].contiguous()
    kpts, _ = ops.nms_select_topk(scores, cfg.max_keypoints, cfg.score_threshold, 0,
                                  nms_radius=cfg.nms_radius)
    return (*ops.box_sample_inputs(both, kpts, table), table.sample_radius, table.groups,
            56, table.max_radius), both[:1]


def timed(label: str, case: str, fn) -> dict:
    return {"tree": label, "case": case, "device_ms": graph_ms(fn), "ms": cuda_ms(fn),
            "launches": device_launches(fn)}


def run(label: str) -> list[dict]:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    dev = torch.device("cuda")
    lines = []
    for b in (1, 2, 8):
        for n in (512, 1024):
            args = sinkhorn_case(n, dev, b=b)
            lines.append(timed(label, f"sinkhorn {n + 1}" + (f" B={b}" if b > 1 else ""),
                               lambda: sinkhorn_kernel.sinkhorn_core(*args, 20)))
    near = ablation_inputs(dev)
    lines.append(timed(label, "sampler nearest", lambda: sparse_sampler.box_sample(*near)))
    dense, img = dense_sampler_args(dev)
    lines.append(timed(label, "sampler dense bilinear",
                       lambda: sparse_sampler.box_sample(*dense, bilinear=True)))
    table = ops.BADTable(ops.load_bad_params(256)).to(dev)
    theta = ops.angle_estimation(img)
    ops.dense_bad(img, table, orientation=theta)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.dense_bad(img, table, orientation=theta)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    lines.append({"tree": label, "case": "oriented dense map", "ms": float(np.median(times))})
    return lines


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="this tree", help="name of the timed tree")
    label = parser.parse_args().label
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for line in run(label):
        print(json.dumps({**line, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
