"""Device times of the port's kernels at the paths' shapes.

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
  pair's first image's orientation (7 sampler launches);
- ``select topk flagship`` / ``select topk AKAZE``: ``ops.nms_select_topk``
  (NMS, masks, block top-k and decode) on the pair's Shi-Tomasi scores
  (radius 5, K=512, margin 16) and AKAZE scores (radius 3, K=1024);
- ``akaze ladder B=2`` / ``akaze ladder B=1``: ``kernels.akaze_ladder.akaze_ladder``
  at its defaults on the pair and on its first image (a VO frame);
- ``detect frontend B=2`` / ``... score only``: ``kernels.detect_frontend.detect_frontend``
  at the flagship's settings (block 5, NMS 5, patch 15) on the pair, with
  and without the moments;
- ``score moments B=2`` / ``... B=16`` / ``... B=16 score only``:
  ``kernels.detect_frontend.score_moments`` (the unfused route's unmasked
  score and moments, block 5, patch 15) on the pair and on a served chunk of
  8 pairs (the pair 8 times), each with ``bound_ms``: 16 B a pixel (8 without
  the moments) over 3.35 TB/s or the separately rounded operations over 67
  TFLOP/s, the larger; ``plain stencils B=2`` / ``... B=16``: its plain
  version (``ops.shi_tomasi_score`` and ``ops.angle_moments``) on the same
  stacks; a tree without the pass times the plain stencils alone;
- ``fused detect select B=2`` / ``... B=1``: the fused flagship's detect and
  select (``models.shi_tomasi_family._fused_detect_select``: K=512, margin
  16, with the moments) on the pair and on its first image (a VO frame): one
  ``detect_select`` launch where the tree has it, else the detect frontend
  followed by the plain premasked chain;
- ``min eigvec9 VO`` / ``project essential VO`` / ``essential hypotheses
  S=256``: the essential solve's kernels on what the VO paths give them on
  ``chip_smoke.py``'s VO frames 0-1 (``chip_smoke.essential_inputs``: the
  AKAZE essential pipeline's 9x9 normal matrix and 3x3 E, the RANSAC
  flagship's 256 minimal samples), with the library call beside the first
  two (``eigh ... float64``, ``svd ...``); a tree without these kernels
  skips them.

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
from onnx_image_processing_tpu_torch.kernels import akaze_ladder, sinkhorn_kernel, sparse_sampler
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


def select_and_ladder_cases(dev: torch.device) -> list[tuple[str, object]]:
    """The select top-k and AKAZE ladder calls on ``chip_smoke.py``'s pair."""
    import chip_smoke
    from onnx_image_processing_tpu_torch.models.akaze_family import akaze_detect_cfg

    both = torch.cat([torch.from_numpy(a) for a in chip_smoke.bench_pair()]).to(dev)
    flag = models.build(chip_smoke.FLAGSHIP, device=dev, max_keypoints=chip_smoke.MAX_KEYPOINTS)
    cfg, margin = flag.cfg, flag.table.max_radius
    scores = ops.shi_tomasi_score(both, cfg.block_size)[:, 0].contiguous()
    akaze = models.build(chip_smoke.AKAZE, device=dev)
    acfg = akaze.cfg
    a_scores = akaze_detect_cfg(both, acfg)[0][:, 0].contiguous()
    a_margin = akaze.table.max_radius
    pair = both[:, 0].contiguous()
    frame = pair[:1].contiguous()
    return [
        ("select topk flagship", lambda: ops.nms_select_topk(
            scores, cfg.max_keypoints, cfg.score_threshold, margin, nms_radius=cfg.nms_radius)),
        ("select topk AKAZE", lambda: ops.nms_select_topk(
            a_scores, acfg.max_keypoints, acfg.score_threshold, a_margin,
            nms_radius=acfg.nms_radius)),
        ("akaze ladder B=2", lambda: akaze_ladder.akaze_ladder(pair)),
        ("akaze ladder B=1", lambda: akaze_ladder.akaze_ladder(frame)),
    ]


def detect_cases(dev: torch.device) -> list[tuple[str, object]]:
    """The detect frontend and the fused detect + select on ``chip_smoke.py``'s pair."""
    import chip_smoke
    from onnx_image_processing_tpu_torch.kernels import detect_frontend
    from onnx_image_processing_tpu_torch.models.shi_tomasi_family import _fused_detect_select

    both = torch.cat([torch.from_numpy(a) for a in chip_smoke.bench_pair()]).to(dev)
    frame = both[:1].contiguous()
    fused = models.build(chip_smoke.FLAGSHIP, device=dev, max_keypoints=chip_smoke.MAX_KEYPOINTS,
                         fused_detect=True)
    cfg, margin = fused.cfg, fused.table.max_radius
    args = (cfg.block_size, cfg.patch_size, cfg.sigma, cfg.nms_radius)
    return [
        ("detect frontend B=2", lambda: detect_frontend.detect_frontend(both, *args)),
        ("detect frontend B=2 score only",
         lambda: detect_frontend.detect_frontend(both, *args, with_angle=False)),
        ("fused detect select B=2", lambda: _fused_detect_select(both, cfg, margin, True)),
        ("fused detect select B=1", lambda: _fused_detect_select(frame, cfg, margin, True)),
    ]


def score_moments_cases(dev: torch.device) -> list[tuple[str, object, float | None]]:
    """The unmasked detect pass and the plain stencils it replaces, with
    the pass's bound in ms (None for the stencils)."""
    import chip_smoke
    from onnx_image_processing_tpu_torch.kernels import detect_frontend

    both = torch.cat([torch.from_numpy(a) for a in chip_smoke.bench_pair()]).to(dev)
    chunk = both.repeat(8, 1, 1, 1)
    cfg = models.get(chip_smoke.FLAGSHIP).defaults
    args = (cfg.block_size, cfg.patch_size, cfg.sigma)

    def plain(x):
        return ops.shi_tomasi_score(x, cfg.block_size), ops.angle_moments(x, *args[1:])

    def bound_ms(x, with_angle):
        # Per pixel: two separable Sobel derivatives (24), three products,
        # three separable box sums (6 b), the score (8), two separable
        # moments (8 p); the image in, the score and the moments out.
        ops_px = 24 + 3 + 6 * cfg.block_size + 8 + (8 * cfg.patch_size if with_angle else 0)
        return 1e3 * max((16 if with_angle else 8) * x.numel() / 3.35e12,
                         ops_px * x.numel() / 67e12)

    cases = [("plain stencils B=2", lambda: plain(both), None),
             ("plain stencils B=16", lambda: plain(chunk), None)]
    if not hasattr(detect_frontend, "score_moments"):
        return cases
    return cases + [
        ("score moments B=2", lambda: detect_frontend.score_moments(both, *args),
         bound_ms(both, True)),
        ("score moments B=16", lambda: detect_frontend.score_moments(chunk, *args),
         bound_ms(chunk, True)),
        ("score moments B=16 score only",
         lambda: detect_frontend.score_moments(chunk, *args, with_angle=False),
         bound_ms(chunk, False)),
    ]


def essential_cases(dev: torch.device) -> list[tuple[str, object, bool]]:
    """The essential solve's kernels and library calls (flagged True) on
    the VO inputs; none on a tree without the kernels."""
    import chip_smoke
    try:
        from onnx_image_processing_tpu_torch.kernels import essential_solve as es
    except ImportError:
        return []
    seen = chip_smoke.essential_inputs(dev)
    (m,), (e,) = seen["min_eigvec9"][0], seen["project_essential"][0]
    m, e, m64 = m[None].contiguous(), e[None].contiguous(), m[None].double()
    hyp = seen["essential_hypotheses"][0]
    return [
        ("min eigvec9 VO", lambda: es.min_eigvec9(m), False),
        ("eigh VO float64", lambda: torch.linalg.eigh(m64), True),
        ("project essential VO", lambda: es.project_essential(e), False),
        ("svd VO", lambda: torch.linalg.svd(e), True),
        ("essential hypotheses S=256", lambda: es.essential_hypotheses(*hyp), False),
    ]


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
    for case, fn in select_and_ladder_cases(dev) + detect_cases(dev):
        lines.append(timed(label, case, fn))
    for case, fn, bound in score_moments_cases(dev):
        lines.append(timed(label, case, fn) if bound is None
                     else {**timed(label, case, fn), "bound_ms": bound})
    for case, fn, library in essential_cases(dev):
        # cuSOLVER's eigh and svd read a status on the host: no CUDA graph.
        lines.append({"tree": label, "case": case, "ms": cuda_ms(fn),
                      "launches": device_launches(fn)} if library else timed(label, case, fn))
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
