"""Two-image matching CLI of the port, with a built-in benchmark.

    python -m onnx_image_processing_tpu_torch.cli.image_matching -i1 a.png -i2 b.png --device cuda

Port of ``onnx_image_processing_tpu/cli/image_matching.py``, with the same
flags (``--device {cuda,cpu}`` in place of ``--platform``):
run a matcher pipeline on the device, extract mutual-NN matches on the host
and draw them side by side. The device part is :func:`match`, which takes
and returns arrays; image reading and drawing (PIL) stay in :func:`main`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from .. import models
from ..utils import extract_matches, visualize_matches
from .common import (add_device_arg, add_timing_arg, load_image, run_benchmark,
                     select_device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="two-image matching on the PyTorch port")
    p.add_argument("--model", "-m", default="shi_tomasi_angle_sparse_bad_sinkhorn",
                   help=f"matcher pipeline name; one of {models.names()}")
    p.add_argument("--image1", "-i1", required=True)
    p.add_argument("--image2", "-i2", required=True)
    p.add_argument("--output", "-o", default="matches.png")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--max-keypoints", "-k", type=int, default=None,
                   help="override pipeline max keypoints")
    p.add_argument("--topk-mode", choices=["block", "sort", "approx"], default=None,
                   help="keypoint selection: block (default), sort (reference-exact "
                        "ties), approx (approximate on a TPU only: selects as block here)")
    p.add_argument("--match-threshold", "-t", type=float, default=0.1)
    p.add_argument("--max-matches", type=int, default=100)
    p.add_argument("--no-benchmark", action="store_true")
    add_timing_arg(p)
    p.add_argument("--colorize", action="store_true",
                   help="color match lines by confidence (blue=low, red=high)")
    add_device_arg(p)
    return p.parse_args(argv)


def match(fn: nn.Module, image1: np.ndarray, image2: np.ndarray):
    """The matcher ``fn``'s keypoints1, keypoints2 and P for two (1, 1, H, W)
    float32 images, computed on ``fn``'s device, as numpy."""
    with torch.inference_mode():
        out = fn(torch.from_numpy(image1).to(fn.device),
                 torch.from_numpy(image2).to(fn.device))
    return tuple(t.cpu().numpy() for t in out[:3])


def main(argv=None):
    args = parse_args(argv)
    device = select_device(args.device)
    arr1, rgb1 = load_image(args.image1, args.height, args.width)
    arr2, rgb2 = load_image(args.image2, args.height, args.width)

    overrides = {}
    if args.max_keypoints is not None:
        overrides["max_keypoints"] = args.max_keypoints
    if args.topk_mode is not None:
        overrides["topk_mode"] = args.topk_mode
    fn = models.build(args.model, device=device, **overrides)
    k1, k2, p = match(fn, arr1, arr2)
    if not args.no_benchmark:
        with torch.inference_mode():
            run_benchmark(fn, (torch.from_numpy(arr1).to(device),
                               torch.from_numpy(arr2).to(device)), args.timing)

    mk1, mk2, scores = extract_matches(p[None] if p.ndim == 2 else p,
                                       k1, k2, threshold=args.match_threshold,
                                       max_matches=args.max_matches)
    n_valid1 = int((k1[0, :, 0] >= 0).sum())
    n_valid2 = int((k2[0, :, 0] >= 0).sum())
    print(f"Keypoints: {n_valid1} / {n_valid2}")
    print(f"Matches: {len(mk1)} (threshold={args.match_threshold})")

    vis = visualize_matches(rgb1, rgb2, mk1, mk2, scores,
                            colorize_by_score=args.colorize)
    vis.save(args.output)
    print(f"Saved visualization to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
