"""Two-image matching CLI of the port for ``*_extraction`` pipelines, whose
mutual-NN match extraction runs on the device.

    python -m onnx_image_processing_tpu_torch.cli.image_matching_extraction -i1 a.png -i2 b.png

Port of ``onnx_image_processing_tpu/cli/image_matching_extraction.py``, with
the same flags (``--device {cuda,cpu}`` in place of ``--platform``): the
pipeline returns fixed-size matched pairs; the host keeps the valid ones
and draws them. The device part is :func:`match`, which takes and returns
arrays; image reading and drawing (PIL) stay in :func:`main`. As the JAX
CLI calls its jitted ``build``, :func:`main` calls
``models.jit(models.build(...))``: one CUDA graph per call on the card.
"""

from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from .. import models
from ..utils import visualize_matches
from .common import (add_device_arg, add_timing_arg, load_image, run_benchmark,
                     select_device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="two-image matching on the PyTorch port (match extraction on the device)")
    p.add_argument("--model", "-m",
                   default="shi_tomasi_angle_sparse_bad_sinkhorn_extraction",
                   help="extraction pipeline name (must end in _extraction)")
    p.add_argument("--image1", "-i1", required=True)
    p.add_argument("--image2", "-i2", required=True)
    p.add_argument("--output", "-o", default="matches.png")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--max-matches", type=int, default=None,
                   help="override pipeline max matches")
    p.add_argument("--topk-mode", choices=["block", "sort", "approx"], default=None,
                   help="keypoint selection: block (default), sort (reference-exact "
                        "ties), approx (approximate on a TPU only: selects as block here)")
    p.add_argument("--match-threshold", "-t", type=float, default=None)
    p.add_argument("--no-benchmark", action="store_true")
    add_timing_arg(p)
    p.add_argument("--colorize", action="store_true",
                   help="color match lines by confidence (blue=low, red=high)")
    add_device_arg(p)
    return p.parse_args(argv)


def match(fn: Callable, image1: np.ndarray, image2: np.ndarray):
    """The valid matches of the extraction pipeline ``fn`` (a module of
    ``models.build`` or its ``models.jit``) for two (1, 1, H, W) float32
    images, computed on ``fn``'s device: matched keypoints in image 1 and
    image 2, (N, 2) each, and their scores (N,), as numpy."""
    with torch.inference_mode():
        out = fn(torch.from_numpy(image1).to(fn.device),
                 torch.from_numpy(image2).to(fn.device))
    mk1, mk2, scores, valid = (t.cpu().numpy() for t in out[:4])
    keep = valid[0]
    return mk1[0][keep], mk2[0][keep], scores[0][keep]


def main(argv=None):
    args = parse_args(argv)
    device = select_device(args.device)
    arr1, rgb1 = load_image(args.image1, args.height, args.width)
    arr2, rgb2 = load_image(args.image2, args.height, args.width)

    overrides = {}
    if args.max_matches is not None:
        overrides["max_matches"] = args.max_matches
    if args.match_threshold is not None:
        overrides["match_threshold"] = args.match_threshold
    if args.topk_mode is not None:
        overrides["topk_mode"] = args.topk_mode
    fn = models.jit(models.build(args.model, device=device, **overrides))
    mk1, mk2, scores = match(fn, arr1, arr2)
    if not args.no_benchmark:
        with torch.inference_mode():
            run_benchmark(fn, (torch.from_numpy(arr1).to(device),
                               torch.from_numpy(arr2).to(device)), args.timing)
    print(f"Matches: {len(mk1)}")

    vis = visualize_matches(rgb1, rgb2, mk1, mk2, scores,
                            colorize_by_score=args.colorize)
    vis.save(args.output)
    print(f"Saved visualization to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
