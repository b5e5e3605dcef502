"""Single-image feature detection CLI of the port.

    python -m onnx_image_processing_tpu_torch.cli.feature_detection -i img.png --device cuda

Port of ``onnx_image_processing_tpu/cli/feature_detection.py``, with the same
flags (``--device {cuda,cpu}`` in place of ``--platform``):
run a detector pipeline on the device, select keypoints on the host (NMS,
threshold, top-k, sub-pixel parabola refinement) and draw them. The device
part is :func:`detect`, which takes and returns arrays; image reading and
drawing (PIL) stay in :func:`main`. As the JAX CLI calls its jitted
``build``, :func:`main` calls ``models.jit(models.build(...))``: one CUDA
graph per call on the card.
"""

from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from .. import models
from ..utils import select_keypoints, visualize_keypoints
from .common import (add_device_arg, add_timing_arg, load_image, run_benchmark,
                     select_device)

# Detector hyperparameter flags, passed as flat config overrides.
_DETECTOR_FLAGS = ("fast_threshold", "fast_use_nms", "fast_nms_radius",
                   "dog_num_scales", "dog_sigma_base", "dog_sigma_ratio",
                   "dog_kernel_size", "akaze_threshold", "akaze_kappa",
                   "akaze_num_scales", "akaze_diffusion_iterations")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="feature detection on the PyTorch port")
    p.add_argument("--model", "-m", default="shi_tomasi",
                   help=f"pipeline name; one of {models.names()}")
    p.add_argument("--image", "-i", required=True, help="input image path")
    p.add_argument("--output", "-o", default="keypoints.png",
                   help="output visualization path")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--threshold", "-t", type=float, default=0.01,
                   help="minimum keypoint score")
    p.add_argument("--max-keypoints", "-k", type=int, default=1000)
    p.add_argument("--nms-radius", type=int, default=3)
    p.add_argument("--no-subpixel", action="store_true",
                   help="disable sub-pixel parabola refinement")
    p.add_argument("--circle-radius", type=int, default=3,
                   help="keypoint circle radius in the visualization")
    p.add_argument("--colorize", action="store_true",
                   help="color keypoints by score (blue=low, red=high)")
    p.add_argument("--benchmark", action="store_true",
                   help="print warmup+timed ms/frame")
    add_timing_arg(p)
    g = p.add_argument_group("detector hyperparameters")
    g.add_argument("--fast-threshold", type=float, default=None,
                   help="FAST intensity threshold (default 20)")
    g.add_argument("--fast-use-nms", action="store_const", const=True, default=None)
    g.add_argument("--fast-nms-radius", type=int, default=None)
    g.add_argument("--dog-num-scales", type=int, default=None)
    g.add_argument("--dog-sigma-base", type=float, default=None)
    g.add_argument("--dog-sigma-ratio", type=float, default=None)
    g.add_argument("--dog-kernel-size", type=int, default=None)
    g.add_argument("--akaze-threshold", type=float, default=None)
    g.add_argument("--akaze-kappa", type=float, default=None)
    g.add_argument("--akaze-num-scales", type=int, default=None)
    g.add_argument("--akaze-diffusion-iterations", type=int, default=None)
    add_device_arg(p)
    return p.parse_args(argv)


def detector_overrides(args) -> dict:
    """Non-None detector flags as flat config overrides (fast_*/dog_*/akaze_*)."""
    return {k: getattr(args, k) for k in _DETECTOR_FLAGS if getattr(args, k) is not None}


def detect(fn: Callable, image: np.ndarray) -> np.ndarray:
    """The detector ``fn``'s score map (its first output) for a (1, 1, H, W)
    float32 image, computed on ``fn``'s device (a module of
    ``models.build`` or its ``models.jit``), as numpy."""
    with torch.inference_mode():
        out = fn(torch.from_numpy(image).to(fn.device))
    scores = out[0] if isinstance(out, (tuple, list)) else out
    return scores.cpu().numpy()


def main(argv=None):
    args = parse_args(argv)
    device = select_device(args.device)
    arr, rgb = load_image(args.image, args.height, args.width)
    fn = models.jit(models.build(args.model, device=device, **detector_overrides(args)))
    scores = detect(fn, arr)
    if args.benchmark:
        with torch.inference_mode():
            run_benchmark(fn, (torch.from_numpy(arr).to(device),), args.timing)

    kpts = select_keypoints(scores, threshold=args.threshold,
                            max_keypoints=args.max_keypoints,
                            nms_radius=args.nms_radius,
                            subpixel=not args.no_subpixel)
    print(f"Detected {len(kpts)} keypoints "
          f"(model={args.model}, threshold={args.threshold})")
    if len(kpts):
        print(f"Score range: [{kpts[:, 2].min():.4f}, {kpts[:, 2].max():.4f}]")

    vis = visualize_keypoints(rgb, kpts, radius=args.circle_radius,
                              colorize_by_score=args.colorize)
    vis.save(args.output)
    print(f"Saved visualization to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
