"""Shared CLI plumbing of the port: device selection, image loading, timing.

The port's counterpart of ``onnx_image_processing_tpu/cli/common.py``.
``--device {cuda,cpu}`` takes the place of ``--platform``; the JAX compile
cache and the on-device ``lax.scan`` timing chain have no counterpart here
(PyTorch runs eagerly). PIL and OpenCV are imported where they are used, so
importing this module needs neither.
"""

from __future__ import annotations

import argparse
import time

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


def report_benchmark(fn, args) -> None:
    ms = benchmark(fn, args)
    print(f"Elapsed: {ms:.3f} ms/frame ({1e3 / ms:.1f} fps) on {args[0].device}")
