"""Detect frontend: Shi-Tomasi score, NMS keep mask and orientation moments
in one pass.

Port of ``onnx_image_processing_tpu/kernels/detect_frontend.py``
(``detect_frontend``). On a CUDA tensor :func:`detect_frontend` launches
``csrc/detect_frontend.cu``; on a CPU tensor it runs
:func:`detect_frontend_plain`, the port of ``detect_frontend_reference``.
The TPU kernel's fallback to the XLA composition past its VMEM budget is not
carried over: the CUDA kernel tiles any H x W.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LaunchCounter, _build, use_kernel
from ..ops.filters import moment_taps
from ..ops.keypoints import nms_maxpool
from ..ops.orientation import angle_moments
from ..ops.shi_tomasi import shi_tomasi_score

LAUNCHES = LaunchCounter("detect_frontend")
MAX_RADIUS = 15  # box radius, NMS radius and moment half-width the tiles fit


def detect_frontend_plain(image: torch.Tensor, block_size: int = 3,
                          patch_size: int = 15, sigma: float = 2.5,
                          nms_radius: int = 5, with_angle: bool = True):
    """Plain PyTorch version of the kernel: same contract."""
    scores = shi_tomasi_score(image, block_size=block_size)[:, 0]
    masked = (scores * nms_maxpool(scores, nms_radius))[:, None]
    if not with_angle:
        return masked, None, None
    m10, m01 = angle_moments(image, patch_size=patch_size, sigma=sigma)
    return masked, m10, m01


def detect_frontend(image: torch.Tensor, block_size: int = 3,
                    patch_size: int = 15, sigma: float = 2.5,
                    nms_radius: int = 5, with_angle: bool = True):
    """Shi-Tomasi score times its NMS keep mask, and the orientation moments.

    Args:
        image: (B, 1, H, W) float32.

    Returns:
        ``(masked_score, m10, m01)``, each (B, 1, H, W): ``masked_score`` is
        ``shi_tomasi_score * nms_mask`` (replicate padding for the score, -inf
        outside the image for the NMS window); m10/m01 are the zero-padded
        Gaussian moments whose atan2 at a keypoint is its orientation. m10
        and m01 are None when ``with_angle`` is False.
    """
    if not use_kernel(image):
        return detect_frontend_plain(image, block_size, patch_size, sigma,
                                     nms_radius, with_angle)
    if image.dtype != torch.float32 or image.dim() != 4 or image.shape[1] != 1:
        raise ValueError(f"image must be (B, 1, H, W) float32, got "
                         f"{tuple(image.shape)} {image.dtype}")
    if not image.is_contiguous():
        raise ValueError("image must be contiguous")
    if block_size <= 0 or block_size % 2 == 0 or patch_size % 2 == 0 or sigma <= 0:
        raise ValueError("block_size and patch_size must be odd and positive, "
                         "sigma positive")
    rb, half = block_size // 2, patch_size // 2
    if max(rb, nms_radius, half) > MAX_RADIUS or nms_radius < 0:
        raise ValueError(f"block_size // 2, nms_radius and patch_size // 2 must "
                         f"be in 0..{MAX_RADIUS}, got {rb}, {nms_radius}, {half}")
    b, _, h, w = image.shape
    dev = image.device
    score = torch.empty((b, 1, h, w), dtype=torch.float32, device=dev)
    m10, m01 = ((torch.empty_like(score), torch.empty_like(score))
                if with_angle else (None, None))
    taps = _build.constant(np.concatenate(moment_taps(sigma, patch_size)), dev)
    fn = _build.entry("oip_detect_frontend", [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    # Without the angle the kernel reads no taps and writes no moments (NULL).
    moments = (_build.ptr(m10), _build.ptr(m01)) if with_angle else (None, None)
    err = fn(_build.ptr(image), _build.ptr(taps), _build.ptr(score), *moments,
             b, h, w, rb, int(nms_radius), half, int(with_angle),
             _build.stream(image))
    _build.check(err, "detect_frontend launch")
    LAUNCHES.count += 1
    return score, m10, m01
