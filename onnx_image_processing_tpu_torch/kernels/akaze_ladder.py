"""AKAZE scale ladder: FED diffusion, Hessian NMS score and orientation
moments of every scale.

Port of ``onnx_image_processing_tpu/kernels/akaze_ladder.py``
(``akaze_ladder``). On a CUDA tensor :func:`akaze_ladder` launches
``csrc/akaze_ladder.cu``; on a CPU tensor it runs :func:`akaze_ladder_plain`,
the port of ``akaze_ladder_reference``, built from ``ops/akaze.py``. The
kernel rounds every multiply and add on its own, in the plain version's
order, so on the card the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LaunchCounter, _build, use_kernel
from ..ops.akaze import hessian_score, nonlinear_diffusion
from ..ops.filters import moment_taps
from ..ops.orientation import angle_moments

LAUNCHES = LaunchCounter("akaze_ladder")
MAX_RADIUS = 15  # the kernel's tiles fit an NMS radius and moment half-width up to 15


def akaze_ladder_plain(image: torch.Tensor, num_scales: int = 3,
                       diffusion_iterations: int = 3, kappa: float = 0.05,
                       threshold: float = 0.001, nms_size: int = 5,
                       orientation_patch_size: int = 15,
                       orientation_sigma: float = 2.5):
    """Plain PyTorch version of the kernel: same contract."""
    current = image.to(torch.float32)[:, None]
    scores, m10s, m01s = [], [], []
    for _ in range(num_scales):
        current = nonlinear_diffusion(current, num_iterations=diffusion_iterations,
                                      kappa=kappa)
        scores.append(hessian_score(current, threshold=threshold,
                                    nms_size=nms_size)[:, 0])
        m10, m01 = angle_moments(current, orientation_patch_size, orientation_sigma)
        m10s.append(m10[:, 0])
        m01s.append(m01[:, 0])
    return (torch.stack(scores, 1), torch.stack(m10s, 1), torch.stack(m01s, 1))


def akaze_ladder(image: torch.Tensor, num_scales: int = 3,
                 diffusion_iterations: int = 3, kappa: float = 0.05,
                 threshold: float = 0.001, nms_size: int = 5,
                 orientation_patch_size: int = 15,
                 orientation_sigma: float = 2.5):
    """Per-scale AKAZE maps. The diffusion state carries from one scale to
    the next: scale s is ``diffusion_iterations`` FED steps after scale s-1.

    Args:
        image: (B, H, W) float32.

    Returns:
        ``(scores, m10, m01)``, each (B, num_scales, H, W): the thresholded
        Hessian NMS score and the Gaussian orientation moments of every
        scale; the angle is atan2(m01, m10), taken by the caller.
    """
    if not use_kernel(image):
        return akaze_ladder_plain(image, num_scales, diffusion_iterations, kappa,
                                  threshold, nms_size, orientation_patch_size,
                                  orientation_sigma)
    if image.dtype != torch.float32 or image.dim() != 3:
        raise ValueError(f"image must be (B, H, W) float32, got "
                         f"{tuple(image.shape)} {image.dtype}")
    if not image.is_contiguous():
        raise ValueError("image must be contiguous")
    if num_scales < 1 or diffusion_iterations < 0:
        raise ValueError(f"need num_scales >= 1 and diffusion_iterations >= 0, "
                         f"got {num_scales}, {diffusion_iterations}")
    if orientation_patch_size % 2 == 0 or orientation_sigma <= 0:
        raise ValueError("orientation_patch_size must be odd and sigma positive")
    nms_radius, half = nms_size // 2, orientation_patch_size // 2
    if nms_radius > MAX_RADIUS or half > MAX_RADIUS:
        raise ValueError(f"nms_size // 2 and orientation_patch_size // 2 must be "
                         f"<= {MAX_RADIUS}, got {nms_radius}, {half}")
    b, h, w = image.shape
    dev = image.device
    scores, m10, m01 = (torch.empty((b, num_scales, h, w), dtype=torch.float32,
                                    device=dev) for _ in range(3))
    state = torch.empty((2, b, h, w), dtype=torch.float32, device=dev)
    taps = _build.constant(np.concatenate(moment_taps(orientation_sigma,
                                                      orientation_patch_size)), dev)
    fn = _build.entry("oip_akaze_ladder", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
    err = fn(_build.ptr(image), _build.ptr(taps), _build.ptr(state[0]),
             _build.ptr(state[1]), _build.ptr(scores), _build.ptr(m10),
             _build.ptr(m01), b, h, w, int(num_scales), int(diffusion_iterations),
             float(np.float32(1.0 / (kappa * kappa))), float(threshold),
             nms_radius, half, _build.stream(image))
    _build.check(err, "akaze_ladder launch")
    LAUNCHES.count += 1
    return scores, m10, m01
