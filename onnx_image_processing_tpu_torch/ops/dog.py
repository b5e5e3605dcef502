"""Difference-of-Gaussians detector (port of ``onnx_image_processing_tpu/ops/dog.py``).

Each scale is two 1-D passes (shift-and-add, ``conv1d_h`` then
``conv1d_w``) over one shared edge-padded slab; all scales share one kernel
size. Not ``F.conv2d``: cuDNN runs float32 convolutions in TF32 on Hopper.
At the defaults (5 scales, 39 taps) a call is ~800 elementwise launches on
the card, so it is bound by launches, not by the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .filters import conv1d_h, conv1d_w, pad2d


def _dog_sigmas(num_scales: int, sigma_base: float, sigma_ratio: float):
    return [sigma_base * (sigma_ratio ** i) for i in range(num_scales)]


def _dog_kernel_size(sigmas, kernel_size: int | None) -> int:
    if kernel_size is None:
        kernel_size = int(6 * sigmas[-1] + 1)
        if kernel_size % 2 == 0:
            kernel_size += 1
    if kernel_size % 2 == 0:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    return kernel_size


def dog_responses(image: torch.Tensor, num_scales: int = 5, sigma_base: float = 1.6,
                  sigma_ratio: float = math.sqrt(2),
                  kernel_size: int | None = None) -> torch.Tensor:
    """DoG bands: consecutive differences of a Gaussian pyramid whose taps
    are normalized per axis in float32, as in the JAX package.

    Args:
        image: (B, 1, H, W) grayscale.

    Returns:
        (B, num_scales - 1, H, W) bands.
    """
    if num_scales < 2:
        raise ValueError(f"num_scales must be at least 2, got {num_scales}")
    sigmas = _dog_sigmas(num_scales, sigma_base, sigma_ratio)
    k = _dog_kernel_size(sigmas, kernel_size)
    half = k // 2
    xp = pad2d(image.to(torch.float32)[:, 0], half, half, mode="edge")
    t = np.arange(-half, half + 1, dtype=np.float32)
    levels = []
    for sigma in sigmas:
        g = np.exp(-(t ** 2) / (2.0 * sigma ** 2)).astype(np.float32)
        g = g / g.sum()
        levels.append(conv1d_w(conv1d_h(xp, g), g))
    pyr = torch.stack(levels, dim=1)
    return pyr[:, 1:] - pyr[:, :-1]


def dog_score(image: torch.Tensor, num_scales: int = 5, sigma_base: float = 1.6,
              sigma_ratio: float = math.sqrt(2),
              kernel_size: int | None = None) -> torch.Tensor:
    """Max |DoG| over the bands, (B, 1, H, W)."""
    bands = dog_responses(image, num_scales=num_scales, sigma_base=sigma_base,
                          sigma_ratio=sigma_ratio, kernel_size=kernel_size)
    return bands.abs().amax(dim=1, keepdim=True)
