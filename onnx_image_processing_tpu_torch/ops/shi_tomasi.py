"""Shi-Tomasi corner score (port of ``onnx_image_processing_tpu/ops/shi_tomasi.py``)."""

from __future__ import annotations

import numpy as np
import torch

from .filters import conv1d_h, conv1d_w, pad2d

_SMOOTH = np.array([1.0, 2.0, 1.0], dtype=np.float32)
_DIFF = np.array([-1.0, 0.0, 1.0], dtype=np.float32)


def shi_tomasi_score(image: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Per-pixel lambda_min of the 3x3 Sobel structure tensor.

    Args:
        image: (B, 1, H, W) grayscale image.
        block_size: structure-tensor window (odd, > 0).

    Returns:
        (B, 1, H, W) score map, clamped to >= 0. Replicate-padded Sobel and
        box sums, closed-form lambda_min with the 1e-10 term, in the JAX
        package's tap order.
    """
    if block_size <= 0 or block_size % 2 == 0:
        raise ValueError(f"block_size must be a positive odd integer, got {block_size}")
    x = image.to(torch.float32)[:, 0]
    xp = pad2d(x, 1, 1, mode="edge")
    ix = conv1d_w(conv1d_h(xp, _SMOOTH), _DIFF)
    iy = conv1d_w(conv1d_h(xp, _DIFF), _SMOOTH)

    r = block_size // 2
    ones = np.ones(block_size, dtype=np.float32)

    def bsum(v):
        return conv1d_w(conv1d_h(pad2d(v, r, r, mode="edge"), ones), ones)

    sxx = bsum(ix * ix)
    syy = bsum(iy * iy)
    sxy = bsum(ix * iy)

    half_trace = (sxx + syy) * 0.5
    diff_half = (sxx - syy) * 0.5
    disc = diff_half * diff_half + sxy * sxy
    lam_min = half_trace - torch.sqrt(disc + 1e-10)
    return torch.clamp_min(lam_min, 0.0)[:, None]
