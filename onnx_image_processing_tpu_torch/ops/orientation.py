"""Intensity-centroid orientation (port of ``onnx_image_processing_tpu/ops/orientation.py``)."""

from __future__ import annotations

import torch

from .filters import conv1d_h, conv1d_w, moment_taps, pad2d


def angle_estimation(image: torch.Tensor, patch_size: int = 15,
                     sigma: float = 2.5) -> torch.Tensor:
    """Per-pixel orientation theta = atan2(m01, m10), (B, 1, H, W) radians."""
    m10, m01 = angle_moments(image, patch_size=patch_size, sigma=sigma)
    return torch.atan2(m01[:, 0], m10[:, 0])[:, None]


def angle_moments(image: torch.Tensor, patch_size: int = 15,
                  sigma: float = 2.5) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian-weighted first moments (m10, m01), each (B, 1, H, W), over a
    zero-padded patch. Sparse pipelines sample these at keypoints and take
    atan2 there instead of over the whole map."""
    if patch_size % 2 == 0:
        raise ValueError(f"patch_size must be odd, got {patch_size}")
    if sigma <= 0:
        raise ValueError(f"sigma must be positive, got {sigma}")
    x = image.to(torch.float32)[:, 0]
    half = patch_size // 2
    g, tg = moment_taps(sigma, patch_size)
    xp = pad2d(x, half, half, mode="zero")
    m10 = conv1d_w(conv1d_h(xp, g), tg)   # x-weighted moment
    m01 = conv1d_w(conv1d_h(xp, tg), g)   # y-weighted moment
    return m10[:, None], m01[:, None]


def angle_estimation_multiscale(image: torch.Tensor, num_scales: int = 3,
                                patch_size: int = 15, sigma: float = 2.5,
                                pooling_factor: int = 2):
    """Multi-scale orientation pyramid, with the reference's contract
    (`orientation/angle_estimation.py:175-295`): scale selection is not
    implemented upstream, so it returns scale 0's orientation and an
    all-zero scale map. Nothing reads the deeper scales (under ``jax.jit``
    the JAX version's are dead code), so they are not built; ``num_scales``
    and ``pooling_factor`` stay for the signature.

    Returns:
        (orientation (B, 1, H, W), scale index (B, 1, H, W) zeros).
    """
    first = angle_estimation(image, patch_size=patch_size, sigma=sigma)
    return first, torch.zeros_like(first)
