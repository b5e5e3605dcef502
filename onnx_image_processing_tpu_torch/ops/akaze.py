"""AKAZE detector: FED nonlinear diffusion, Hessian score, orientation
moments (port of ``onnx_image_processing_tpu/ops/akaze.py``).

Every stencil is the zero-padded separable shift-and-add of
``ops/filters.py`` in the JAX package's tap order: vertical pass, then
horizontal, then ``* scale``, zero taps skipped. The orientation moments
are ``ops/orientation.py`` ``angle_moments`` (zero padding, as here). These
plain functions also make the plain version of the AKAZE ladder kernel
(``kernels/akaze_ladder.py``), which computes the same per-scale maps in
one launch on a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .filters import conv1d_h, conv1d_w, maxpool2d_same, pad2d

# Separable factors of the reference's 3x3 kernels.
_S121 = np.array([1.0, 2.0, 1.0], dtype=np.float32)
_D101 = np.array([-1.0, 0.0, 1.0], dtype=np.float32)   # derivative
_L121 = np.array([1.0, -2.0, 1.0], dtype=np.float32)   # second derivative
_XY = np.array([1.0, 0.0, -1.0], dtype=np.float32)


def _conv3_zero(x: torch.Tensor, col, row, scale: float) -> torch.Tensor:
    """Zero-padded separable 3x3 cross-correlation of (B, H, W)."""
    return conv1d_w(conv1d_h(pad2d(x, 1, 1, mode="zero"), col), row) * scale


def _sobel_x(x: torch.Tensor) -> torch.Tensor:
    return _conv3_zero(x, _S121, _D101, 1.0 / 8.0)


def _sobel_y(x: torch.Tensor) -> torch.Tensor:
    return _conv3_zero(x, _D101, _S121, 1.0 / 8.0)


def nonlinear_diffusion(image: torch.Tensor, num_iterations: int = 3,
                        kappa: float = 0.05) -> torch.Tensor:
    """Perona-Malik g2 diffusion in explicit FED steps with dt = 0.25:
    ``L += dt * div(c(|grad L|) * grad L)``, ``c = 1 / (1 + |grad|^2 / kappa^2)``.

    Args:
        image: (B, 1, H, W).

    Returns:
        (B, 1, H, W) diffused image.
    """
    l = image.to(torch.float32)[:, 0]
    inv_k2 = 1.0 / (kappa * kappa)
    for _ in range(num_iterations):
        gx = _sobel_x(l)
        gy = _sobel_y(l)
        mag2 = gx * gx + gy * gy + 1e-8
        c = 1.0 / (1.0 + mag2 * inv_k2)
        # Each stencil zero-pads its own input: c*gx is 0 outside the image.
        div = _sobel_x(c * gx) + _sobel_y(c * gy)
        l = l + 0.25 * div
    return l[:, None]


def hessian_score(image: torch.Tensor, threshold: float = 0.001,
                  nms_size: int = 5) -> torch.Tensor:
    """det(Hessian) with a zero-padded max-pool equality NMS, the threshold
    mask, and a clamp at 0.

    Args:
        image: (B, 1, H, W), typically a diffused scale.

    Returns:
        (B, 1, H, W) masked score map.
    """
    x = image.to(torch.float32)[:, 0]
    lxx = _conv3_zero(x, _S121, _L121, 1.0 / 16.0)
    lyy = _conv3_zero(x, _L121, _S121, 1.0 / 16.0)
    lxy = _conv3_zero(x, _XY, _XY, 1.0 / 4.0)
    response = lxx * lyy - lxy * lxy
    local_max = maxpool2d_same(response, nms_size // 2, pad_mode="zero")
    mask = (response == local_max) & (response > threshold)
    return torch.clamp_min(response * mask.to(response.dtype), 0.0)[:, None]


def akaze_detect_parts(image: torch.Tensor, num_scales: int = 3,
                       diffusion_iterations: int = 3, kappa: float = 0.05,
                       threshold: float = 0.001, nms_size: int = 5,
                       orientation_patch_size: int = 15,
                       orientation_sigma: float = 2.5):
    """Per-scale AKAZE maps ``(scale_scores, m10, m01)``, each (S, B, H, W).

    On a CUDA tensor this is the AKAZE ladder kernel, on a CPU tensor its
    plain version. The JAX package ties its ladder kernel to
    ``MatcherConfig.fused_detect`` only because that kernel was slower than
    XLA's fusion on its TPU; the two compute the same maps, so the choice is
    a backend knob, and the port decides backend knobs by the tensor's
    device. ``fused_detect`` therefore has no effect on AKAZE here.
    """
    from ..kernels import akaze_ladder  # the kernel's plain version is built from this module

    scores, m10, m01 = akaze_ladder.akaze_ladder(
        image.to(torch.float32)[:, 0], num_scales=num_scales,
        diffusion_iterations=diffusion_iterations, kappa=kappa,
        threshold=threshold, nms_size=nms_size,
        orientation_patch_size=orientation_patch_size,
        orientation_sigma=orientation_sigma)
    return scores.transpose(0, 1), m10.transpose(0, 1), m01.transpose(0, 1)


def _scale_select(all_scores: torch.Tensor, all_orients: torch.Tensor):
    """Branch-free scale-max score and tie-normalized orientation select;
    inputs (S, B, H, W), outputs (B, 1, H, W)."""
    scores = all_scores.amax(dim=0)
    mask = (all_scores == scores[None]).to(torch.float32)
    mask = mask / torch.clamp_min(mask.sum(dim=0, keepdim=True), 1.0)
    orientations = (all_orients * mask).sum(dim=0)
    return scores[:, None], orientations[:, None]


def akaze_detect(image: torch.Tensor, num_scales: int = 3,
                 diffusion_iterations: int = 3, kappa: float = 0.05,
                 threshold: float = 0.001, nms_size: int = 5,
                 orientation_patch_size: int = 15,
                 orientation_sigma: float = 2.5):
    """Full AKAZE: per-scale diffusion, Hessian detect and orientation
    moments; scores are the per-pixel max over scales, orientations the
    tie-normalized select of atan2(m01, m10) at the argmax scales.

    Returns:
        ((B, 1, H, W) scores, (B, 1, H, W) radians).
    """
    ss, m10, m01 = akaze_detect_parts(
        image, num_scales=num_scales, diffusion_iterations=diffusion_iterations,
        kappa=kappa, threshold=threshold, nms_size=nms_size,
        orientation_patch_size=orientation_patch_size,
        orientation_sigma=orientation_sigma)
    return _scale_select(ss, torch.atan2(m01, m10))
