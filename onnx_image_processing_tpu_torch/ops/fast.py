"""FAST-9 corner detector (port of ``onnx_image_processing_tpu/ops/fast.py``).

The 16 Bresenham-circle pixels are static slices of one edge-padded slab;
the circle's dark and bright tests pack into int32 bits, and a shift-AND
cascade finds runs of 9. The bits stay non-negative (24 at most), so ``>>``
on int32 is exact on both devices. The map is all ties (0 or 1): a caller
that selects on it must keep the lowest-index-first order.
"""

from __future__ import annotations

import torch

from .filters import maxpool2d_same, pad2d

# Bresenham circle of radius 3, clockwise from (0, -3): (dy, dx).
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def _has_9_consecutive(bits16: torch.Tensor) -> torch.Tensor:
    """True where the circular 16-bit pattern holds >= 9 consecutive set
    bits: the low 8 bits are appended above bit 15 (a 24-bit circular
    buffer), then r2 = b & b>>1, r4 = r2 & r2>>2, r8 = r4 & r4>>4,
    r9 = r8 & b>>8."""
    buf = bits16 | ((bits16 & 0xFF) << 16)
    r2 = buf & (buf >> 1)
    r4 = r2 & (r2 >> 2)
    r8 = r4 & (r4 >> 4)
    r9 = r8 & (buf >> 8)
    return (r9 & 0xFFFF) != 0


def fast_score(image: torch.Tensor, threshold: float = 20.0, use_nms: bool = False,
               nms_radius: int = 3) -> torch.Tensor:
    """FAST-9 binary corner score map: 1.0 where 9 consecutive circle
    pixels are all brighter or all darker than the centre by ``threshold``.

    Args:
        image: (B, 1, H, W) grayscale in [0, 255].
        use_nms: zero-padded max-pool NMS of radius ``nms_radius``.

    Returns:
        (B, 1, H, W) float32 map.
    """
    x = image.to(torch.float32)[:, 0]
    h, w = x.shape[-2:]
    xp = pad2d(x, 3, 3, mode="edge")
    dark = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    bright = torch.zeros_like(dark)
    for i, (dy, dx) in enumerate(_CIRCLE):
        diff = xp[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - x
        dark |= (diff >= threshold).to(torch.int32) << i
        bright |= (diff <= -threshold).to(torch.int32) << i
    detected = _has_9_consecutive(dark) | _has_9_consecutive(bright)
    score = detected.to(torch.float32)[:, None]
    if use_nms:
        local_max = maxpool2d_same(score, nms_radius, pad_mode="zero")
        score = torch.where(score == local_max, score, 0.0)
    return score
