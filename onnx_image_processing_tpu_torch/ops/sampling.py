"""Point sampling (port of ``onnx_image_processing_tpu/ops/sampling.py``)."""

from __future__ import annotations

import torch


def sample_nearest(img: torch.Tensor, y: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample with border clamping.

    Args:
        img: (B, H, W) single-channel map.
        y, x: (B, ...) float pixel coordinates.

    Returns:
        (B, ...) values. Rounding is half to even (``torch.round``), as
        ``jnp.round`` and grid_sample's nearest mode.
    """
    b, h, w = img.shape
    yi = torch.round(y.clamp(0.0, float(h - 1))).long()
    xi = torch.round(x.clamp(0.0, float(w - 1))).long()
    idx = (yi * w + xi).reshape(b, -1)
    return torch.gather(img.reshape(b, h * w), 1, idx).reshape(y.shape)
