"""Point sampling (port of ``onnx_image_processing_tpu/ops/sampling.py``).

Gathers at pixel coordinates in place of ``F.grid_sample`` with border
padding and ``align_corners=True``: the border is a coordinate clamp, and
each sample is one flat gather per batch row.
"""

from __future__ import annotations

import torch


def _clamp_coords(y: torch.Tensor, x: torch.Tensor, h: int, w: int):
    return y.clamp(0.0, float(h - 1)), x.clamp(0.0, float(w - 1))


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
    y, x = _clamp_coords(y, x, h, w)
    idx = (torch.round(y).long() * w + torch.round(x).long()).reshape(b, -1)
    return torch.gather(img.reshape(b, h * w), 1, idx).reshape(y.shape)


def _bilinear(flat: torch.Tensor, base: torch.Tensor | int, y: torch.Tensor,
              x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear interpolation of the (B, N) rows ``flat`` at clamped (y, x),
    each flat index offset by ``base``; JAX's tap order and weights."""
    b = flat.shape[0]
    y0, x0 = torch.floor(y), torch.floor(x)
    wy, wx = y - y0, x - x0
    y0i = y0.long().clamp(0, h - 1)
    x0i = x0.long().clamp(0, w - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x1i = (x0i + 1).clamp(0, w - 1)

    def g(yi, xi):
        idx = (base + yi * w + xi).reshape(b, -1)
        return torch.gather(flat, 1, idx).reshape(y.shape)

    top = g(y0i, x0i) * (1.0 - wx) + g(y0i, x1i) * wx
    bot = g(y1i, x0i) * (1.0 - wx) + g(y1i, x1i) * wx
    return top * (1.0 - wy) + bot * wy


def sample_bilinear(img: torch.Tensor, y: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with border clamping (align_corners=True).

    Args:
        img: (B, H, W).
        y, x: (B, ...) pixel coordinates.

    Returns:
        (B, ...) interpolated values.
    """
    b, h, w = img.shape
    y, x = _clamp_coords(y, x, h, w)
    return _bilinear(img.reshape(b, h * w), 0, y, x, h, w)


def sample_bank_fused(bank: torch.Tensor, channel: torch.Tensor, y: torch.Tensor,
                      x: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    """Sample a multi-channel bank whose channel is itself per sample: the
    channel is folded into the gather index, one gather per tap.

    Args:
        bank: (B, C, H, W).
        channel: integer channel per sample, broadcastable to ``y``'s shape.
        y, x: (B, ...) pixel coordinates.
        mode: 'nearest' or 'bilinear'.

    Returns:
        (B, ...) sampled values.
    """
    b, c, h, w = bank.shape
    y, x = _clamp_coords(y, x, h, w)
    flat = bank.reshape(b, c * h * w)
    chan_off = channel.long() * (h * w)
    if mode == "nearest":
        idx = (chan_off + torch.round(y).long() * w + torch.round(x).long())
        return torch.gather(flat, 1, idx.reshape(b, -1)).reshape(y.shape)
    if mode != "bilinear":
        raise ValueError(f"mode must be 'nearest' or 'bilinear', got {mode!r}")
    return _bilinear(flat, chan_off, y, x, h, w)
