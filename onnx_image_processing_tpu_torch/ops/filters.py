"""Separable stencil primitives (port of ``onnx_image_processing_tpu/ops/filters.py``).

Every filter on the path is an outer product of two 1-D taps, applied as
shift-and-add in the JAX package's tap order, skipping zero taps. Not
``F.conv2d``: cuDNN runs f32 convolutions in TF32 by default, and keypoint
rank boundaries are sensitive to the lost digits.

Images and score maps are (B, H, W) float32 inside ops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _edge_index(n: int, before: int, after: int, device) -> torch.Tensor:
    return torch.arange(-before, n + after, device=device).clamp_(0, n - 1)


def pad2d(x: torch.Tensor, pad_h: int, pad_w: int,
          mode: str = "edge") -> torch.Tensor:
    """Pad the trailing two axes of ``x`` on both sides.

    mode 'edge' replicates the border, 'zero' pads with 0, 'neg_inf' with
    -inf (the NMS max-pool border).
    """
    if mode == "edge":
        return edge_extend(x, pad_h, pad_h, pad_w, pad_w)
    if mode == "zero":
        return F.pad(x, (pad_w, pad_w, pad_h, pad_h))
    if mode == "neg_inf":
        return F.pad(x, (pad_w, pad_w, pad_h, pad_h), value=float("-inf"))
    raise ValueError(f"unknown pad mode {mode!r}")


def edge_extend(x: torch.Tensor, top: int, bottom: int, left: int,
                right: int) -> torch.Tensor:
    """Replicate-pad the trailing two axes by the given amounts (a copy)."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.index_select(-2, _edge_index(h, top, bottom, x.device))
    return x.index_select(-1, _edge_index(w, left, right, x.device))


def conv1d_h(x: torch.Tensor, taps) -> torch.Tensor:
    """Valid cross-correlation along axis -2 with static 1-D ``taps``:
    ``out[..., i, :] = sum_t taps[t] * x[..., i + t, :]``, zero taps skipped."""
    taps = np.asarray(taps, dtype=np.float32)
    out_h = x.shape[-2] - taps.shape[0] + 1
    acc = None
    for t, tap in enumerate(taps):
        if tap == 0.0:
            continue
        term = float(tap) * x.narrow(-2, t, out_h)
        acc = term if acc is None else acc + term
    if acc is None:
        acc = x.new_zeros(x.shape[:-2] + (out_h, x.shape[-1]))
    return acc


def conv1d_w(x: torch.Tensor, taps) -> torch.Tensor:
    """Valid cross-correlation along axis -1 with static 1-D ``taps``."""
    taps = np.asarray(taps, dtype=np.float32)
    out_w = x.shape[-1] - taps.shape[0] + 1
    acc = None
    for t, tap in enumerate(taps):
        if tap == 0.0:
            continue
        term = float(tap) * x.narrow(-1, t, out_w)
        acc = term if acc is None else acc + term
    if acc is None:
        acc = x.new_zeros(x.shape[:-1] + (out_w,))
    return acc


def sep_conv2d(x: torch.Tensor, col_taps, row_taps,
               mode: str = "zero") -> torch.Tensor:
    """Separable 2-D cross-correlation with kernel ``col_taps (x) row_taps``,
    "same" output size, border padded by ``mode`` (see :func:`pad2d`)."""
    col_taps = np.asarray(col_taps, dtype=np.float32)
    row_taps = np.asarray(row_taps, dtype=np.float32)
    xp = pad2d(x, col_taps.shape[0] // 2, row_taps.shape[0] // 2, mode=mode)
    return conv1d_w(conv1d_h(xp, col_taps), row_taps)


def box_sum2d(x: torch.Tensor, size: int, mode: str = "edge") -> torch.Tensor:
    """Sum over a ``size x size`` window (separable ones kernel)."""
    ones = np.ones(size, dtype=np.float32)
    return sep_conv2d(x, ones, ones, mode=mode)


def box_average_bank(image_bhw: torch.Tensor, max_radius: int) -> torch.Tensor:
    """Box-average bank, (B, R+1, H, W): channel r is the mean over the
    (2r+1)^2 window of the replicate-padded image; channel 0 is the image.
    Each channel is a separable box sum of one shared padded slab."""
    h, w = image_bhw.shape[-2:]
    xp = pad2d(image_bhw, max_radius, max_radius, mode="edge")
    outs = [image_bhw]
    for r in range(1, max_radius + 1):
        k = 2 * r + 1
        ones = np.ones(k, dtype=np.float32)
        m = max_radius - r
        sub = xp[:, m:m + h + 2 * r, m:m + w + 2 * r]
        outs.append(conv1d_w(conv1d_h(sub, ones), ones) / float(k * k))
    return torch.stack(outs, dim=1)


def gaussian_taps(sigma: float, size: int) -> np.ndarray:
    """Unnormalized 1-D Gaussian taps exp(-t^2 / (2 sigma^2)), t centered."""
    half = size // 2
    t = np.arange(-half, half + 1, dtype=np.float32)
    return np.exp(-(t ** 2) / (2.0 * sigma ** 2)).astype(np.float32)


def moment_taps(sigma: float, size: int) -> tuple[np.ndarray, np.ndarray]:
    """Taps of the orientation moments: the Gaussian ``g`` and ``t * g``
    (t centered; its middle tap is 0), both float32."""
    g = gaussian_taps(sigma, size)
    t = np.arange(-(size // 2), size // 2 + 1, dtype=np.float32)
    return g, (t * g).astype(np.float32)


def maxpool2d_same(x: torch.Tensor, radius: int,
                   pad_mode: str = "neg_inf") -> torch.Tensor:
    """(2r+1)^2 max-pool, stride 1, same spatial shape; separable (column
    max, then row max). The border is ``pad_mode``: 'neg_inf' (keypoint NMS)
    or 'zero' (AKAZE's Hessian NMS, where outside cells count as 0)."""
    if radius <= 0:
        return x
    xp = pad2d(x, radius, radius, mode=pad_mode)
    h, w = x.shape[-2], x.shape[-1]
    col = xp.narrow(-2, 0, h)
    for d in range(1, 2 * radius + 1):
        col = torch.maximum(col, xp.narrow(-2, d, h))
    out = col.narrow(-1, 0, w)
    for d in range(1, 2 * radius + 1):
        out = torch.maximum(out, col.narrow(-1, d, w))
    return out
