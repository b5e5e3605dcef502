"""Select frontend: fused NMS + masks + block-reduced keypoint candidates.

Port of ``onnx_image_processing_tpu/kernels/select_frontend.py``
(``nms_block_reduce_padded``). On a CUDA tensor :func:`nms_block_reduce`
launches ``csrc/select_frontend.cu``; on a CPU tensor it runs
:func:`nms_block_reduce_plain`, the port of ``_block_reduce_xla`` plus the
masks. The two are bit-identical: every output is a max, a compare or a copy.
The output is the true (B, Hb, Wb) block grid; the TPU kernel's lane padding
is not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, _build, use_kernel
from ..ops.keypoints import block_reduce, mask_scores, nms_maxpool

LAUNCHES = LaunchCounter("select_frontend")
MAX_RADIUS = 15  # the kernel's shared-memory tile fits radii 1..15


def nms_block_reduce_plain(scores: torch.Tensor, nms_radius: int,
                           score_threshold: float = 0.0,
                           border_margin: int = 0):
    """Plain PyTorch version of the kernel: same contract."""
    masked = mask_scores(scores, nms_maxpool(scores, nms_radius),
                         score_threshold, border_margin)
    return block_reduce(masked, nms_radius + 1, scores.shape[-1])


def nms_block_reduce(scores: torch.Tensor, nms_radius: int,
                     score_threshold: float = 0.0, border_margin: int = 0):
    """NMS keep mask (-inf border, 1e-7 slack), border-margin and threshold
    masks, then per-(r+1)^2 block max and minimum raster index of the max.

    Args:
        scores: (B, H, W) float32 raw detector scores.

    Returns:
        ``(block_max (B, Hb, Wb) f32, block_idx (B, Hb, Wb) int32)`` with
        Hb = ceil(H / (r+1)), Wb = ceil(W / (r+1)).
    """
    if not use_kernel(scores):
        return nms_block_reduce_plain(scores, nms_radius, score_threshold,
                                      border_margin)
    if scores.dtype != torch.float32 or scores.dim() != 3:
        raise ValueError(f"scores must be (B, H, W) float32, got "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    if not 1 <= nms_radius <= MAX_RADIUS:
        raise ValueError(f"nms_radius must be in 1..{MAX_RADIUS}, got {nms_radius}")
    b, h, w = scores.shape
    bs = nms_radius + 1
    hb, wb = -(-h // bs), -(-w // bs)
    if (hb * bs) * w + wb * bs >= 2 ** 31:
        raise ValueError(f"a {h}x{w} map overflows int32 raster indices")
    block_max = torch.empty((b, hb, wb), dtype=torch.float32, device=scores.device)
    block_idx = torch.empty((b, hb, wb), dtype=torch.int32, device=scores.device)
    fn = _build.entry("oip_select_frontend", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p])
    err = fn(_build.ptr(scores), _build.ptr(block_max), _build.ptr(block_idx),
             b, h, w, int(nms_radius), int(border_margin),
             float(score_threshold), _build.stream(scores))
    _build.check(err, "select_frontend launch")
    LAUNCHES.count += 1
    return block_max, block_idx
