"""Select frontend: fused NMS + masks + block-reduced keypoint candidates,
and the block top-k with its decode.

Port of ``onnx_image_processing_tpu/kernels/select_frontend.py``
(``nms_block_reduce_padded``). On a CUDA tensor :func:`nms_block_reduce`
launches ``csrc/select_frontend.cu``; on a CPU tensor it runs
:func:`nms_block_reduce_plain`, the port of ``_block_reduce_xla`` plus the
masks. The two are bit-identical: every output is a max, a compare or a copy.
The output is the true (B, Hb, Wb) block grid; the TPU kernel's lane padding
is not carried over. :func:`nms_select_blocks` goes on to the K best blocks
as keypoints in the same launch (the top-k and decode that the JAX package
leaves to XLA after its kernel); its plain version is
:func:`nms_block_reduce_plain` followed by ``ops.keypoints._select_blocks``.
Both functions go through custom ops (``oip::nms_block_reduce``,
``oip::nms_select_blocks``), which ``torch.export`` keeps as nodes of its
graph; an op's fake implementation gives its output shapes from the
input's sizes, symbolic ones included.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, _build, use_kernel
from ..ops.keypoints import _select_blocks, block_reduce, mask_scores, nms_maxpool

LAUNCHES = LaunchCounter("select_frontend")
MAX_RADIUS = 15  # the kernel's shared-memory tile fits radii 1..15
SMEM_KEYS = 4096  # survivors the kernel sorts in shared memory (kSmemKeys)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
_TOPK_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def nms_block_reduce_plain(scores: torch.Tensor, nms_radius: int,
                           score_threshold: float = 0.0,
                           border_margin: int = 0):
    """Plain PyTorch version of the kernel: same contract."""
    masked = mask_scores(scores, nms_maxpool(scores, nms_radius),
                         score_threshold, border_margin)
    return block_reduce(masked, nms_radius + 1, scores.shape[-1])


def _check(scores: torch.Tensor, nms_radius: int) -> tuple[int, int]:
    """Raise on what the kernel does not take; return the grid (Hb, Wb)."""
    if scores.dtype != torch.float32 or scores.dim() != 3:
        raise ValueError(f"scores must be (B, H, W) float32, got "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    if not 1 <= nms_radius <= MAX_RADIUS:
        raise ValueError(f"nms_radius must be in 1..{MAX_RADIUS}, got {nms_radius}")
    _, h, w = scores.shape
    bs = nms_radius + 1
    hb, wb = -(-h // bs), -(-w // bs)
    if (hb * bs) * w + wb * bs >= 2 ** 31:
        raise ValueError(f"a {h}x{w} map overflows int32 raster indices")
    return hb, wb


def _grid(scores: torch.Tensor, nms_radius: int):
    """(B, Hb, Wb) of the block grid; the sizes stay symbolic under a trace."""
    b, h, w = scores.shape
    bs = nms_radius + 1
    return b, -(-h // bs), -(-w // bs)


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
    return nms_block_reduce_op(scores, int(nms_radius), float(score_threshold),
                               int(border_margin))


@torch.library.custom_op("oip::nms_block_reduce", mutates_args=())
def nms_block_reduce_op(scores: torch.Tensor, nms_radius: int, score_threshold: float,
                        border_margin: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The op behind :func:`nms_block_reduce`: the plain version on a CPU
    tensor, one launch of the kernel on a CUDA tensor."""
    if not use_kernel(scores):
        return nms_block_reduce_plain(scores, nms_radius, score_threshold, border_margin)
    hb, wb = _check(scores, nms_radius)
    b, h, w = scores.shape
    block_max = torch.empty((b, hb, wb), dtype=torch.float32, device=scores.device)
    block_idx = torch.empty((b, hb, wb), dtype=torch.int32, device=scores.device)
    fn = _build.entry("oip_select_frontend", _ARGTYPES)
    with torch.cuda.device(scores.device):
        err = fn(_build.ptr(scores), _build.ptr(block_max), _build.ptr(block_idx),
                 b, h, w, nms_radius, border_margin, score_threshold, _build.stream(scores))
    _build.check(err, "select_frontend launch")
    LAUNCHES.count += 1
    return block_max, block_idx


@nms_block_reduce_op.register_fake
def _(scores, nms_radius, score_threshold, border_margin):
    shape = _grid(scores, nms_radius)
    return scores.new_empty(shape), scores.new_empty(shape, dtype=torch.int32)


def nms_select_blocks_plain(scores: torch.Tensor, nms_radius: int, max_keypoints: int,
                            score_threshold: float = 0.0, border_margin: int = 0):
    """Plain PyTorch version of the top-k kernel: same contract."""
    block_max, block_idx = nms_block_reduce_plain(scores, nms_radius, score_threshold,
                                                  border_margin)
    return _select_blocks(block_max, block_idx, max_keypoints, scores.shape[-1])


def nms_select_blocks(scores: torch.Tensor, nms_radius: int, max_keypoints: int,
                      score_threshold: float = 0.0, border_margin: int = 0):
    """:func:`nms_block_reduce`, then the ``max_keypoints`` largest block
    maxima of each image, equal values lowest block index first (a stable
    descending sort over the row-major block grid), decoded to keypoints.

    Args:
        scores: (B, H, W) float32 raw detector scores.
        max_keypoints: K, 1 <= K <= Hb * Wb.

    Returns:
        keypoints (B, K, 2) float32 (y, x) and scores (B, K); a slot whose
        block max is <= 0 is (-1, -1) with score 0.
    """
    return nms_select_blocks_op(scores, int(nms_radius), int(max_keypoints),
                                float(score_threshold), int(border_margin))


@torch.library.custom_op("oip::nms_select_blocks", mutates_args=())
def nms_select_blocks_op(scores: torch.Tensor, nms_radius: int, max_keypoints: int,
                         score_threshold: float,
                         border_margin: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The op behind :func:`nms_select_blocks`: the plain version on a CPU
    tensor, one launch of the kernel on a CUDA tensor. The kernel's ticket
    counters are internal state that every launch leaves at 0, not an
    argument: the op mutates none of its arguments."""
    if not use_kernel(scores):
        return nms_select_blocks_plain(scores, nms_radius, max_keypoints,
                                       score_threshold, border_margin)
    hb, wb = _check(scores, nms_radius)
    k = max_keypoints
    if not 1 <= k <= hb * wb:
        raise ValueError(f"max_keypoints must be in 1..{hb * wb} (the block grid), got {k}")
    b, h, w = scores.shape
    dev = scores.device
    block_max = torch.empty((b, hb, wb), dtype=torch.float32, device=dev)
    block_idx = torch.empty((b, hb, wb), dtype=torch.int32, device=dev)
    kpts = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    kscores = torch.empty((b, k), dtype=torch.float32, device=dev)
    p2 = 1 << (k - 1).bit_length()
    keys = (torch.empty((b, p2), dtype=torch.int64, device=dev) if p2 > SMEM_KEYS
            else None)
    fn = _build.entry("oip_select_topk", _TOPK_ARGTYPES)
    counters = _build.ticket_counters(dev, b, "nms_select_blocks")
    with torch.cuda.device(scores.device):
        err = fn(_build.ptr(scores), _build.ptr(block_max), _build.ptr(block_idx),
                 _build.ptr(counters), None if keys is None else _build.ptr(keys),
                 _build.ptr(kpts), _build.ptr(kscores), b, h, w, nms_radius,
                 border_margin, score_threshold, k,
                 0 if keys is None else p2, _build.stream(scores))
    _build.check(err, "select_frontend top-k launch")
    LAUNCHES.count += 1
    return kpts, kscores


@nms_select_blocks_op.register_fake
def _(scores, nms_radius, max_keypoints, score_threshold, border_margin):
    b = scores.shape[0]
    return (scores.new_empty((b, max_keypoints, 2)), scores.new_empty((b, max_keypoints)))
