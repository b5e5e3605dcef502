"""Max-pool NMS and static top-k keypoint selection (port of
``onnx_image_processing_tpu/ops/keypoints.py``).

Keypoints are (B, K, 2) float32 in (y, x) order; invalid slots are (-1, -1)
with score 0. Top-k keeps ``lax.top_k``'s rule that equal values go lowest
index first: ``torch.topk`` promises no tie order, so selection is a stable
descending sort sliced to K. The JAX package's XLA-TPU sort tuning (chunked
top-k, rank-2 folds) and its approximate mode are not ported.
"""

from __future__ import annotations

import torch

from .filters import maxpool2d_same

_INT32_MAX = 2 ** 31 - 1


def _top_k(vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, equal values lowest index first."""
    s, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def _decode_topk(topk_scores: torch.Tensor, topk_idx: torch.Tensor, w: int):
    """Linear index -> (y, x); slots with score <= 0 -> (-1, -1) / 0."""
    y = torch.div(topk_idx, w, rounding_mode="floor").to(torch.float32)
    x = torch.remainder(topk_idx, w).to(torch.float32)
    kpts = torch.stack([y, x], dim=-1)
    valid = topk_scores > 0
    kpts = torch.where(valid[..., None], kpts, -1.0)
    return kpts, torch.where(valid, topk_scores, 0.0)


def nms_maxpool(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """(B, H, W) keep mask: 1.0 where ``score >= local_max - 1e-7`` over the
    (2r+1)^2 window with a -inf border."""
    local_max = maxpool2d_same(scores, nms_radius)
    return (scores >= local_max - 1e-7).to(scores.dtype)


def mask_scores(scores: torch.Tensor, nms_mask: torch.Tensor,
                score_threshold: float, border_margin: int) -> torch.Tensor:
    """NMS, border-margin and threshold masks applied to (B, H, W) scores."""
    h, w = scores.shape[-2:]
    masked = scores * nms_mask
    if border_margin > 0:
        m = border_margin
        ys = torch.arange(h, device=scores.device)
        xs = torch.arange(w, device=scores.device)
        inside = (((ys >= m) & (ys < h - m))[:, None]
                  & ((xs >= m) & (xs < w - m))[None, :])
        masked = masked * inside.to(masked.dtype)
    return torch.where(masked > score_threshold, masked, 0.0)


def block_reduce(masked: torch.Tensor, bs: int, w: int):
    """Per-(bs x bs) block max and the minimum raster index ``y * w + x``
    among the block's maximal cells (port of ``_block_reduce_xla``).

    ``masked`` (B, H, W) is zero-padded to whole blocks. Returns
    ``(block_max (B, Hb, Wb) f32, block_idx (B, Hb, Wb) int32)``.
    """
    b, h, wd = masked.shape
    hb, wb = -(-h // bs), -(-wd // bs)
    padded = torch.nn.functional.pad(masked, (0, wb * bs - wd, 0, hb * bs - h))
    blocks = padded.reshape(b, hb, bs, wb, bs)
    block_max = blocks.amax(dim=(2, 4))
    ys = torch.arange(hb * bs, dtype=torch.int32, device=masked.device)
    xs = torch.arange(wb * bs, dtype=torch.int32, device=masked.device)
    lin = (ys[:, None] * w + xs[None, :]).reshape(1, hb, bs, wb, bs)
    is_max = blocks == block_max[:, :, None, :, None]
    cand = torch.where(is_max, lin, _INT32_MAX)
    return block_max, cand.amin(dim=(2, 4))


def select_topk_keypoints(scores: torch.Tensor, nms_mask: torch.Tensor,
                          max_keypoints: int, score_threshold: float = 0.0,
                          border_margin: int = 0,
                          nms_radius: int | None = None):
    """Top-k surviving keypoints of a (B, H, W) score map.

    ``nms_radius=None``: flat top-k over H*W. ``nms_radius=r`` (the radius of
    ``nms_mask``): top-k over per-(r+1)^2 block maxima, which NMS makes
    exact except that a block keeps one of several same-block score ties.

    Returns:
        keypoints (B, K, 2) float (y, x); scores (B, K).
    """
    b, h, w = scores.shape
    masked = mask_scores(scores, nms_mask, score_threshold, border_margin)
    if nms_radius is not None and nms_radius >= 1:
        bs = nms_radius + 1
        if -(-h // bs) * -(-w // bs) >= max_keypoints:
            block_max, block_idx = block_reduce(masked, bs, w)
            return _select_blocks(block_max, block_idx, max_keypoints, w)
    topk_scores, topk_idx = _top_k(masked.reshape(b, h * w), max_keypoints)
    return _decode_topk(topk_scores, topk_idx, w)


def _select_blocks(block_max, block_idx, max_keypoints: int, w: int):
    b = block_max.shape[0]
    topk_scores, topk_block = _top_k(block_max.reshape(b, -1), max_keypoints)
    topk_idx = torch.gather(block_idx.reshape(b, -1), 1, topk_block)
    return _decode_topk(topk_scores, topk_idx.long(), w)


def block_route(topk_mode: str, nms_radius: int, h: int, w: int, max_keypoints: int) -> bool:
    """Whether selection takes the block top-k: block mode, an NMS radius of
    at least 1, and at least ``max_keypoints`` blocks of (r+1)^2 pixels."""
    if topk_mode != "block" or nms_radius < 1:
        return False
    bs = nms_radius + 1
    blocks = -(-h // bs) * -(-w // bs)
    if isinstance(blocks, torch.SymInt):
        # A trace with symbolic H and W serves only shapes with enough
        # blocks (the JAX package's symbolic scope has the same constraint);
        # the check stays in the program and raises on a smaller image.
        torch._check(blocks >= max_keypoints, lambda: (
            f"the {bs}x{bs} block grid must hold max_keypoints={max_keypoints} blocks"))
        return True
    return blocks >= max_keypoints


def nms_select_topk(scores: torch.Tensor, max_keypoints: int,
                    score_threshold: float = 0.0, border_margin: int = 0,
                    nms_radius: int = 3, topk_mode: str = "block"):
    """NMS + top-k keypoint selection from a raw (B, H, W) score map.

    In block mode the NMS, masks, block reduction, block top-k and decode
    run as one launch of the select-frontend kernel on a CUDA tensor, and
    as its plain version on a CPU tensor. ``topk_mode="sort"``, and a map
    with fewer blocks than ``max_keypoints``, take the flat top-k.

    Returns:
        keypoints (B, K, 2) float (y, x); scores (B, K).
    """
    # Imported here: the kernel module's plain version is built from this
    # module's functions.
    from ..kernels import select_frontend

    if topk_mode not in ("block", "sort"):
        raise NotImplementedError(
            f"topk_mode {topk_mode!r} is not ported (use 'block' or 'sort')")
    h, w = scores.shape[-2:]
    if block_route(topk_mode, nms_radius, h, w, max_keypoints):
        return select_frontend.nms_select_blocks(scores, nms_radius, max_keypoints,
                                                 score_threshold, border_margin)
    mask = nms_maxpool(scores, nms_radius)
    return select_topk_keypoints(scores, mask, max_keypoints, score_threshold,
                                 border_margin, nms_radius=None)


def refine_keypoints_subpixel(scores: torch.Tensor, keypoints: torch.Tensor,
                              kpt_scores: torch.Tensor | None = None):
    """In-graph per-axis 3-point parabola sub-pixel refinement (the host
    version is ``utils.refine_keypoints_subpixel``).

    The offset (f(-1) - f(1)) / (2 (f(-1) - 2 f(0) + f(1))) applies only
    where the parabola is concave and |delta| < 1; border and invalid
    (-1, -1) keypoints pass through unchanged.

    Args:
        scores: (B, H, W) raw (pre-NMS) score map.
        keypoints: (B, K, 2) integer-valued (y, x).
        kpt_scores: optional (B, K) scores to refine alongside.

    Returns:
        (B, K, 2) refined keypoints [, (B, K) interpolated scores].
    """
    b, h, w = scores.shape
    yi = keypoints[..., 0].to(torch.int64)
    xi = keypoints[..., 1].to(torch.int64)
    valid = (yi >= 1) & (yi < h - 1) & (xi >= 1) & (xi < w - 1)
    yc = yi.clamp(1, h - 2)
    xc = xi.clamp(1, w - 2)
    flat = scores.reshape(b, h * w)

    def at(dy, dx):
        return torch.gather(flat, 1, (yc + dy) * w + (xc + dx))

    f0 = at(0, 0)

    def delta(f_n, f_p):
        denom = 2.0 * (f_n - 2.0 * f0 + f_p)
        d = torch.where(denom < -1e-6,
                        (f_n - f_p) / torch.where(denom == 0, 1.0, denom), 0.0)
        return torch.where(d.abs() < 1.0, d, 0.0)

    fy_n, fy_p = at(-1, 0), at(1, 0)
    fx_n, fx_p = at(0, -1), at(0, 1)
    dy = delta(fy_n, fy_p) * valid
    dx = delta(fx_n, fx_p) * valid

    refined = torch.stack([keypoints[..., 0] + dy, keypoints[..., 1] + dx], dim=-1)
    refined = torch.where(keypoints[..., :1] >= 0, refined, keypoints)
    if kpt_scores is None:
        return refined
    score_y = f0 + 0.25 * dy * (fy_p - fy_n)
    score_x = f0 + 0.25 * dx * (fx_p - fx_n)
    new_scores = torch.where(valid & (keypoints[..., 0] >= 0),
                             (score_y + score_x) / 2.0, kpt_scores)
    return refined, new_scores
