"""The flagship rotation-invariant sparse matcher (port of
``onnx_image_processing_tpu/models/shi_tomasi_family.py``).

Detect -> NMS/top-k -> oriented sparse BAD -> Sinkhorn, with the two images
stacked into one batch so detection and description run once. The module
holds the BAD table as buffers; its inputs must be on the module's device.
The kernel-or-plain choice follows the tensors' device, so the JAX
package's backend knobs (``use_pallas``, ``select_frontend``,
``integer_image``) have no effect here.

``MatcherConfig.fused_detect`` is kept as a user flag only for parity with
the JAX package's config. It picks another composition: the detect-frontend
kernel (score * NMS mask and the moments in one pass) followed by a plain
top-k over the premasked map, in place of the plain stencils and the
select-frontend kernel. The two may select up to a few different keypoints
(the premasked map keeps scores within 1e-7 of the local max), so the flag
is not yet decided by the device as AKAZE's ladder is (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import MatcherConfig
from ..kernels import detect_frontend
from ..ops import (BADTable, angle_moments, load_bad_params, nms_select_topk,
                   select_topk_keypoints, shi_tomasi_score, sinkhorn_match,
                   sparse_bad)


def _resolve_border_margin(cfg: MatcherConfig, table: BADTable) -> int:
    """None -> the descriptor's max box radius, so every sampled box of a
    selected keypoint lies in the image."""
    if cfg.border_margin is not None:
        return cfg.border_margin
    return table.max_radius


def _select_keypoints(scores_b1hw: torch.Tensor, cfg: MatcherConfig,
                      margin: int):
    return nms_select_topk(scores_b1hw[:, 0], cfg.max_keypoints,
                           cfg.score_threshold, margin,
                           nms_radius=cfg.nms_radius, topk_mode=cfg.topk_mode)


def _select_premasked(masked_b1hw: torch.Tensor, cfg: MatcherConfig,
                      margin: int):
    """Top-k over a map that already carries the NMS mask (the detect
    frontend's ``score * nms_mask``): a plain block or flat select."""
    masked = masked_b1hw[:, 0]
    block_r = cfg.nms_radius if cfg.topk_mode == "block" else None
    return select_topk_keypoints(masked, torch.ones_like(masked),
                                 cfg.max_keypoints, cfg.score_threshold,
                                 margin, nms_radius=block_r)


def _fused_detect_select(image: torch.Tensor, cfg: MatcherConfig, margin: int):
    """Detect frontend (kernel on a CUDA tensor, plain version on a CPU
    tensor), then the premasked select. Returns keypoints, scores and the
    (m10, m01) moment maps."""
    masked, m10, m01 = detect_frontend.detect_frontend(
        image, block_size=cfg.block_size, patch_size=cfg.patch_size,
        sigma=cfg.sigma, nms_radius=cfg.nms_radius, with_angle=True)
    kpts, kscores = _select_premasked(masked, cfg, margin)
    return kpts, kscores, (m10, m01)


def _stack_pair(image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
    return torch.cat([image1, image2], dim=0)  # (2B, 1, H, W)


def _split_pair(x: torch.Tensor):
    b = x.shape[0] // 2
    return x[:b], x[b:]


def _sparse_detect_describe(both: torch.Tensor, cfg: MatcherConfig,
                            table: BADTable):
    """Keypoints (B, K, 2), scores (B, K) and oriented descriptors (B, K, P)
    of every image in the batch."""
    margin = _resolve_border_margin(cfg, table)
    if cfg.fused_detect:
        kpts, kscores, orientation_mm = _fused_detect_select(both, cfg, margin)
    else:
        scores = shi_tomasi_score(both, block_size=cfg.block_size)
        orientation_mm = angle_moments(both, patch_size=cfg.patch_size,
                                       sigma=cfg.sigma)
        kpts, kscores = _select_keypoints(scores, cfg, margin)
    desc = sparse_bad(both, kpts, table, orientation_mm=orientation_mm,
                      binarize=cfg.binarize, soft_binarize=cfg.soft_binarize,
                      temperature=cfg.temperature,
                      normalize_descriptors=cfg.normalize_descriptors,
                      sampling_mode=cfg.sampling_mode)
    return kpts, kscores, desc


def shi_tomasi_angle_sparse_bad_sinkhorn_match(image1: torch.Tensor,
                                               image2: torch.Tensor,
                                               cfg: MatcherConfig,
                                               table: BADTable):
    """Rotation-invariant sparse matcher.

    Returns:
        keypoints1 (B, K, 2), keypoints2 (B, K, 2), P (B, K+1, K+1).
    """
    kpts, _, desc = _sparse_detect_describe(_stack_pair(image1, image2), cfg,
                                            table)
    kpts1, kpts2 = _split_pair(kpts)
    desc1, desc2 = _split_pair(desc)
    probs = sinkhorn_match(desc1, desc2, iterations=cfg.sinkhorn_iterations,
                           epsilon=cfg.epsilon, unused_score=cfg.unused_score,
                           distance_type=cfg.distance_type)
    return kpts1, kpts2, probs


def _check_ported(cfg: MatcherConfig) -> None:
    if cfg.topk_mode not in ("block", "sort"):
        raise NotImplementedError(f"topk_mode {cfg.topk_mode!r} is not ported")
    if cfg.distance_type.lower() != "l2":
        raise NotImplementedError(f"distance_type {cfg.distance_type!r} is not ported")


def _check_devices(module_device: torch.device, *images: torch.Tensor) -> None:
    for i, img in enumerate(images, 1):
        if img.device != module_device:
            raise ValueError(f"image{i} is on {img.device}, the model on "
                             f"{module_device}")


class ShiTomasiAngleSparseBADSinkhorn(nn.Module):
    """The flagship matcher as a module: ``forward(image1, image2)`` with
    (B, 1, H, W) float32 images returns (keypoints1, keypoints2, P)."""

    def __init__(self, cfg: MatcherConfig, table: BADTable | None = None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.table = table if table is not None else BADTable(
            load_bad_params(cfg.num_pairs))
        if self.table.num_pairs != cfg.num_pairs:
            raise ValueError(f"table has {self.table.num_pairs} pairs, config "
                             f"asks for {cfg.num_pairs}")

    @property
    def device(self) -> torch.device:
        return self.table.thresholds.device

    def forward(self, image1: torch.Tensor, image2: torch.Tensor):
        _check_devices(self.device, image1, image2)
        return shi_tomasi_angle_sparse_bad_sinkhorn_match(
            image1, image2, self.cfg, self.table)
