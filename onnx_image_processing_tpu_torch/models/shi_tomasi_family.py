"""The flagship rotation-invariant sparse matcher (port of
``onnx_image_processing_tpu/models/shi_tomasi_family.py``).

Detect -> NMS/top-k -> oriented sparse BAD -> Sinkhorn, with the two images
stacked into one batch so detection and description run once. The module
holds the BAD table as buffers; its inputs must be on the module's device.
The kernel-or-plain choice follows the tensors' device, so the JAX
package's backend knobs (``use_pallas``, ``select_frontend``,
``integer_image``) have no effect here.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import MatcherConfig
from ..ops import (BADTable, angle_moments, load_bad_params, nms_select_topk,
                   shi_tomasi_score, sinkhorn_match, sparse_bad)


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
    if cfg.fused_detect:
        raise NotImplementedError("fused_detect (the detect-frontend kernel) "
                                  "is not ported")
    if cfg.topk_mode not in ("block", "sort"):
        raise NotImplementedError(f"topk_mode {cfg.topk_mode!r} is not ported")
    if cfg.distance_type.lower() != "l2":
        raise NotImplementedError(f"distance_type {cfg.distance_type!r} is not ported")


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
        for name, img in (("image1", image1), ("image2", image2)):
            if img.device != self.device:
                raise ValueError(f"{name} is on {img.device}, the model on "
                                 f"{self.device}")
        return shi_tomasi_angle_sparse_bad_sinkhorn_match(
            image1, image2, self.cfg, self.table)
