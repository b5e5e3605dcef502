"""AKAZE pipeline family (port of
``onnx_image_processing_tpu/models/akaze_family.py``): AKAZE detect ->
NMS/top-k -> oriented sparse BAD -> Sinkhorn.

Shares the stacked-pair batching and keypoint selection with the Shi-Tomasi
family. Descriptors sample the ORIGINAL image; only the orientation comes
from AKAZE, as a dense map sampled at the keypoints. The AKAZE ladder runs
as its kernel on a CUDA tensor and as its plain version on a CPU tensor
(``ops.akaze.akaze_detect_parts``); ``fused_detect`` does not change that.
"""

from __future__ import annotations

import torch

from ..core import MatcherConfig
from ..ops import BADTable, akaze_detect, sparse_bad
from .shi_tomasi_family import (SparseMatcher, _pair_features,
                                _resolve_border_margin, _select_keypoints,
                                match_plain)


def akaze_detect_cfg(image: torch.Tensor, cfg: MatcherConfig):
    """AKAZE scores and orientations, each (B, 1, H, W), under a pipeline
    config."""
    a = cfg.akaze
    return akaze_detect(
        image, num_scales=a.num_scales,
        diffusion_iterations=a.diffusion_iterations, kappa=a.kappa,
        threshold=a.threshold, nms_size=a.nms_size,
        orientation_patch_size=a.orientation_patch_size,
        orientation_sigma=a.orientation_sigma)


def akaze_sparse_detect_describe(images: torch.Tensor, cfg: MatcherConfig,
                                 table: BADTable):
    """Keypoints (B, K, 2), scores (B, K) and descriptors (B, K, P) of
    every image in the batch."""
    scores, orient = akaze_detect_cfg(images, cfg)
    kpts, kscores = _select_keypoints(scores, cfg, _resolve_border_margin(cfg, table))
    desc = sparse_bad(images, kpts, table, orientation=orient,
                      binarize=cfg.binarize, soft_binarize=cfg.soft_binarize,
                      temperature=cfg.temperature,
                      normalize_descriptors=cfg.normalize_descriptors,
                      sampling_mode=cfg.sampling_mode)
    return kpts, kscores, desc


def akaze_sparse_bad_sinkhorn_match(image1: torch.Tensor, image2: torch.Tensor,
                                    cfg: MatcherConfig, table: BADTable):
    """AKAZE two-image matcher.

    Returns:
        keypoints1 (B, K, 2), keypoints2 (B, K, 2), P (B, K+1, K+1).
    """
    return match_plain(*_pair_features(
        image1, image2, lambda x: akaze_sparse_detect_describe(x, cfg, table)), cfg)


class AKAZESparseBADSinkhorn(SparseMatcher):
    """The AKAZE matcher as a module: ``forward(image1, image2)`` with
    (B, 1, H, W) float32 images returns (keypoints1, keypoints2, P)."""

    def features(self, images: torch.Tensor):
        return akaze_sparse_detect_describe(images, self.cfg, self.table)
