"""Matchers with an in-graph essential matrix (port of
``onnx_image_processing_tpu/models/essential_family.py``): the flagship or
AKAZE matcher, then the weighted 8-point solve (or, with
``cfg.essential_ransac_hypotheses``, the vectorized RANSAC) on the detected
keypoints. Batch size must be 1. The intrinsics enter as a (3, 3) ``k_inv``
input, so one module serves any camera.
"""

from __future__ import annotations

import torch

from ..core import MatcherConfig
from ..geometry import estimate_essential_from_keypoints
from .akaze_family import AKAZESparseBADSinkhorn
from .shi_tomasi_family import ShiTomasiAngleSparseBADSinkhorn, sinkhorn_cfg

# 8-point solve hyperparameters (the reference's defaults).
_TOP_K = 3
_N_ITER = 30
_N_ITER_MANIFOLD = 10


def essential_from_match(kpts1, ks1, kpts2, ks2, probs, k_inv,
                         cfg: MatcherConfig) -> torch.Tensor:
    """The essential tail shared by the two-image modules and the streaming
    split, on batch-1 inputs: (3, 3) E."""
    return estimate_essential_from_keypoints(
        probs[0], kpts1[0], kpts2[0], valid1=ks1[0] > 0, valid2=ks2[0] > 0,
        k_inv=k_inv, top_k=_TOP_K, n_iter=_N_ITER,
        n_iter_manifold=_N_ITER_MANIFOLD,
        irls_iters=cfg.essential_irls_iters, irls_px=cfg.essential_irls_px,
        ransac_hypotheses=cfg.essential_ransac_hypotheses,
        ransac_px=cfg.essential_ransac_px)


def match_essential(feats1, feats2, k_inv, cfg: MatcherConfig):
    """Matching tail of the essential pipelines:
    (kpts1, kpts2, P, E (3, 3))."""
    (kpts1, ks1, desc1), (kpts2, ks2, desc2) = feats1, feats2
    if kpts1.shape[0] != 1:
        # The solve consumes pair 0 only; a bigger batch would silently
        # return an E fit to one pair.
        raise ValueError(f"essential-matrix pipelines require batch size 1, "
                         f"got {kpts1.shape[0]}")
    probs = sinkhorn_cfg(desc1, desc2, cfg)
    k_inv = torch.as_tensor(k_inv, dtype=torch.float32, device=probs.device)
    return kpts1, kpts2, probs, essential_from_match(kpts1, ks1, kpts2, ks2,
                                                     probs, k_inv, cfg)


class _EssentialTail:
    def tail(self, feats1, feats2, k_inv):
        return match_essential(feats1, feats2, k_inv, self.cfg)


class ShiTomasiAngleSparseBADSinkhornEssential(_EssentialTail,
                                               ShiTomasiAngleSparseBADSinkhorn):
    """Flagship matcher + in-graph E: ``forward(image1, image2, k_inv)``
    with (1, 1, H, W) images returns (keypoints1, keypoints2, P, E)."""


class AKAZESparseBADSinkhornEssential(_EssentialTail, AKAZESparseBADSinkhorn):
    """AKAZE matcher + in-graph E: ``forward(image1, image2, k_inv)`` with
    (1, 1, H, W) images returns (keypoints1, keypoints2, P, E)."""
