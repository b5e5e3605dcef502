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
from torch import nn

from ..core import MatcherConfig
from ..ops import BADTable, akaze_detect, load_bad_params, sinkhorn_match, sparse_bad
from .shi_tomasi_family import (_check_devices, _check_ported,
                                _resolve_border_margin, _select_keypoints,
                                _split_pair, _stack_pair)


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
    kpts, _, desc = akaze_sparse_detect_describe(_stack_pair(image1, image2),
                                                 cfg, table)
    kpts1, kpts2 = _split_pair(kpts)
    desc1, desc2 = _split_pair(desc)
    probs = sinkhorn_match(desc1, desc2, iterations=cfg.sinkhorn_iterations,
                           epsilon=cfg.epsilon, unused_score=cfg.unused_score,
                           distance_type=cfg.distance_type)
    return kpts1, kpts2, probs


class AKAZESparseBADSinkhorn(nn.Module):
    """The AKAZE matcher as a module: ``forward(image1, image2)`` with
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
        return akaze_sparse_bad_sinkhorn_match(image1, image2, self.cfg, self.table)


class AKAZEDetector(nn.Module):
    """The single-image ``akaze`` head: ``forward(image)`` with a
    (B, 1, H, W) float32 image returns (scores, orientations), each
    (B, 1, H, W)."""

    def __init__(self, cfg: MatcherConfig):
        super().__init__()
        self.cfg = cfg
        # Holds no weights; the empty buffer moves with .to() and names the device.
        self.register_buffer("anchor", torch.empty(0), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.anchor.device

    def forward(self, image: torch.Tensor):
        _check_devices(self.device, image)
        return akaze_detect_cfg(image, self.cfg)
