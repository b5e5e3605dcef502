"""The Shi-Tomasi family (port of
``onnx_image_processing_tpu/models/shi_tomasi_family.py``): the flagship
rotation-invariant matcher, its with-filters variant, the unoriented and
the dense-descriptor matchers, and the single-image heads.

Detect -> NMS/top-k -> (oriented) sparse BAD -> Sinkhorn, with the two
images stacked into one batch so detection and description run once. Each
module holds the BAD table as buffers; its inputs must be on the module's
device.
The kernel-or-plain choice follows the tensors' device, so the JAX
package's backend knobs (``use_pallas``, ``select_frontend``,
``integer_image``) have no effect here.

``MatcherConfig.fused_detect`` is kept as a user flag only for parity with
the JAX package's config. It picks another composition: the detect-frontend
kernel (score * NMS mask and the moments in one pass) followed by the top-k
over the premasked map, in place of the plain stencils and the
select-frontend kernel; in block mode the top-k runs in the detect kernel's
launch (``detect_select``). The two may select up to a few different keypoints
(the premasked map keeps scores within 1e-7 of the local max), so the flag
is not yet decided by the device as AKAZE's ladder is (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import MatcherConfig
from ..kernels import detect_frontend
from ..ops import (BADTable, angle_estimation, angle_moments, block_route, dense_bad,
                   load_bad_params, nms_select_topk, select_topk_keypoints,
                   shi_tomasi_score, sinkhorn_match, sinkhorn_match_with_filters,
                   sparse_bad)
from ..ops.keypoints import BLOCK_MODES


def _resolve_border_margin(cfg: MatcherConfig, table: BADTable,
                           sparse: bool = True) -> int:
    """None -> the descriptor's max box radius for the sparse pipelines, so
    every sampled box of a selected keypoint lies in the image; 0 for the
    dense ones, the reference's no-margin default."""
    if cfg.border_margin is not None:
        return cfg.border_margin
    return table.max_radius if sparse else 0


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
    block_r = cfg.nms_radius if cfg.topk_mode in BLOCK_MODES else None
    return select_topk_keypoints(masked, torch.ones_like(masked),
                                 cfg.max_keypoints, cfg.score_threshold,
                                 margin, nms_radius=block_r)


def _fused_detect_select(image: torch.Tensor, cfg: MatcherConfig, margin: int,
                         with_angle: bool):
    """Detect frontend, then the premasked select. Where the block top-k
    applies (``ops.block_route``), both run as ``detect_select``: one
    launch of the detect kernel on a CUDA tensor, the plain composition on
    a CPU tensor. Otherwise the detect frontend, then the flat top-k.
    Returns keypoints, scores and the (m10, m01) moment maps (None without
    the angle)."""
    kw = dict(block_size=cfg.block_size, patch_size=cfg.patch_size, sigma=cfg.sigma,
              nms_radius=cfg.nms_radius, with_angle=with_angle)
    h, w = image.shape[-2:]
    if block_route(cfg.topk_mode, cfg.nms_radius, h, w, cfg.max_keypoints):
        kpts, kscores, _, m10, m01 = detect_frontend.detect_select(
            image, max_keypoints=cfg.max_keypoints, score_threshold=cfg.score_threshold,
            border_margin=margin, **kw)
    else:
        masked, m10, m01 = detect_frontend.detect_frontend(image, **kw)
        kpts, kscores = _select_premasked(masked, cfg, margin)
    return kpts, kscores, (m10, m01) if with_angle else None


def _descriptor_kw(cfg: MatcherConfig) -> dict:
    """:func:`sparse_bad`'s binarization and normalization options."""
    return dict(binarize=cfg.binarize, soft_binarize=cfg.soft_binarize,
                temperature=cfg.temperature,
                normalize_descriptors=cfg.normalize_descriptors)


# ---- single-image heads ------------------------------------------------------

def shi_tomasi_with_angle(image: torch.Tensor, cfg: MatcherConfig):
    """Score and orientation maps, each (B, 1, H, W)."""
    return (shi_tomasi_score(image, block_size=cfg.block_size),
            angle_estimation(image, patch_size=cfg.patch_size, sigma=cfg.sigma))


def shi_tomasi_bad_detect(image: torch.Tensor, cfg: MatcherConfig, table: BADTable):
    """Dense detector head: scores (B, 1, H, W) and the dense BAD map
    (B, P, H, W)."""
    return (shi_tomasi_score(image, block_size=cfg.block_size),
            dense_bad(image, table, binarize=cfg.binarize,
                      soft_binarize=cfg.soft_binarize, temperature=cfg.temperature))


def shi_tomasi_angle_sparse_bad_detect(image: torch.Tensor, cfg: MatcherConfig,
                                       table: BADTable):
    """Single-image keypoints (B, K, 2), scores (B, K) and oriented sparse
    descriptors (B, K, P).

    This head selects with no border margin by default (the reference
    detector passes the select util's default of 0), unlike the matchers.
    With ``fused_detect`` the detect frontend gives the masked scores and
    the moments; without it the orientation is the dense angle map.
    """
    margin = cfg.border_margin if cfg.border_margin is not None else 0
    if cfg.fused_detect:
        kpts, kscores, orientation_mm = _fused_detect_select(image, cfg, margin, True)
        angles = None
    else:
        scores, angles = shi_tomasi_with_angle(image, cfg)
        kpts, kscores = _select_keypoints(scores, cfg, margin)
        orientation_mm = None
    desc = sparse_bad(image, kpts, table, orientation=angles,
                      orientation_mm=orientation_mm,
                      sampling_mode=cfg.sampling_mode, **_descriptor_kw(cfg))
    return kpts, kscores, desc


# ---- two-image matchers ------------------------------------------------------

def _stack_pair(image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
    return torch.cat([image1, image2], dim=0)  # (2B, 1, H, W)


def _split_pair(x: torch.Tensor):
    b = x.shape[0] // 2
    return x[:b], x[b:]


def _sparse_detect_describe(both: torch.Tensor, cfg: MatcherConfig,
                            table: BADTable, with_angle: bool = True):
    """Keypoints (B, K, 2), scores (B, K) and descriptors (B, K, P) of every
    image in the batch; oriented by the moments with ``with_angle``.

    Every stage is batch-parallel, so it serves both the stacked (2B)
    two-image matchers and the per-image streaming frontend
    (``models/streaming.py``) with the same values."""
    margin = _resolve_border_margin(cfg, table)
    if cfg.fused_detect:
        kpts, kscores, orientation_mm = _fused_detect_select(both, cfg, margin,
                                                             with_angle)
    else:
        scores = shi_tomasi_score(both, block_size=cfg.block_size)
        orientation_mm = (angle_moments(both, patch_size=cfg.patch_size,
                                        sigma=cfg.sigma)
                          if with_angle else None)
        kpts, kscores = _select_keypoints(scores, cfg, margin)
    desc = sparse_bad(both, kpts, table, orientation_mm=orientation_mm,
                      sampling_mode=cfg.sampling_mode, **_descriptor_kw(cfg))
    return kpts, kscores, desc


def _dense_detect_describe(images: torch.Tensor, cfg: MatcherConfig,
                           table: BADTable):
    """The dense matcher's frontend (batch-parallel, also its streaming
    half): Shi-Tomasi select without the sparse border margin, then
    unoriented descriptors sampled bilinearly.

    The dense map is linear in the shifted box banks and the interpolation
    weights sum to 1, so the bilinear interpolation of the map at a
    keypoint equals the descriptor of the bilinearly sampled box means
    there: the sampler gives the reference's (B, P, H, W) map-and-sample
    without building the map.

    Returns:
        keypoints (B, K, 2), scores (B, K), descriptors (B, K, P).
    """
    scores = shi_tomasi_score(images, block_size=cfg.block_size)
    margin = _resolve_border_margin(cfg, table, sparse=False)
    kpts, kscores = _select_keypoints(scores, cfg, margin)
    desc = sparse_bad(images, kpts, table, sampling_mode="bilinear",
                      **_descriptor_kw(cfg))
    return kpts, kscores, desc


def _pair_features(image1: torch.Tensor, image2: torch.Tensor, frontend):
    """Run ``frontend`` once on the stacked pair and split its
    (keypoints, scores, descriptors) into one feature set per image."""
    kpts, kscores, desc = frontend(_stack_pair(image1, image2))
    (k1, k2), (s1, s2), (d1, d2) = (_split_pair(t) for t in (kpts, kscores, desc))
    return (k1, s1, d1), (k2, s2, d2)


def sinkhorn_cfg(desc1: torch.Tensor, desc2: torch.Tensor, cfg: MatcherConfig):
    """:func:`sinkhorn_match` under a pipeline config."""
    return sinkhorn_match(desc1, desc2, iterations=cfg.sinkhorn_iterations,
                          epsilon=cfg.epsilon, unused_score=cfg.unused_score,
                          distance_type=cfg.distance_type)


def match_plain(feats1, feats2, cfg: MatcherConfig):
    """Matching tail of the plain matchers: (kpts1, kpts2, P)."""
    (kpts1, _, desc1), (kpts2, _, desc2) = feats1, feats2
    return kpts1, kpts2, sinkhorn_cfg(desc1, desc2, cfg)


def match_with_filters(feats1, feats2, cfg: MatcherConfig):
    """Matching tail with the ratio / dustbin filters:
    (kpts1, kpts2, P_filtered, valid (B, K))."""
    (kpts1, _, desc1), (kpts2, _, desc2) = feats1, feats2
    probs, valid = sinkhorn_match_with_filters(
        desc1, desc2, iterations=cfg.sinkhorn_iterations, epsilon=cfg.epsilon,
        unused_score=cfg.unused_score, distance_type=cfg.distance_type,
        ratio_threshold=cfg.ratio_threshold, dustbin_margin=cfg.dustbin_margin)
    return kpts1, kpts2, probs, valid


def shi_tomasi_sparse_bad_sinkhorn_match(image1: torch.Tensor,
                                         image2: torch.Tensor,
                                         cfg: MatcherConfig, table: BADTable):
    """Sparse unoriented matcher.

    Returns:
        keypoints1 (B, K, 2), keypoints2 (B, K, 2), P (B, K+1, K+1).
    """
    return match_plain(*_pair_features(
        image1, image2,
        lambda x: _sparse_detect_describe(x, cfg, table, with_angle=False)), cfg)


def shi_tomasi_bad_sinkhorn_match(image1: torch.Tensor, image2: torch.Tensor,
                                  cfg: MatcherConfig, table: BADTable):
    """Dense-descriptor matcher.

    Returns:
        keypoints1 (B, K, 2), keypoints2 (B, K, 2), P (B, K+1, K+1).
    """
    return match_plain(*_pair_features(
        image1, image2, lambda x: _dense_detect_describe(x, cfg, table)), cfg)


def shi_tomasi_angle_sparse_bad_sinkhorn_match(image1: torch.Tensor,
                                               image2: torch.Tensor,
                                               cfg: MatcherConfig,
                                               table: BADTable):
    """Rotation-invariant sparse matcher.

    Returns:
        keypoints1 (B, K, 2), keypoints2 (B, K, 2), P (B, K+1, K+1).
    """
    return match_plain(*_pair_features(
        image1, image2, lambda x: _sparse_detect_describe(x, cfg, table)), cfg)


def shi_tomasi_angle_sparse_bad_sinkhorn_match_with_filters(
        image1: torch.Tensor, image2: torch.Tensor, cfg: MatcherConfig,
        table: BADTable):
    """Flagship matcher + in-graph ratio / dustbin outlier filters.

    Returns:
        keypoints1, keypoints2, P_filtered (B, K+1, K+1), valid_mask (B, K).
    """
    return match_with_filters(*_pair_features(
        image1, image2, lambda x: _sparse_detect_describe(x, cfg, table)), cfg)


def _check_devices(module_device: torch.device, *images: torch.Tensor) -> None:
    for i, img in enumerate(images, 1):
        if img.device != module_device:
            raise ValueError(f"image{i} is on {img.device}, the model on "
                             f"{module_device}")


class SparseMatcher(nn.Module):
    """A two-image sparse matcher as a module, split at its streaming seam.

    ``features(images)`` is the batch-parallel per-image frontend, returning
    (keypoints (B, K, 2), scores (B, K), descriptors (B, K, P));
    ``tail(feats1, feats2, *extra)`` is the matching tail;
    ``forward(image1, image2, *extra)`` with (B, 1, H, W) float32 images runs
    the frontend once on the stacked pair, then the tail. The module holds
    the BAD table as buffers; its inputs must be on the module's device.
    """

    def __init__(self, cfg: MatcherConfig, table: BADTable | None = None):
        super().__init__()
        self.cfg = cfg
        self.table = table if table is not None else BADTable(
            load_bad_params(cfg.num_pairs))
        if self.table.num_pairs != cfg.num_pairs:
            raise ValueError(f"table has {self.table.num_pairs} pairs, config "
                             f"asks for {cfg.num_pairs}")

    @property
    def device(self) -> torch.device:
        return self.table.thresholds.device

    def features(self, images: torch.Tensor):
        raise NotImplementedError

    def tail(self, feats1, feats2):
        return match_plain(feats1, feats2, self.cfg)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, *extra):
        _check_devices(self.device, image1, image2)
        return self.tail(*_pair_features(image1, image2, self.features), *extra)


class ShiTomasiAngleSparseBADSinkhorn(SparseMatcher):
    """The flagship matcher: ``forward(image1, image2)`` returns
    (keypoints1, keypoints2, P)."""

    def features(self, images: torch.Tensor):
        return _sparse_detect_describe(images, self.cfg, self.table)


class ShiTomasiSparseBADSinkhorn(SparseMatcher):
    """The unoriented sparse matcher: ``forward(image1, image2)`` returns
    (keypoints1, keypoints2, P)."""

    def features(self, images: torch.Tensor):
        return _sparse_detect_describe(images, self.cfg, self.table,
                                       with_angle=False)


class ShiTomasiBADSinkhorn(SparseMatcher):
    """The dense-descriptor matcher: ``forward(image1, image2)`` returns
    (keypoints1, keypoints2, P). Its descriptors are the dense BAD map
    sampled bilinearly at the keypoints, computed by the sampler."""

    def features(self, images: torch.Tensor):
        return _dense_detect_describe(images, self.cfg, self.table)


class ShiTomasiAngleSparseBADSinkhornWithFilters(ShiTomasiAngleSparseBADSinkhorn):
    """The flagship with the ratio / dustbin filters: ``forward(image1,
    image2)`` returns (keypoints1, keypoints2, P_filtered, valid)."""

    def tail(self, feats1, feats2):
        return match_with_filters(feats1, feats2, self.cfg)
