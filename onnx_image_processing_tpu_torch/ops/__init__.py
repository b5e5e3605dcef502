"""The port's op library: every op of ``onnx_image_processing_tpu.ops``, under
the same names, plus the port's own helpers (stencils, kernel inputs)."""

from .filters import (box_average_bank, box_sum2d, conv1d_h, conv1d_w, edge_extend,
                      maxpool2d_same, moment_taps, pad2d, sep_conv2d)
from .shi_tomasi import shi_tomasi_score
from .orientation import angle_estimation, angle_estimation_multiscale, angle_moments
from .sampling import sample_bank_fused, sample_bilinear, sample_nearest
from .keypoints import (mask_scores, block_reduce, block_route, nms_maxpool,
                        nms_select_topk, refine_keypoints_subpixel, select_topk_keypoints)
from .bad import (BADParams, BADTable, box_sample_inputs, dense_bad,
                  extract_descriptors_at_keypoints,
                  extract_descriptors_at_keypoints_subpixel, load_bad_params,
                  params_from_jax, sample_layout, sparse_bad)
from .sinkhorn import (dustbin_margin_mask, probability_ratio_mask,
                       sinkhorn_inputs, sinkhorn_match,
                       sinkhorn_match_with_filters, sinkhorn_match_with_scores)
from .match_extraction import extract_mutual_matches
from .akaze import (akaze_detect, akaze_detect_parts, hessian_score,
                    nonlinear_diffusion)
from .fast import fast_score
from .dog import dog_responses, dog_score
from .outlier_filters import dustbin_margin_filter, probability_ratio_filter
from .threshold import multi_otsu_threshold, otsu_threshold
from .depth import (depth_alignment, depth_to_pointcloud, depth_to_pointcloud_with_normal,
                    points_to_pixels, transform_points)
from .pointcloud import voxel_downsampling

__all__ = [
    "box_average_bank", "box_sum2d", "conv1d_h", "conv1d_w", "edge_extend",
    "maxpool2d_same", "moment_taps", "pad2d", "sep_conv2d",
    "shi_tomasi_score", "angle_estimation", "angle_estimation_multiscale", "angle_moments",
    "sample_bank_fused",
    "sample_bilinear", "sample_nearest",
    "mask_scores", "block_reduce", "block_route", "nms_maxpool", "nms_select_topk",
    "refine_keypoints_subpixel", "select_topk_keypoints", "BADParams", "BADTable", "box_sample_inputs",
    "dense_bad", "extract_descriptors_at_keypoints",
    "extract_descriptors_at_keypoints_subpixel",
    "load_bad_params", "params_from_jax", "sample_layout", "sparse_bad",
    "sinkhorn_inputs", "sinkhorn_match", "sinkhorn_match_with_scores",
    "sinkhorn_match_with_filters", "probability_ratio_mask",
    "dustbin_margin_mask", "extract_mutual_matches",
    "akaze_detect", "akaze_detect_parts", "hessian_score", "nonlinear_diffusion",
    "fast_score", "dog_responses", "dog_score",
    "probability_ratio_filter", "dustbin_margin_filter",
    "otsu_threshold", "multi_otsu_threshold",
    "depth_to_pointcloud", "depth_to_pointcloud_with_normal", "depth_alignment",
    "transform_points", "points_to_pixels", "voxel_downsampling",
]
