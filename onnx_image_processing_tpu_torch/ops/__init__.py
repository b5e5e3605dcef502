"""Ops of the port's pipelines, ported from ``onnx_image_processing_tpu.ops``."""

from .filters import (box_average_bank, box_sum2d, conv1d_h, conv1d_w, edge_extend,
                      maxpool2d_same, moment_taps, pad2d, sep_conv2d)
from .shi_tomasi import shi_tomasi_score
from .orientation import angle_estimation, angle_moments
from .sampling import sample_bank_fused, sample_bilinear, sample_nearest
from .keypoints import (mask_scores, block_reduce, block_route, nms_maxpool,
                        nms_select_topk, select_topk_keypoints)
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

__all__ = [
    "box_average_bank", "box_sum2d", "conv1d_h", "conv1d_w", "edge_extend",
    "maxpool2d_same", "moment_taps", "pad2d", "sep_conv2d",
    "shi_tomasi_score", "angle_estimation", "angle_moments", "sample_bank_fused",
    "sample_bilinear", "sample_nearest",
    "mask_scores", "block_reduce", "block_route", "nms_maxpool", "nms_select_topk",
    "select_topk_keypoints", "BADParams", "BADTable", "box_sample_inputs",
    "dense_bad", "extract_descriptors_at_keypoints",
    "extract_descriptors_at_keypoints_subpixel",
    "load_bad_params", "params_from_jax", "sample_layout", "sparse_bad",
    "sinkhorn_inputs", "sinkhorn_match", "sinkhorn_match_with_scores",
    "sinkhorn_match_with_filters", "probability_ratio_mask",
    "dustbin_margin_mask", "extract_mutual_matches",
    "akaze_detect", "akaze_detect_parts", "hessian_score", "nonlinear_diffusion",
]
