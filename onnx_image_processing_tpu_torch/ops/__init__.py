"""Ops of the flagship and AKAZE matcher paths, ported from
``onnx_image_processing_tpu.ops``."""

from .filters import (conv1d_h, conv1d_w, edge_extend, maxpool2d_same,
                      moment_taps, pad2d)
from .shi_tomasi import shi_tomasi_score
from .orientation import angle_estimation, angle_moments
from .sampling import sample_nearest
from .keypoints import (mask_scores, block_reduce, nms_maxpool,
                        nms_select_topk, select_topk_keypoints)
from .bad import (BADParams, BADTable, box_sample_inputs, load_bad_params,
                  params_from_jax, sample_layout, sparse_bad)
from .sinkhorn import sinkhorn_inputs, sinkhorn_match
from .match_extraction import extract_mutual_matches
from .akaze import (akaze_detect, akaze_detect_parts, hessian_score,
                    nonlinear_diffusion)

__all__ = [
    "conv1d_h", "conv1d_w", "edge_extend", "maxpool2d_same", "moment_taps",
    "pad2d",
    "shi_tomasi_score", "angle_estimation", "angle_moments", "sample_nearest",
    "mask_scores", "block_reduce", "nms_maxpool", "nms_select_topk",
    "select_topk_keypoints", "BADParams", "BADTable", "box_sample_inputs",
    "load_bad_params", "params_from_jax", "sample_layout", "sparse_bad",
    "sinkhorn_inputs", "sinkhorn_match", "extract_mutual_matches",
    "akaze_detect", "akaze_detect_parts", "hessian_score", "nonlinear_diffusion",
]
