"""Geometry of the port: the in-graph weighted 8-point essential-matrix
estimation (port of ``onnx_image_processing_tpu.geometry``)."""

from .essential_matrix import (
    bidirectional_topk_weights,
    essential_from_matched_points,
    essential_from_weighted_points,
    essential_ransac_from_candidates,
    estimate_essential_from_keypoints,
    estimate_essential_matrix,
    hartley_normalization,
    min_eigvec9,
    project_onto_essential_manifold,
    sampson_error_matched,
    sampson_error_matrix,
)

__all__ = [
    "min_eigvec9",
    "project_onto_essential_manifold",
    "hartley_normalization",
    "bidirectional_topk_weights",
    "sampson_error_matched",
    "sampson_error_matrix",
    "essential_from_weighted_points",
    "essential_from_matched_points",
    "essential_ransac_from_candidates",
    "estimate_essential_matrix",
    "estimate_essential_from_keypoints",
]
