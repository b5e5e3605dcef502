"""Host-side utilities: post-processing and visualization for the CLIs."""

from .host_postprocess import (
    nms_keypoints,
    refine_keypoints_subpixel,
    select_keypoints,
    extract_matches,
)
from .visualization import (visualize_keypoints, visualize_matches,
                            draw_vo_overlay)

__all__ = [
    "nms_keypoints",
    "refine_keypoints_subpixel",
    "select_keypoints",
    "extract_matches",
    "visualize_keypoints",
    "visualize_matches",
    "draw_vo_overlay",
]
