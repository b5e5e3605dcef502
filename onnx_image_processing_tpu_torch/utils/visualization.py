"""Visualization helpers for the CLI apps.

Counterpart of the PIL rendering in `sample/feature_detection.py:216-299` and
`sample/image_matching.py:151-218`: keypoints colored by score with a jet-style
colormap, and side-by-side match rendering. A copy of
``onnx_image_processing_tpu/utils/visualization.py`` that imports PIL and
OpenCV where they are used, so importing it needs neither.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from PIL import Image


def _jet(v: float):
    """Jet-style colormap for v in [0, 1] -> (r, g, b) uint8."""
    v = float(np.clip(v, 0.0, 1.0))
    r = int(255 * np.clip(1.5 - abs(4 * v - 3), 0, 1))
    g = int(255 * np.clip(1.5 - abs(4 * v - 2), 0, 1))
    b = int(255 * np.clip(1.5 - abs(4 * v - 1), 0, 1))
    return (r, g, b)


def visualize_keypoints(image_rgb: Image.Image, keypoints: np.ndarray,
                        radius: int = 3,
                        colorize_by_score: bool = False,
                        color: tuple = (0, 255, 0)) -> Image.Image:
    """Draw (y, x, score) keypoints: solid ``color`` by default, jet-mapped by
    normalized score with ``colorize_by_score`` (reference semantics,
    `sample/feature_detection.py:250-299` --colorize)."""
    from PIL import ImageDraw

    out = image_rgb.copy()
    draw = ImageDraw.Draw(out)
    if keypoints.shape[0]:
        smin = float(keypoints[:, 2].min())
        smax = float(keypoints[:, 2].max())
        span = max(smax - smin, 1e-12)
        for y, x, s in keypoints:
            c = _jet((float(s) - smin) / span) if colorize_by_score else color
            draw.ellipse([x - radius, y - radius, x + radius, y + radius],
                         outline=c, width=2)
    return out


def visualize_matches(image1_rgb: Image.Image, image2_rgb: Image.Image,
                      matched_kpts1: np.ndarray, matched_kpts2: np.ndarray,
                      scores: np.ndarray | None = None,
                      colorize_by_score: bool = False) -> Image.Image:
    """Side-by-side images with match lines: solid green by default, jet-
    mapped by score with ``colorize_by_score`` (reference semantics,
    `sample/image_matching.py:151-218` --colorize)."""
    from PIL import Image, ImageDraw

    w1, h1 = image1_rgb.size
    w2, h2 = image2_rgb.size
    canvas = Image.new("RGB", (w1 + w2, max(h1, h2)), (0, 0, 0))
    canvas.paste(image1_rgb, (0, 0))
    canvas.paste(image2_rgb, (w1, 0))
    draw = ImageDraw.Draw(canvas)
    n = len(matched_kpts1)
    if scores is None:
        scores = np.ones(n, np.float32)
    smin = float(scores.min()) if n else 0.0
    span = max((float(scores.max()) - smin) if n else 1.0, 1e-12)
    for (y1, x1), (y2, x2), s in zip(matched_kpts1, matched_kpts2, scores):
        color = (_jet((float(s) - smin) / span) if colorize_by_score
                 else (0, 255, 0))
        draw.line([x1, y1, x2 + w1, y2], fill=color, width=1)
        draw.ellipse([x1 - 2, y1 - 2, x1 + 2, y1 + 2], fill=color)
        draw.ellipse([x2 + w1 - 2, y2 - 2, x2 + w1 + 2, y2 + 2], fill=color)
    return canvas


def draw_vo_overlay(
    frame_bgr: np.ndarray,
    trajectory,
    frame_count: int,
    num_matches: int,
    num_inliers: int,
    matched_kpts2: np.ndarray,
    inlier_mask: np.ndarray | None,
    pose_updated: bool,
    status_message: str | None,
    model_width: int,
    model_height: int,
    minimap: bool = True,
) -> np.ndarray:
    """Full VO on-screen display, matching the reference's OSD
    (`sample/visual_odometry.py:207-319`): size-scaled 5-line status panel
    (frame / status / position / distance / matches+inliers) and matched
    keypoints colored by RANSAC status (green inlier, red outlier, yellow no
    pose), plus a top-right x-z trajectory mini-map the reference lacks.

    Args:
        frame_bgr: display frame (BGR, any resolution).
        matched_kpts2: (N, 2) matched keypoints in the current frame, (y, x)
            at model resolution.
        inlier_mask: (N,) bool, or None when no pose was estimated.

    Returns:
        Annotated copy of the frame.
    """
    import cv2

    info = frame_bgr.copy()
    fh, fw = info.shape[:2]
    pos = trajectory.get_current_position()
    dist = trajectory.get_trajectory_length()

    size_scale = min(fw / 640.0, fh / 480.0)
    font_scale = 0.7 * size_scale
    thick = max(1, int(2 * size_scale))
    line_h = int(30 * size_scale)
    mx = int(10 * size_scale)
    sx, sy = fw / model_width, fh / model_height
    base_r = max(1, int(3 * size_scale))

    # Color precedence mirrors the reference exactly
    # (`sample/visual_odometry.py:265-285`), including its quirk on
    # rejected-pose frames: inliers of a rejected pose fall through to yellow
    # ("no pose") while its outliers still draw red.
    for i, (y, x) in enumerate(np.asarray(matched_kpts2).reshape(-1, 2)):
        px, py = int(x * sx), int(y * sy)
        if pose_updated and inlier_mask is not None and inlier_mask[i]:
            color, r = (0, 255, 0), base_r + 1      # inlier
        elif inlier_mask is not None and not inlier_mask[i]:
            color, r = (0, 0, 255), base_r          # RANSAC outlier
        else:
            color, r = (0, 255, 255), base_r        # no pose estimate
        cv2.circle(info, (px, py), r, color, -1)
        cv2.circle(info, (px, py), r + 1, (0, 0, 0), 1)

    def put(text, row, color=(0, 255, 0)):
        cv2.putText(info, text, (mx, line_h * (row + 1)),
                    cv2.FONT_HERSHEY_SIMPLEX, font_scale, color, thick)

    put(f"Frame: {frame_count}", 0)
    if status_message:
        put(status_message, 1, (0, 0, 255))
    else:
        put("STATUS: OK", 1)
    put(f"Position: [{pos[0]:.2f}, {pos[1]:.2f}, {pos[2]:.2f}]", 2)
    put(f"Distance: {dist:.2f}m", 3)
    put(f"Matches: {num_matches} | Inliers: {num_inliers}", 4)

    if minimap and len(trajectory) >= 2:
        side = int(min(fw, fh) * 0.3)
        pad = int(6 * size_scale)
        x0, y0 = fw - side - pad, pad
        panel = info[y0:y0 + side, x0:x0 + side]
        panel[:] = (panel * 0.35).astype(panel.dtype)  # darken background
        pts = np.asarray([p[:3, 3] for p in trajectory.poses])
        xz = pts[:, [0, 2]]
        lo = xz.min(axis=0)
        span = max(float((xz.max(axis=0) - lo).max()), 1e-6)
        norm = (xz - lo) / span  # [0, 1]^2
        pix = (norm * (side - 2 * pad) + pad).astype(int)
        pix[:, 1] = side - 1 - pix[:, 1]  # +z up
        for a, b in zip(pix[:-1], pix[1:]):
            cv2.line(panel, (int(a[0]), int(a[1])), (int(b[0]), int(b[1])),
                     (255, 255, 255), 1)
        cv2.circle(panel, tuple(pix[-1]), max(2, base_r), (0, 255, 0), -1)
        cv2.rectangle(info, (x0, y0), (x0 + side, y0 + side),
                      (200, 200, 200), 1)
    return info
