"""Host-side (NumPy) post-processing for the CLI apps.

Counterpart of the post-inference code in `sample/feature_detection.py:48-213`
and `sample/image_matching.py:49-118`. The reference's host NMS is an
O(H*W*r^2) Python double loop (`feature_detection.py:129-158`); here it is a
vectorized sliding-window maximum. Sub-pixel parabola refinement exists only on
the host in the reference (not in any exported graph) and is kept host-side for
CLI parity.
A copy of ``onnx_image_processing_tpu/utils/host_postprocess.py``.
"""

from __future__ import annotations

import numpy as np


def nms_keypoints(scores: np.ndarray, nms_radius: int = 3) -> np.ndarray:
    """Zero out non-maxima within a (2r+1)^2 window (border-clamped).

    Equivalent to `sample/feature_detection.py:129-158` but vectorized: the
    clamped-window maximum equals a replicate-padded sliding max.
    """
    from scipy.ndimage import maximum_filter

    local_max = maximum_filter(scores, size=2 * nms_radius + 1, mode="nearest")
    out = np.where((scores > 0) & (scores >= local_max), scores, 0.0)
    return out.astype(scores.dtype)


def refine_keypoints_subpixel(score_map: np.ndarray,
                              keypoints: np.ndarray) -> np.ndarray:
    """Per-axis 3-point parabola sub-pixel refinement.

    Given f(-1), f(0), f(1), the peak offset is (f(-1)-f(1)) / (2(f(-1)-2f(0)+f(1))),
    applied only when the parabola is concave and |delta| < 1; border keypoints
    are left unchanged. Parity: `sample/feature_detection.py:48-126`.

    Args:
        score_map: (H, W) raw (pre-NMS) score map.
        keypoints: (N, 3) rows (y, x, score), integer coords.

    Returns:
        (N, 3) refined copy with sub-pixel (y, x) and interpolated score.
    """
    if keypoints.shape[0] == 0:
        return keypoints.copy()
    h, w = score_map.shape
    out = keypoints.copy()
    ys = keypoints[:, 0].astype(np.intp)
    xs = keypoints[:, 1].astype(np.intp)
    interior = (ys >= 1) & (ys < h - 1) & (xs >= 1) & (xs < w - 1)
    if not interior.any():
        return out
    yi, xi = ys[interior], xs[interior]

    f0 = score_map[yi, xi].astype(np.float64)
    fy_n = score_map[yi - 1, xi].astype(np.float64)
    fy_p = score_map[yi + 1, xi].astype(np.float64)
    fx_n = score_map[yi, xi - 1].astype(np.float64)
    fx_p = score_map[yi, xi + 1].astype(np.float64)

    def delta(f_n, f_p):
        denom = 2.0 * (f_n - 2.0 * f0 + f_p)
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.where(denom < -1e-6, (f_n - f_p) / denom, 0.0)
        return np.where(np.abs(d) < 1.0, d, 0.0)

    dy = delta(fy_n, fy_p)
    dx = delta(fx_n, fx_p)
    out[interior, 0] = yi + dy
    out[interior, 1] = xi + dx
    score_y = f0 + 0.25 * dy * (fy_p - fy_n)
    score_x = f0 + 0.25 * dx * (fx_p - fx_n)
    out[interior, 2] = ((score_y + score_x) / 2.0).astype(np.float32)
    return out


def select_keypoints(scores: np.ndarray, threshold: float = 0.01,
                     max_keypoints: int = 1000, nms_radius: int = 3,
                     subpixel: bool = True) -> np.ndarray:
    """NMS → threshold → score-sorted top-k → optional sub-pixel refinement.

    Args:
        scores: (1, 1, H, W) score map.

    Returns:
        (N, 3) rows (y, x, score), N <= max_keypoints.
        Parity: `sample/feature_detection.py:161-213`.
    """
    raw = scores[0, 0]
    suppressed = nms_keypoints(raw, nms_radius=nms_radius)
    ys, xs = np.where(suppressed > threshold)
    if len(ys) == 0:
        return np.zeros((0, 3), dtype=np.float32)
    vals = suppressed[ys, xs]
    order = np.argsort(vals)[::-1][:max_keypoints]
    kpts = np.stack([ys[order].astype(np.float32),
                     xs[order].astype(np.float32),
                     vals[order].astype(np.float32)], axis=-1)
    if subpixel:
        kpts = refine_keypoints_subpixel(raw, kpts)
    return kpts


def extract_matches(matching_probs: np.ndarray, keypoints1: np.ndarray,
                    keypoints2: np.ndarray, threshold: float = 0.1,
                    max_matches: int = 100):
    """Host mutual-NN match extraction from a Sinkhorn matrix.

    Vectorized equivalent of `sample/image_matching.py:49-118` (which loops
    per keypoint for the mutuality check).

    Args:
        matching_probs: (1, N+1, M+1) with dustbin.
        keypoints1: (1, N, 2) (y, x); keypoints2: (1, M, 2).

    Returns:
        (matched_kpts1 (K, 2), matched_kpts2 (K, 2), scores (K,)),
        sorted by score descending, K <= max_matches.
    """
    p = matching_probs[0]
    k1 = keypoints1[0]
    k2 = keypoints2[0]
    n, m = k1.shape[0], k2.shape[0]
    core = p[:n, :m]

    best_j = core.argmax(axis=1)
    best_p = core.max(axis=1)
    best_i = core.argmax(axis=0)
    mutual = best_i[best_j] == np.arange(n)
    valid1 = k1[:, 0] >= 0
    valid2 = k2[best_j, 0] >= 0
    keep = mutual & (best_p >= threshold) & valid1 & valid2
    idx = np.where(keep)[0]
    if len(idx) == 0:
        return (np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32),
                np.zeros(0, np.float32))
    order = idx[np.argsort(best_p[idx])[::-1]][:max_matches]
    return (k1[order].astype(np.float32),
            k2[best_j[order]].astype(np.float32),
            best_p[order].astype(np.float32))
