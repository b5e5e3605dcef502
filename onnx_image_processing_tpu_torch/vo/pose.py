"""Host-side pose estimation for visual odometry.

Counterpart of `pytorch_model/vo/pose_estimation.py`: RANSAC pose recovery
plus SE(3) helpers. This layer stays on the host (NumPy) — pose math on a
handful of matches is not device work; the device path feeds it either
matched keypoints or an in-graph essential matrix (``recover_pose``). A
copy of ``onnx_image_processing_tpu/vo/pose.py``, except that
``recover_pose`` and ``triangulate_points`` compute what its OpenCV calls
compute in NumPy float64, so the in-graph-E pose step runs where OpenCV is
absent. ``estimate_pose_ransac`` (a host RANSAC, ``cv2.findEssentialMat``)
still needs OpenCV.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is present in this image
    cv2 = None


def _require_cv2():
    if cv2 is None:
        raise ImportError("OpenCV (cv2) is required for host-side pose recovery")


@dataclass
class CameraIntrinsics:
    """Pinhole intrinsics (parity: `vo/pose_estimation.py:13-50`)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    K: np.ndarray = field(init=False)

    def __post_init__(self):
        self.K = np.array([[self.fx, 0.0, self.cx],
                           [0.0, self.fy, self.cy],
                           [0.0, 0.0, 1.0]], dtype=np.float64)

    def k_inv(self) -> np.ndarray:
        return np.linalg.inv(self.K).astype(np.float32)

    def rescaled(self, width: int, height: int) -> "CameraIntrinsics":
        """Intrinsics for a resized image (the VO app rescales auto-detected
        intrinsics to the model resolution, `sample/visual_odometry.py:918-971`)."""
        sx = width / self.width
        sy = height / self.height
        return CameraIntrinsics(self.fx * sx, self.fy * sy,
                                self.cx * sx, self.cy * sy, width, height)


def estimate_pose_ransac(
    keypoints1: np.ndarray,
    keypoints2: np.ndarray,
    intrinsics: CameraIntrinsics,
    ransac_threshold: float = 1.0,
    ransac_confidence: float = 0.999,
):
    """RANSAC essential matrix + pose recovery from (y, x) keypoints.

    Returns (R (3,3) | None, t (3,1) | None, inlier_mask (N,) bool).
    Parity: `vo/pose_estimation.py:53-115` (>= 5 points guard, combined
    findEssentialMat/recoverPose inlier mask).
    """
    _require_cv2()
    n = len(keypoints1)
    if n < 5 or len(keypoints2) < 5:
        return None, None, np.zeros(n, dtype=bool)

    pts1 = np.ascontiguousarray(keypoints1[:, [1, 0]], dtype=np.float64)
    pts2 = np.ascontiguousarray(keypoints2[:, [1, 0]], dtype=np.float64)

    e, mask = cv2.findEssentialMat(pts1, pts2, intrinsics.K, method=cv2.RANSAC,
                                   prob=ransac_confidence,
                                   threshold=ransac_threshold)
    if e is None or mask is None:
        return None, None, np.zeros(n, dtype=bool)
    inliers = mask.ravel().astype(bool)

    # findEssentialMat may return k stacked (3, 3) candidate solutions as a
    # (3k, 3) matrix (the 5-point minimal solver is multi-root); recoverPose
    # asserts 3x3. The reference passes E through unchecked and would crash
    # identically (`vo/pose_estimation.py:102-109`); here we score every
    # candidate by its chirality-consistent inlier count and keep the best.
    best = (0, None, None, None)
    for i in range(e.shape[0] // 3):
        cand = np.ascontiguousarray(e[3 * i:3 * i + 3])
        num, r, t, pose_mask = cv2.recoverPose(cand, pts1, pts2, intrinsics.K,
                                               mask=mask.copy())
        if num > best[0]:
            best = (num, r, t, pose_mask)
    num, r, t, pose_mask = best
    if num < 5:
        return None, None, inliers
    return r, t, (mask.ravel() != 0) & (pose_mask.ravel() > 0)


def decompose_essential(essential: np.ndarray):
    """``cv2.decomposeEssentialMat``: the SVD of E with U and Vt flipped to
    determinant +1; R1 = U W Vt, R2 = U W^T Vt, t = U[:, 2], with OpenCV's W.
    Returns (R1, R2, t (3,)) in float64."""
    u, _, vt = np.linalg.svd(np.asarray(essential, dtype=np.float64).reshape(3, 3))
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vt) < 0:
        vt = -vt
    w = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return u @ w @ vt, u @ w.T @ vt, u[:, 2].copy()


def _triangulate_dlt(p1: np.ndarray, p2: np.ndarray, x1: np.ndarray,
                     x2: np.ndarray) -> np.ndarray:
    """``cv2.triangulatePoints``: per point, the right singular vector of the
    smallest singular value of the 4x4 system of both views' rows
    x P[2] - P[0] and y P[2] - P[1]. ``x1``, ``x2`` are (N, 2); returns
    unit homogeneous points (4, N), their sign arbitrary."""
    rows = []
    for p, x in ((p1, x1), (p2, x2)):
        rows += [x[:, 0:1] * p[2] - p[0], x[:, 1:2] * p[2] - p[1]]
    a = np.stack(rows, axis=1)                      # (N, 4, 4)
    return np.linalg.svd(a)[2][:, 3, :].T


def _chirality(p1: np.ndarray, x1: np.ndarray, x2: np.ndarray,
               distance_thresh: float) -> np.ndarray:
    """OpenCV's chirality mask of one candidate [R | t]: the point
    triangulated from the identity camera and ``p1`` has positive depth
    below ``distance_thresh`` in both cameras."""
    q = _triangulate_dlt(np.eye(3, 4), p1, x1, x2)
    with np.errstate(divide="ignore", invalid="ignore"):
        mask = q[2] * q[3] > 0
        q = q / q[3]
        mask &= q[2] < distance_thresh
        depth2 = (p1 @ q)[2]
        return mask & (depth2 > 0) & (depth2 < distance_thresh)


def recover_pose(
    essential: np.ndarray,
    keypoints1: np.ndarray,
    keypoints2: np.ndarray,
    intrinsics: CameraIntrinsics,
    sampson_px: float | None = 2.0,
    distance_thresh: float = 1e4,
):
    """Chirality-resolved (R, t) from a known essential matrix and (y, x)
    matches — the host step after the in-graph-E pipelines
    (`sample/visual_odometry.py:95-143`).

    What ``cv2.recoverPose(E, pts1, pts2, K, distanceThresh=, mask=)``
    computes, in NumPy float64 (no OpenCV): the points normalized by K; the
    four candidates of :func:`decompose_essential` in OpenCV's order
    (R1, t), (R2, t), (R1, -t), (R2, -t); for each, the DLT triangulation
    of every match and the chirality mask (depth > 0 in both cameras and
    < ``distance_thresh``) ANDed with the vote mask; the candidate with the
    most votes wins, the first on a tie (OpenCV's ``>=`` rule). The SVD may
    give U and Vt other signs than OpenCV's, which can swap t with -t (and
    R1 with R2) in that order; the four candidates, and each one's votes,
    are the same, so the chosen (R, t) is OpenCV's unless two candidates
    tie for the most votes.

    Two measured robustness divergences from the reference's bare
    ``cv2.recoverPose(E, pts1, pts2, K)`` call (same spirit as the
    stacked-candidate fix in ``estimate_pose_ransac``):

    * ``sampson_px``: chirality votes are restricted to the Sampson inliers
      of E (at this pixel tolerance) instead of letting every outlier match
      vote — the host-RANSAC path gets exactly this for free by passing
      findEssentialMat's inlier mask into recoverPose, and without it a
      contaminated match set can vote the twisted-pair (R flipped 180°)
      decomposition ahead of the true one. ``None`` disables.
    * ``distance_thresh``: cv2's 4-argument ``recoverPose`` overload
      hard-codes a 50-unit triangulated-depth cap in its chirality test;
      scenes with depth/baseline > 50 (any slow-moving camera) then reject
      CORRECT points from voting and the decision is made by noise. The
      explicit-threshold overload with a large bound restores the vote.

    Returns (R (3, 3) | None, t (3, 1) | None, inlier_mask (N,) bool).
    """
    n = len(keypoints1)
    if n < 5:
        return None, None, np.zeros(n, dtype=bool)
    pts1 = np.asarray(keypoints1, dtype=np.float64)[:, [1, 0]]
    pts2 = np.asarray(keypoints2, dtype=np.float64)[:, [1, 0]]
    e = np.asarray(essential, dtype=np.float64)

    vote_mask = np.ones(n, dtype=bool)
    if sampson_px is not None:
        k_inv = np.linalg.inv(intrinsics.K)
        x1 = np.concatenate([pts1, np.ones((n, 1))], axis=1) @ k_inv.T
        x2 = np.concatenate([pts2, np.ones((n, 1))], axis=1) @ k_inv.T
        l2 = x1 @ e.T
        l1 = x2 @ e
        s = ((l2 * x2).sum(1) ** 2
             / (l2[:, 0] ** 2 + l2[:, 1] ** 2
                + l1[:, 0] ** 2 + l1[:, 1] ** 2 + 1e-12))
        tau = (sampson_px / intrinsics.fx) ** 2
        vote_mask = s < tau
        if vote_mask.sum() < 5:
            return None, None, np.zeros(n, dtype=bool)

    k = intrinsics.K
    centre, focal = np.array([k[0, 2], k[1, 2]]), np.array([k[0, 0], k[1, 1]])
    n1, n2 = (pts1 - centre) / focal, (pts2 - centre) / focal
    r1, r2, t = decompose_essential(e)
    candidates = ((r1, t), (r2, t), (r1, -t), (r2, -t))
    masks = [_chirality(np.hstack([r, tc[:, None]]), n1, n2, distance_thresh) & vote_mask
             for r, tc in candidates]
    best = int(np.argmax([m.sum() for m in masks]))   # the first of the most votes
    num = int(masks[best].sum())
    if num < 5:
        return None, None, np.zeros(n, dtype=bool)
    r, tc = candidates[best]
    return r, tc.reshape(3, 1), masks[best]


def triangulate_points(
    keypoints1: np.ndarray,
    keypoints2: np.ndarray,
    r1: np.ndarray, t1: np.ndarray,
    r2: np.ndarray, t2: np.ndarray,
    intrinsics: CameraIntrinsics,
) -> np.ndarray:
    """Two-view triangulation with near-zero-w degeneracy guard: the DLT of
    ``cv2.triangulatePoints``, in NumPy float64 (no OpenCV). The
    homogeneous solution's sign differs from OpenCV's at will; the
    dehomogenized points do not.

    Parity: `vo/pose_estimation.py:118-162`.
    """
    p1 = intrinsics.K @ np.hstack([r1, np.reshape(t1, (3, 1))])
    p2 = intrinsics.K @ np.hstack([r2, np.reshape(t2, (3, 1))])
    pts1 = np.asarray(keypoints1, dtype=np.float64)[:, [1, 0]]
    pts2 = np.asarray(keypoints2, dtype=np.float64)[:, [1, 0]]
    x4 = _triangulate_dlt(p1, p2, pts1, pts2)
    w = x4[3]
    ok = np.abs(w) > 1e-9
    out = np.zeros((3, x4.shape[1]), dtype=np.float64)
    out[:, ok] = x4[:3, ok] / w[ok]
    return out.T


def compose_transformation(r1, t1, r2, t2):
    """T = T1 @ T2 in (R, t) form (parity: `vo/pose_estimation.py:165-193`)."""
    t1 = np.reshape(t1, (3, 1))
    t2 = np.reshape(t2, (3, 1))
    return r1 @ r2, r1 @ t2 + t1


def transformation_to_matrix(r, t) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = r
    m[:3, 3] = np.reshape(t, 3)
    return m


def matrix_to_transformation(m: np.ndarray):
    return m[:3, :3], m[:3, 3]
