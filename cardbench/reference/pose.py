"""The VO loop's host step, plainly: chirality-resolved (R, t) from an
essential matrix and (y, x) matches, as ``cv2.recoverPose`` with an explicit
distance threshold computes it, the votes restricted to the Sampson inliers
of E, and the loop's gating of a frame (too few matches, no motion, a
rejected pose, or an accepted one). NumPy float64."""

from __future__ import annotations

import numpy as np

_W = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


def _decompose(e: np.ndarray):
    u, _, vt = np.linalg.svd(e)
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vt) < 0:
        vt = -vt
    return u @ _W @ vt, u @ _W.T @ vt, u[:, 2].copy()


def _triangulate(p1, p2, x1, x2) -> np.ndarray:
    rows = []
    for p, x in ((p1, x1), (p2, x2)):
        rows += [x[:, 0:1] * p[2] - p[0], x[:, 1:2] * p[2] - p[1]]
    return np.linalg.svd(np.stack(rows, axis=1))[2][:, 3, :].T


def _chirality(p1, x1, x2, dist: float) -> np.ndarray:
    q = _triangulate(np.eye(3, 4), p1, x1, x2)
    with np.errstate(divide="ignore", invalid="ignore"):
        ok = q[2] * q[3] > 0
        q = q / q[3]
        ok &= q[2] < dist
        depth2 = (p1 @ q)[2]
        return ok & (depth2 > 0) & (depth2 < dist)


def recover_pose(e, mk1, mk2, k: np.ndarray, sampson_px: float = 2.0, dist: float = 1e4):
    """(R, t (3, 1), votes (N,) bool), or (None, None, zeros) where fewer than
    5 matches vote."""
    n = len(mk1)
    none = (None, None, np.zeros(n, dtype=bool))
    if n < 5:
        return none
    p1 = np.asarray(mk1, np.float64)[:, [1, 0]]
    p2 = np.asarray(mk2, np.float64)[:, [1, 0]]
    e = np.asarray(e, np.float64)
    k_inv = np.linalg.inv(k)
    h1 = np.concatenate([p1, np.ones((n, 1))], 1) @ k_inv.T
    h2 = np.concatenate([p2, np.ones((n, 1))], 1) @ k_inv.T
    l2, l1 = h1 @ e.T, h2 @ e
    s = (l2 * h2).sum(1) ** 2 / (l2[:, 0] ** 2 + l2[:, 1] ** 2 + l1[:, 0] ** 2 + l1[:, 1] ** 2
                                 + 1e-12)
    votes = s < (sampson_px / k[0, 0]) ** 2
    if votes.sum() < 5:
        return none
    centre, focal = np.array([k[0, 2], k[1, 2]]), np.array([k[0, 0], k[1, 1]])
    n1, n2 = (p1 - centre) / focal, (p2 - centre) / focal
    r1, r2, t = _decompose(e)
    cands = ((r1, t), (r2, t), (r1, -t), (r2, -t))
    masks = [_chirality(np.hstack([r, tc[:, None]]), n1, n2, dist) & votes for r, tc in cands]
    best = int(np.argmax([m.sum() for m in masks]))
    if masks[best].sum() < 5:
        return none
    r, tc = cands[best]
    return r, tc.reshape(3, 1), masks[best]


def gate(mk1, mk2, e, k: np.ndarray, g: dict):
    """The VO loop's verdict on one frame: (R, t, accepted, posed). ``posed``:
    the frame has enough matches and motion for the pose step, the only
    step that reads E; R and t are None where it did not run or found no
    pose; accepted where the pose has enough inliers, by count and by
    ratio."""
    n = len(mk1)
    if n < g["min_matches"]:
        return None, None, False, False
    if np.sqrt(np.mean(np.sum((mk2 - mk1) ** 2, axis=1))) < g["min_motion_pixels"]:
        return None, None, False, False
    r, t, inl = recover_pose(e, mk1, mk2, k)
    m = int(inl.sum())
    ok = r is not None and m >= g["min_matches"] and m / n >= g["min_inlier_ratio"]
    return r, t, ok, True
