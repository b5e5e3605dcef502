"""The port's NumPy pose step (``vo/pose.py`` ``recover_pose``,
``triangulate_points``) against the JAX package's, which calls OpenCV
(``cv2.recoverPose``, ``cv2.triangulatePoints``), on seeded two-view scenes.

R and t agree within 1e-6 (both float64; the SVDs differ in the last
bits), and the inlier masks in at most one point per scene: a point whose
triangulated depth lies within rounding of 0 or of ``distance_thresh`` may
fall on either side.
"""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from onnx_image_processing_tpu import vo as jvo
from onnx_image_processing_tpu_torch import vo as tvo
from onnx_image_processing_tpu_torch.vo.pose import _triangulate_dlt, decompose_essential

ROOT = Path(__file__).resolve().parents[1]
W, H = 256, 192


def _rot(axis, deg):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = np.radians(deg)
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k


def _intrinsics(cls):
    return cls(0.9 * W, 0.9 * W, W / 2, H / 2, W, H)


def two_view_scene(seed, n=120, outliers=0.0, noise_px=0.3, e_noise=0.0):
    """Points in front of camera 1, a small motion (x2 = R x1 + t), both
    views projected to (y, x) pixels with noise; a share of the matches
    replaced by random pixels; E = [t]x R, optionally perturbed."""
    rng = np.random.default_rng(seed)
    k = _intrinsics(tvo.CameraIntrinsics).K
    pts = np.c_[rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 12, n)]
    r = _rot(rng.normal(size=3), rng.uniform(1, 8))
    t = rng.normal(size=3) * [1, 0.3, 0.5]
    t /= np.linalg.norm(t)
    t *= rng.uniform(0.2, 0.6)

    def project(x):
        uv = x @ k.T
        return (uv[:, :2] / uv[:, 2:])[:, ::-1] + rng.normal(0, noise_px, (n, 2))

    kp1, kp2 = project(pts), project(pts @ r.T + t)
    bad = rng.random(n) < outliers
    kp2[bad] = np.c_[rng.uniform(0, H, bad.sum()), rng.uniform(0, W, bad.sum())]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    e = tx @ r + e_noise * rng.normal(size=(3, 3))
    return e / np.linalg.norm(e), kp1.astype(np.float32), kp2.astype(np.float32), r, t


SCENES = [dict(seed=s, **kw) for s, kw in enumerate([
    {}, {}, dict(e_noise=1e-3), dict(outliers=0.2), dict(outliers=0.4, e_noise=5e-4),
    dict(n=30), dict(noise_px=1.0, outliers=0.1)])]


@pytest.mark.parametrize("sampson_px", [2.0, None])
@pytest.mark.parametrize("distance_thresh", [1e4, 20.0])
@pytest.mark.parametrize("scene", SCENES, ids=lambda s: f"seed{s['seed']}")
def test_recover_pose_matches_opencv(scene, sampson_px, distance_thresh):
    e, kp1, kp2, _, _ = two_view_scene(**scene)
    kw = dict(sampson_px=sampson_px, distance_thresh=distance_thresh)
    r_j, t_j, m_j = jvo.recover_pose(e, kp1, kp2, _intrinsics(jvo.CameraIntrinsics), **kw)
    r_t, t_t, m_t = tvo.recover_pose(e, kp1, kp2, _intrinsics(tvo.CameraIntrinsics), **kw)
    assert (r_j is None) == (r_t is None)
    assert m_t.dtype == bool and m_t.shape == m_j.shape
    assert int((m_j != m_t).sum()) <= 1
    if r_j is not None:
        assert r_t.shape == (3, 3) and t_t.shape == (3, 1)
        np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-6)
        np.testing.assert_allclose(t_t, t_j, rtol=0, atol=1e-6)


def test_recover_pose_finds_the_true_motion():
    """A clean scene: the pose is the true one, and the small depth bound
    cuts the votes of the far points."""
    e, kp1, kp2, r, t = two_view_scene(0, noise_px=0.1)
    intr = _intrinsics(tvo.CameraIntrinsics)
    r_t, t_t, mask = tvo.recover_pose(e, kp1, kp2, intr)
    assert np.abs(r_t - r).max() < 1e-3
    assert np.degrees(np.arccos(np.clip(t_t.ravel() @ t / np.linalg.norm(t), -1, 1))) < 0.5
    assert mask.sum() >= 0.95 * len(kp1)
    _, _, near = tvo.recover_pose(e, kp1, kp2, intr, distance_thresh=20.0)
    assert 5 <= near.sum() < mask.sum()


def test_recover_pose_rejects_too_few_points():
    e, kp1, kp2, _, _ = two_view_scene(1)
    intr = _intrinsics(tvo.CameraIntrinsics)
    r, t, mask = tvo.recover_pose(e, kp1[:4], kp2[:4], intr)
    assert r is None and t is None and mask.shape == (4,) and not mask.any()
    # Every match an outlier of E: fewer than 5 Sampson votes.
    rng = np.random.default_rng(0)
    junk = rng.uniform(0, H, kp2.shape).astype(np.float32)
    assert tvo.recover_pose(e, kp1, junk, intr)[0] is None
    assert jvo.recover_pose(e, kp1, junk, _intrinsics(jvo.CameraIntrinsics))[0] is None


@pytest.mark.parametrize("seed", range(4))
def test_decompose_essential_gives_opencvs_candidates(seed):
    """The four candidates are OpenCV's (t up to its sign, R1 and R2 as a set)."""
    e = two_view_scene(seed, e_noise=1e-3)[0]
    r1, r2, t = decompose_essential(e)
    c1, c2, ct = cv2.decomposeEssentialMat(e)
    ours = sorted([r1.ravel().tolist(), r2.ravel().tolist()])
    theirs = sorted([c1.ravel().tolist(), c2.ravel().tolist()])
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-9)
    assert min(np.abs(t - ct.ravel()).max(), np.abs(t + ct.ravel()).max()) < 1e-9


@pytest.mark.parametrize("seed", range(3))
def test_triangulate_points_matches_opencv(seed):
    e, kp1, kp2, r, t = two_view_scene(seed, outliers=0.1)
    intr_t, intr_j = _intrinsics(tvo.CameraIntrinsics), _intrinsics(jvo.CameraIntrinsics)
    args = (np.eye(3), np.zeros(3), r, t)
    ours = tvo.triangulate_points(kp1, kp2, *args, intr_t)
    theirs = jvo.triangulate_points(kp1, kp2, *args, intr_j)
    assert ours.shape == theirs.shape == (len(kp1), 3)
    np.testing.assert_allclose(ours, theirs, rtol=1e-7, atol=1e-9)

    # The homogeneous solutions themselves, up to sign.
    p1 = intr_t.K @ np.eye(3, 4)
    p2 = intr_t.K @ np.hstack([r, t[:, None]])
    x1, x2 = kp1[:, ::-1].astype(np.float64), kp2[:, ::-1].astype(np.float64)
    q = _triangulate_dlt(p1, p2, x1, x2)
    qc = cv2.triangulatePoints(p1, p2, x1.T.copy(), x2.T.copy())
    sign = np.sign((q * qc).sum(0))
    np.testing.assert_allclose(q * sign, qc, rtol=0, atol=1e-9)


def test_recover_pose_runs_without_opencv():
    """With ``cv2`` unimportable the NumPy pose step runs (and agrees with
    this process's run); the host RANSAC raises plainly."""
    e, kp1, kp2, _, _ = two_view_scene(3, outliers=0.2)
    r, t, mask = tvo.recover_pose(e, kp1, kp2, _intrinsics(tvo.CameraIntrinsics))
    code = f"""
import sys
sys.modules['cv2'] = None
import numpy as np
from onnx_image_processing_tpu_torch import vo
assert vo.pose.cv2 is None
intr = vo.CameraIntrinsics({0.9 * W}, {0.9 * W}, {W / 2}, {H / 2}, {W}, {H})
e = np.array({e.tolist()})
kp1 = np.array({kp1.tolist()}, np.float32)
kp2 = np.array({kp2.tolist()}, np.float32)
r, t, mask = vo.recover_pose(e, kp1, kp2, intr)
x = vo.triangulate_points(kp1, kp2, np.eye(3), np.zeros(3), r, t, intr)
assert np.isfinite(x).all()
try:
    vo.estimate_pose_ransac(kp1, kp2, intr)
except ImportError:
    pass
else:
    raise AssertionError("estimate_pose_ransac ran without OpenCV")
print(repr((r.tolist(), t.ravel().tolist(), int(mask.sum()))))
"""
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT,
                         capture_output=True, text=True).stdout
    r_s, t_s, n_s = eval(out.strip().splitlines()[-1])
    np.testing.assert_array_equal(np.array(r_s), r)
    np.testing.assert_array_equal(np.array(t_s), t.ravel())
    assert n_s == int(mask.sum())
