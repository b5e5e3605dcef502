"""App-level VO accuracy of the port on the CPU, held to the JAX package's
bars (``tests/test_vo_accuracy.py``).

The scenes (``make_sequence``) and the metrics (``evaluate``: ATE after a
Sim(3) alignment, per-step rotation and translation-direction errors, pose
failures) come from ``benchmarks/vo_accuracy.py``; the runners below are the
port's mirrors of its ``run_vo_ours``, ``run_vo_akaze`` and
``run_vo_ours_ingraph_e``: the port's matcher on ``device="cpu"``, its
host extraction (``utils.extract_matches``) and its pose step (``vo``).
The host RANSAC stacks (flagship, AKAZE) pose with ``cv2.findEssentialMat``
through ``vo.estimate_pose_ransac``; the in-graph-E stack poses with the
port's NumPy ``vo.recover_pose``.
"""

import numpy as np
import torch

from benchmarks.vo_accuracy import evaluate, make_sequence, run_vo_ours_ingraph_e
from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.utils import extract_matches
from onnx_image_processing_tpu_torch.vo import (CameraIntrinsics, estimate_pose_ransac,
                                                recover_pose)

FRAMES, H, W, KPTS = 24, 192, 256, 384
RANSAC, IRLS = 256, 2      # the in-graph-E stack: hypotheses, polish steps


def _intrinsics(k, frames):
    h, w = frames[0].shape
    return CameraIntrinsics(k[0, 0], k[1, 1], k[0, 2], k[1, 2], w, h)


def _image(frame):
    return torch.from_numpy(np.ascontiguousarray(frame[None, None], dtype=np.float32))


def run_vo_port(frames, k, model="shi_tomasi_angle_sparse_bad_sinkhorn",
                max_keypoints=KPTS, match_threshold=0.1, max_matches=256, **overrides):
    """The port's ``run_vo_ours`` / ``run_vo_akaze``: a two-image matcher,
    host extraction, host RANSAC pose, frame i -> i + 1."""
    intr = _intrinsics(k, frames)
    fn = models.build(model, device="cpu", max_keypoints=max_keypoints, **overrides)
    rel = []
    for a, b in zip(frames[:-1], frames[1:]):
        k1, k2, p = (o.numpy() for o in fn(_image(a), _image(b)))
        mk1, mk2, _ = extract_matches(p, k1, k2, threshold=match_threshold,
                                      max_matches=max_matches)
        r, t, _ = estimate_pose_ransac(mk1, mk2, intr)
        rel.append((r, t))
    return rel


def run_vo_port_ingraph_e(frames, k, max_keypoints=KPTS, match_threshold=0.1,
                          max_matches=256, irls_iters=0, ransac_hypotheses=0):
    """The port's ``run_vo_ours_ingraph_e``: the flagship essential pipeline
    (E in the graph), host extraction, the NumPy ``recover_pose``."""
    intr = _intrinsics(k, frames)
    fn = models.build("shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix", device="cpu",
                      max_keypoints=max_keypoints, essential_irls_iters=irls_iters,
                      essential_ransac_hypotheses=ransac_hypotheses)
    k_inv = torch.from_numpy(np.linalg.inv(k).astype(np.float32))
    rel = []
    for a, b in zip(frames[:-1], frames[1:]):
        k1, k2, p, e = (o.numpy() for o in fn(_image(a), _image(b), k_inv))
        mk1, mk2, _ = extract_matches(p, k1, k2, threshold=match_threshold,
                                      max_matches=max_matches)
        r, t, _ = recover_pose(e, mk1, mk2, intr)
        rel.append((r, t))
    return rel


def test_rotation_invariance_vo_roll_scene():
    """``test_vo_accuracy.py::test_rotation_invariance_vo_roll_scene``'s
    bars: under a 15 deg/frame camera roll the oriented flagship recovers
    the poses, and orientation buys rotation accuracy over the unoriented
    matcher."""
    frames, poses, k = make_sequence(FRAMES, H, W, scene="roll")
    flag = evaluate(run_vo_port(frames, k), poses, "port_roll_flagship")
    unori = evaluate(run_vo_port(frames, k, model="shi_tomasi_sparse_bad_sinkhorn"),
                     poses, "port_roll_unoriented")
    assert flag["pose_failures"] <= 2, flag
    assert flag["ate_rmse"] < 0.2, flag
    assert flag["rpe_rot_deg_mean"] < 0.62, flag
    assert flag["rpe_rot_deg_mean"] <= unori["rpe_rot_deg_mean"] - 0.06, (flag, unori)


def test_akaze_vo_accuracy_deep_scene():
    """``test_vo_accuracy.py::test_akaze_vo_accuracy_disposition_deep_scene``'s
    bars: AKAZE at NMS radius 5 against the flagship on the deep corridor."""
    frames, poses, k = make_sequence(FRAMES, H, W, scene="deep")
    flag = evaluate(run_vo_port(frames, k), poses, "port_flagship_384")
    akaze = evaluate(run_vo_port(frames, k, model="akaze_sparse_bad_sinkhorn", nms_radius=5),
                     poses, "port_akaze_384_nms5")
    assert akaze["pose_failures"] <= 2, akaze
    assert akaze["ate_rmse"] <= 1.3 * flag["ate_rmse"] + 0.03, (akaze, flag)
    assert akaze["rpe_rot_deg_mean"] <= flag["rpe_rot_deg_mean"] + 0.3, (akaze, flag)
    assert akaze["rpe_tdir_deg_mean"] <= 1.3 * flag["rpe_tdir_deg_mean"] + 2, (akaze, flag)


def test_ingraph_e_vo_accuracy_against_jax():
    """The in-graph-E stack (256 RANSAC hypotheses, 2 polish steps, the
    NumPy pose step) on the deep corridor, against the JAX package's
    ``run_vo_ours_ingraph_e`` (its cv2 pose step) on the same frames."""
    frames, poses, k = make_sequence(FRAMES, H, W, scene="deep")
    kw = dict(max_keypoints=KPTS, irls_iters=IRLS, ransac_hypotheses=RANSAC)
    port = evaluate(run_vo_port_ingraph_e(frames, k, **kw), poses, "port_ingraph_e")
    jax_ = evaluate(run_vo_ours_ingraph_e(frames, k, **kw), poses, "jax_ingraph_e")
    assert port["ate_rmse"] <= 1.3 * jax_["ate_rmse"] + 0.03, (port, jax_)
    assert abs(port["rpe_rot_deg_mean"] - jax_["rpe_rot_deg_mean"]) <= 0.3, (port, jax_)
    assert abs(port["pose_failures"] - jax_["pose_failures"]) <= 2, (port, jax_)
