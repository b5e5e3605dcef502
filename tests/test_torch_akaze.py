"""PyTorch port vs JAX: the AKAZE detector, its ladder kernel's plain
version and the AKAZE matcher slice, on the CPU.

Same numpy inputs through both packages. Tolerances, each stated where it
is used: the stencils 1e-5 of the map's max (float32 rounding where the two
libraries' kernels differ); the ladder the JAX package's own kernel-vs-oracle
bounds (scores atol 1e-3, moments 5e-3, NMS survivors differ on < 1e-4 of
pixels); the matcher equal keypoints, or at most 2 swaps per image, with P
within 5e-3 on the common keypoints.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu.kernels.akaze_ladder import akaze_ladder as j_ladder
from onnx_image_processing_tpu.ops import akaze as ja
from onnx_image_processing_tpu.ops import filters as jf
from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.kernels import akaze_ladder
from onnx_image_processing_tpu_torch.models.shi_tomasi_family import _select_keypoints
from onnx_image_processing_tpu_torch.ops import akaze as ta
from onnx_image_processing_tpu_torch.ops import filters as tf
from onnx_image_processing_tpu_torch.ops import (BADTable, angle_moments, load_bad_params,
                                                sample_nearest, sparse_bad)

REL_TOL = 1e-5
P_ATOL = 5e-3
K = 128
NAMES = ("akaze", "akaze_sparse_bad_sinkhorn", "akaze_sparse_bad_sinkhorn_extraction")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def batch_image():
    rng = np.random.default_rng(11)
    return rng.uniform(0, 255, (2, 1, 64, 96)).astype(np.float32)


def _close_to_max(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= REL_TOL * np.abs(ref).max()


@pytest.mark.parametrize("radius", [1, 2, 4])
def test_maxpool_zero_mode_matches_jax(radius, batch_image):
    x = batch_image[:, 0] - 128.0   # negative cells make the zero border visible
    got = tf.maxpool2d_same(torch.from_numpy(x), radius, pad_mode="zero").numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jf.maxpool2d_same(jnp.asarray(x), radius, pad_mode="zero")))
    assert (got[:, 0, 0] >= 0).all()


@pytest.mark.parametrize("stage", ["diffusion", "hessian", "moments"])
def test_akaze_stages_match_jax(stage, batch_image):
    img = batch_image
    if stage == "diffusion":
        _close_to_max(ta.nonlinear_diffusion(torch.from_numpy(img), 3, 0.05),
                      ja.nonlinear_diffusion(jnp.asarray(img), num_iterations=3, kappa=0.05))
    elif stage == "hessian":
        diffused = np.array(ja.nonlinear_diffusion(jnp.asarray(img)))
        got = ta.hessian_score(torch.from_numpy(diffused), 0.001, 5).numpy()
        want = np.asarray(ja.hessian_score(jnp.asarray(diffused), 0.001, 5))
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
        assert ((got > 0) != (want > 0)).mean() < 1e-4
        assert (want > 0).sum() > 50
    else:
        # The port's AKAZE moments are angle_moments (zero padding).
        t10, t01 = angle_moments(torch.from_numpy(img), 15, 2.5)
        j10, j01 = ja._moments_zero(jnp.asarray(img[:, 0]), 15, 2.5)
        _close_to_max(t10[:, 0], j10)
        _close_to_max(t01[:, 0], j01)


def test_ladder_plain_matches_jax_kernel_interpret():
    rng = np.random.default_rng(23)
    img = rng.uniform(0, 255, (2, 96, 128)).astype(np.float32)
    s_t, m10_t, m01_t = (o.numpy() for o in akaze_ladder.akaze_ladder_plain(torch.from_numpy(img)))
    s_k, m10_k, m01_k = (np.asarray(o) for o in j_ladder(jnp.asarray(img), interpret=True))
    assert s_t.shape == (2, 3, 96, 128)
    np.testing.assert_allclose(s_t, s_k, atol=1e-3, rtol=0)
    np.testing.assert_allclose(m10_t, m10_k, atol=5e-3, rtol=0)
    np.testing.assert_allclose(m01_t, m01_k, atol=5e-3, rtol=0)
    assert ((s_t > 0) != (s_k > 0)).mean() < 1e-4
    # On a CPU tensor the wrapper is its plain version and launches nothing.
    before = akaze_ladder.LAUNCHES.count
    s_w = akaze_ladder.akaze_ladder(torch.from_numpy(img))[0].numpy()
    np.testing.assert_array_equal(s_w, s_t)
    assert akaze_ladder.LAUNCHES.count == before


def test_akaze_detect_matches_jax(gray_image):
    scores_t, orient_t = (o.numpy() for o in ta.akaze_detect(torch.from_numpy(gray_image)))
    scores_j, orient_j = (np.asarray(o) for o in ja.akaze_detect(jnp.asarray(gray_image)))
    assert scores_t.shape == orient_t.shape == gray_image.shape
    _close_to_max(scores_t, scores_j)
    assert ((scores_t > 0) != (scores_j > 0)).mean() < 1e-4
    # Orientations: atan2 of moments that agree to float32 rounding; 1e-4 rad.
    np.testing.assert_allclose(orient_t, orient_j, atol=1e-4, rtol=0)


def test_sampled_angles_equal_dense_orientation(gray_image_pair):
    """The per-keypoint tie-normalized select of sampled parts equals the
    dense orientation map sampled at the keypoints, bit for bit (nearest
    gather commutes with the elementwise select), and so do the descriptors
    made with ``angles=`` and with ``orientation=``."""
    images = torch.from_numpy(np.concatenate(gray_image_pair, axis=0))
    cfg = models.get("akaze_sparse_bad_sinkhorn").defaults.with_(max_keypoints=96,
                                                                 num_pairs=256)
    table = BADTable(load_bad_params(256))
    ss, m10, m01 = ta.akaze_detect_parts(images)
    kpts, _ = _select_keypoints(ss.amax(dim=0)[:, None], cfg, table.max_radius)
    ky, kx = kpts[..., 0], kpts[..., 1]

    _, orient_dense = ta._scale_select(ss, torch.atan2(m01, m10))
    theta_dense = sample_nearest(orient_dense[:, 0], ky, kx)

    at_k = lambda m: torch.stack([sample_nearest(s, ky, kx) for s in m])
    ss_k = at_k(ss)
    tie = (ss_k == ss_k.amax(dim=0, keepdim=True)).to(torch.float32)
    tie = tie / torch.clamp_min(tie.sum(dim=0, keepdim=True), 1.0)
    theta_sampled = (torch.atan2(at_k(m01), at_k(m10)) * tie).sum(dim=0)
    assert torch.equal(theta_sampled, theta_dense)

    d_dense = sparse_bad(images, kpts, table, orientation=orient_dense)
    d_angles = sparse_bad(images, kpts, table, angles=theta_sampled)
    assert torch.equal(d_dense, d_angles)
    with pytest.raises(ValueError):
        sparse_bad(images, kpts, table, orientation=orient_dense, angles=theta_sampled)


def _common_index(a, b):
    inv_a = {tuple(v): i for i, v in enumerate(a.tolist())}
    inv_b = {tuple(v): i for i, v in enumerate(b.tolist())}
    shared = sorted(set(inv_a) & set(inv_b))
    return (np.array([inv_a[v] for v in shared] + [len(a)]),
            np.array([inv_b[v] for v in shared] + [len(b)]),
            len(set(inv_a) ^ set(inv_b)))


@pytest.mark.parametrize("name", NAMES[1:])
def test_akaze_matcher_matches_jax(name, gray_image_pair):
    img1, img2 = gray_image_pair
    fn_j = jax_models.build(name, max_keypoints=K)
    out_j = [np.asarray(o) for o in fn_j(jnp.asarray(img1), jnp.asarray(img2))]
    fn_t = models.build(name, max_keypoints=K, device="cpu")
    out_t = [o.numpy() for o in fn_t(torch.from_numpy(img1), torch.from_numpy(img2))]
    if name.endswith("_extraction"):
        mk1, mk2, s, v = out_t
        assert v.sum() > 20
        np.testing.assert_array_equal(v, out_j[3])
        np.testing.assert_array_equal(mk1, out_j[0])
        np.testing.assert_array_equal(mk2, out_j[1])
        np.testing.assert_allclose(s, out_j[2], atol=P_ATOL, rtol=0)
        # gray_image_pair's second image is the first rolled by (5, 8) px.
        d = (mk2 - mk1)[v]
        assert abs(np.median(d[:, 0]) - 5) <= 0.5 and abs(np.median(d[:, 1]) - 8) <= 0.5
        return
    (k1t, k2t, pt), (k1j, k2j, pj) = out_t, out_j
    assert pt.shape == pj.shape == (1, K + 1, K + 1)
    assert (k1t[0, :, 0] >= 0).sum() > K // 4
    ia1, ib1, s1 = _common_index(k1t[0], k1j[0])
    ia2, ib2, s2 = _common_index(k2t[0], k2j[0])
    assert max(s1, s2) <= 2, f"keypoint sets differ by {s1}, {s2}"
    np.testing.assert_allclose(pt[0][np.ix_(ia1, ia2)], pj[0][np.ix_(ib1, ib2)],
                               atol=P_ATOL, rtol=0)


def test_akaze_head_matches_jax(gray_image):
    scores_t, orient_t = (o.numpy() for o in
                          models.build("akaze", device="cpu")(torch.from_numpy(gray_image)))
    scores_j, orient_j = (np.asarray(o) for o in
                          jax_models.build("akaze")(jnp.asarray(gray_image)))
    _close_to_max(scores_t, scores_j)
    np.testing.assert_allclose(orient_t, orient_j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_akaze_registry_defaults_match_jax(name):
    assert models.get(name).defaults == jax_models.get(name).defaults
    if name != "akaze":
        d = models.get(name).defaults
        assert (d.num_pairs, d.max_keypoints, d.epsilon, d.nms_radius, d.binarize) == (
            512, 1024, 0.05, 3, False)


def test_akaze_modules_check_devices(gray_image):
    det = models.build("akaze", device="cpu")
    assert det.device == torch.device("cpu")
    with pytest.raises(ValueError):
        det(torch.from_numpy(gray_image).to("meta"))
    matcher = models.build("akaze_sparse_bad_sinkhorn", device="cpu")
    with pytest.raises(ValueError):
        matcher(torch.from_numpy(gray_image), torch.from_numpy(gray_image).to("meta"))
    with pytest.raises(NotImplementedError):
        models.build("akaze_sparse_bad_sinkhorn", distance_type="l1", device="cpu")
