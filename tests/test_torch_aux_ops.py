"""PyTorch port vs JAX: the ops without a registry pipeline of their own
(voxel downsampling, Otsu thresholds, depth ops, in-graph sub-pixel
refinement, the multiscale orientation, the NumPy outlier filters).

Same numpy inputs through both packages on the CPU. Tolerances:
- voxel downsampling: mask and M equal; centroids within 1e-5 of JAX's
  (JAX's first sort is unstable, the port's stable, so a voxel's residuals
  are summed in another order) and within 2e-4 of a float64 oracle at
  N = 38,400 (the JAX test's bar);
- thresholds equal, the binarized image equal;
- point clouds within 1e-5, normals within 1e-4, the aligned depth equal;
- refined keypoints and scores within 1e-6 of JAX's in-graph version, and
  of the port's host copy within the JAX test's 1e-5 (keypoints) and
  1e-3 + 1e-4 relative (scores; the host computes in float64);
- the multiscale orientation within 1e-4 rad of JAX's (the moments differ
  in the last bits, as in ``test_torch_heads.py``), and equal to the port's
  own single-scale orientation; the outlier filters equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu import ops as jops
from onnx_image_processing_tpu_torch import models, ops
from onnx_image_processing_tpu_torch.utils import refine_keypoints_subpixel as host_refine

VOXEL_ATOL = 1e-5
ORACLE_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- voxel downsampling ------------------------------------------------------

def _voxel_both(pts, leaf):
    out, mask = ops.voxel_downsampling(torch.from_numpy(pts), torch.tensor(np.float32(leaf)))
    j_out, j_mask = jops.voxel_downsampling(jnp.asarray(pts), jnp.asarray(np.float32(leaf)))
    return out.numpy(), mask.numpy(), np.asarray(j_out), np.asarray(j_mask)


def _voxel_f64_oracle(pts: np.ndarray, leaf: float):
    """Centroids per voxel in sorted-key order, float64 (the JAX test's oracle)."""
    vox = np.floor(pts.astype(np.float64) / leaf).astype(np.int64)
    vox -= vox.min(0)
    vmax = vox.max(0)
    key = vox[:, 0]
    for a in range(1, pts.shape[1]):
        key = key * (vmax[a] + 1) + vox[:, a]
    order = np.argsort(key, kind="stable")
    sk, sp = key[order], pts.astype(np.float64)[order]
    _, start = np.unique(sk, return_index=True)
    ends = np.append(start[1:], len(sk))
    return np.stack([sp[s:e].mean(0) for s, e in zip(start, ends)])


@pytest.mark.parametrize("n,leaf", [(200, 0.5), (400, 0.25), (700, 0.13)])
def test_voxel_matches_jax(n, leaf):
    """The residual prefix sum runs over all N points, so its rounding grows
    with N * leaf: these sizes keep it below 1e-5."""
    rng = np.random.default_rng(6)
    pts = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    out, mask, j_out, j_mask = _voxel_both(pts, leaf)
    assert out.shape == (n, 3) and out.dtype == np.float32 and mask.dtype == bool
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_allclose(out, j_out, atol=VOXEL_ATOL, rtol=0)
    m = int(mask.sum())
    assert 1 < m < n and mask[:m].all() and (out[m:] == 0).all()


def test_voxel_one_voxel_and_every_point_its_own():
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    out, mask, j_out, j_mask = _voxel_both(pts, 10.0)
    assert int(mask.sum()) == 1
    np.testing.assert_allclose(out[0], pts.mean(0), atol=VOXEL_ATOL)
    np.testing.assert_allclose(out, j_out, atol=VOXEL_ATOL, rtol=0)
    out, mask, j_out, j_mask = _voxel_both(pts, 1e-4)
    assert int(mask.sum()) == 200
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_allclose(out, j_out, atol=VOXEL_ATOL, rtol=0)


def test_voxel_single_point_and_duplicates():
    out, mask, _, _ = _voxel_both(np.array([[0.3, 0.4, 0.5]], np.float32), 1.0)
    assert mask.tolist() == [True]
    np.testing.assert_allclose(out[0], [0.3, 0.4, 0.5], atol=1e-6)
    dup = np.tile(np.array([[1.25, -0.5, 2.0]], np.float32), (17, 1))
    out, mask, j_out, j_mask = _voxel_both(dup, 0.1)
    assert int(mask.sum()) == 1
    np.testing.assert_allclose(out[0], dup[0], atol=VOXEL_ATOL)
    np.testing.assert_allclose(out, j_out, atol=VOXEL_ATOL, rtol=0)


@pytest.mark.parametrize("order", ["sorted", "reversed"])
def test_voxel_sorted_grids_match_the_oracle(order):
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, 9)] * 3),
                    -1).reshape(-1, 3).astype(np.float32)
    pts = grid if order == "sorted" else grid[::-1].copy()
    out, mask, j_out, j_mask = _voxel_both(pts, 0.37)
    oracle = _voxel_f64_oracle(pts, 0.37)
    m = int(mask.sum())
    assert m == len(oracle)
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_allclose(out[:m], oracle, atol=VOXEL_ATOL)
    np.testing.assert_allclose(out, j_out, atol=VOXEL_ATOL, rtol=0)


def test_voxel_int32_key_wraps_as_jax():
    """At a range / leaf ratio of 2e6 per axis the int32 key wraps: the
    centroids come out in the wrapped keys' order, as in JAX (an int64 key
    would order them otherwise)."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1000.0, 1000.0, (300, 3)).astype(np.float32)
    out, mask, j_out, j_mask = _voxel_both(pts, 1e-3)
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_allclose(out, j_out, atol=VOXEL_ATOL, rtol=0)


def test_voxel_precision_at_scale():
    """N = 38,400 in [-3, 3]^3, leaf 0.05: within 2e-4 of the float64 oracle."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 3, (38400, 3)).astype(np.float32)
    out, mask = ops.voxel_downsampling(torch.from_numpy(pts), torch.tensor(np.float32(0.05)))
    oracle = _voxel_f64_oracle(pts, 0.05)
    m = int(mask.sum())
    assert m == len(oracle)
    assert np.abs(out.numpy()[:m] - oracle).max() < ORACLE_ATOL


def test_voxel_registry_module():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (models.VOXEL_EXPORT_POINTS, 3)).astype(np.float32)
    fn = models.build("voxel_downsampling", device="cpu")
    out, mask = fn(torch.from_numpy(pts), torch.tensor(np.float32(0.1)))
    want, want_mask = ops.voxel_downsampling(torch.from_numpy(pts), 0.1)
    assert torch.equal(mask, want_mask) and torch.equal(out, want)
    with pytest.raises(ValueError, match="meta"):
        fn(torch.from_numpy(pts), torch.tensor(0.1, device="meta"))


# ---- thresholds --------------------------------------------------------------

@pytest.fixture(scope="module")
def int_image():
    rng = np.random.default_rng(11)
    a = rng.normal(60, 15, (60, 80))
    b = rng.normal(180, 20, (60, 80))
    pick = rng.uniform(size=(60, 80)) < 0.45
    return np.clip(np.where(pick, a, b), 0, 255).astype(np.int32)


@pytest.fixture(scope="module")
def trimodal_image():
    rng = np.random.default_rng(5)
    img = np.concatenate([rng.normal(40, 8, 2000), rng.normal(128, 8, 2000),
                          rng.normal(215, 8, 2000)])
    return np.clip(img, 0, 255).astype(np.int32).reshape(60, 100)


@pytest.mark.parametrize("image", ["int_image", "trimodal_image"])
def test_otsu_matches_jax(image, request):
    img = request.getfixturevalue(image)
    t, b = ops.otsu_threshold(torch.from_numpy(img), 0, 255)
    tj, bj = jops.otsu_threshold(jnp.asarray(img), 0, 255)
    assert t.dtype == torch.int32 and t.ndim == 0 and int(t) == int(tj)
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(b.numpy(), np.asarray(bj))


@pytest.mark.parametrize("n_class,max_val", [(2, 256), (3, 256), (3, 255), (4, 64)])
def test_multi_otsu_matches_jax(trimodal_image, n_class, max_val):
    img = np.minimum(trimodal_image, max_val) if max_val < 255 else trimodal_image
    got = ops.multi_otsu_threshold(torch.from_numpy(img), 0, max_val, n_class=n_class)
    want = jops.multi_otsu_threshold(jnp.asarray(img), 0, max_val, n_class=n_class)
    assert len(got) == n_class - 1
    assert [int(x) for x in got] == [int(x) for x in want]
    assert all(x.dtype == torch.int32 for x in got)


def test_multi_otsu_drops_values_past_its_bins_as_jax(trimodal_image):
    """BINS = max_val - min_val: with max_val=255 JAX's bincount drops every
    255 (and counts a negative value in bin 0); torch.bincount would grow
    the histogram instead and move the thresholds."""
    img = trimodal_image.copy()
    img[:25] = 255
    img[-1, :40] = -3
    got = ops.multi_otsu_threshold(torch.from_numpy(img), 0, 255, n_class=3)
    want = jops.multi_otsu_threshold(jnp.asarray(img), 0, 255, n_class=3)
    assert [int(x) for x in got] == [int(x) for x in want]
    counted = ops.multi_otsu_threshold(
        torch.bincount(torch.from_numpy(img).reshape(-1).clamp(min=0),
                       minlength=256)[:255], 0, 255, n_class=3, calc_hist=False)
    assert [int(x) for x in counted] == [int(x) for x in want]
    grown = torch.bincount(torch.from_numpy(img).reshape(-1).clamp(min=0), minlength=255)
    assert grown.shape[0] == 256


def test_multi_otsu_from_a_histogram_and_rejects_one_class(trimodal_image):
    hist = np.bincount(trimodal_image.reshape(-1), minlength=256)[:256].astype(np.float32)
    got = ops.multi_otsu_threshold(torch.from_numpy(hist), 0, 256, calc_hist=False)
    want = jops.multi_otsu_threshold(jnp.asarray(hist), 0, 256, calc_hist=False)
    assert [int(x) for x in got] == [int(x) for x in want]
    with pytest.raises(ValueError, match="n_class"):
        ops.multi_otsu_threshold(torch.from_numpy(hist), 0, 256, n_class=1)


# ---- depth -------------------------------------------------------------------

def test_depth_to_pointcloud_matches_jax():
    rng = np.random.default_rng(2)
    depth = rng.uniform(100, 5000, (48, 64)).astype(np.float32)
    kw = dict(cx=32.0, cy=24.0, fx=50.0, fy=52.0, scale=0.001)
    got = ops.depth_to_pointcloud(torch.from_numpy(depth), **kw).numpy()
    want = np.asarray(jops.depth_to_pointcloud(jnp.asarray(depth), **kw))
    assert got.shape == (48, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    got3 = ops.depth_to_pointcloud(torch.from_numpy(depth[..., None]), **kw).numpy()
    np.testing.assert_array_equal(got3, got)


def test_depth_to_pointcloud_with_normal_matches_jax():
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 5.0, (32, 40, 1)).astype(np.float32)
    kw = dict(cx=20.0, cy=16.0, fx=30.0, fy=30.0)
    pcd, n = ops.depth_to_pointcloud_with_normal(torch.from_numpy(depth), **kw)
    pj, nj = jops.depth_to_pointcloud_with_normal(jnp.asarray(depth), **kw)
    np.testing.assert_allclose(pcd.numpy(), np.asarray(pj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n.numpy(), np.asarray(nj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(n.numpy(), axis=-1), 1.0, atol=1e-5)


def test_transform_and_projection_match_jax():
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1, 3, (20, 30, 3)).astype(np.float32)
    pts[0, :5, 2] = 0.0
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    trans = rng.normal(size=3).astype(np.float32)
    got = ops.transform_points(torch.from_numpy(pts), torch.from_numpy(rot),
                               torch.from_numpy(trans)).numpy()
    want = np.asarray(jops.transform_points(jnp.asarray(pts), jnp.asarray(rot),
                                            jnp.asarray(trans)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    kw = dict(cx=31.5, cy=24.0, fx=40.0, fy=41.0)
    px, py = ops.points_to_pixels(torch.from_numpy(pts), **kw)
    pxj, pyj = jops.points_to_pixels(jnp.asarray(pts), **kw)
    np.testing.assert_array_equal(px.numpy(), np.asarray(pxj))
    np.testing.assert_array_equal(py.numpy(), np.asarray(pyj))
    assert (px.numpy()[0, :5] == 0).all() and (py.numpy()[0, :5] == 0).all()


def _alignment_case():
    """Intrinsics under which the last column and row project into
    [W - 0.5, W) and [H - 0.5, H): the right / lower neighbour of such a
    projection is past the image. Returns the inputs and the projections."""
    rng = np.random.default_rng(4)
    h, w = 40, 56
    depth = rng.uniform(0.5, 3.0, (h, w)).astype(np.float32)
    rot = np.eye(3, dtype=np.float32)
    trans = np.array([0.005, 0.005, 0.0], np.float32)
    kw = dict(width=w, height=h, depth_cx=w / 2, depth_cy=h / 2, depth_fx=40.0,
              depth_fy=40.0, rgb_cx=w / 2 + 0.4, rgb_cy=h / 2 + 0.4, rgb_fx=40.0,
              rgb_fy=40.0)
    pts = ops.transform_points(ops.depth_to_pointcloud(
        torch.from_numpy(depth), kw["depth_cx"], kw["depth_cy"], kw["depth_fx"],
        kw["depth_fy"]).reshape(-1, 3), torch.from_numpy(rot), torch.from_numpy(trans))
    px, py = (p.numpy() for p in ops.points_to_pixels(pts, kw["rgb_cx"], kw["rgb_cy"],
                                                        kw["rgb_fx"], kw["rgb_fy"]))
    return depth, rot, trans, kw, px, py


def test_depth_alignment_matches_jax_at_the_right_and_lower_edges():
    depth, rot, trans, kw, px, py = _alignment_case()
    h, w = depth.shape
    got = ops.depth_alignment(torch.from_numpy(depth), torch.from_numpy(rot),
                              torch.from_numpy(trans), **kw).numpy()
    want = np.asarray(jops.depth_alignment(jnp.asarray(depth), jnp.asarray(rot),
                                           jnp.asarray(trans), **kw))
    inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    assert ((px >= w - 0.5) & inside).sum() > 20 and ((py >= h - 0.5) & inside).sum() > 20
    assert got.shape == (h, w) and (got > 0).mean() > 0.9
    np.testing.assert_array_equal(got, want)


def test_depth_alignment_without_the_spare_slot_would_differ():
    """A flat index ``y * W + x`` that dropped only the updates past the
    last pixel would put each x = W neighbour on the next row's first pixel:
    the JAX package drops it, and so does the port."""
    depth, rot, trans, kw, px, py = _alignment_case()
    h, w = depth.shape
    want = np.asarray(jops.depth_alignment(jnp.asarray(depth), jnp.asarray(rot),
                                           jnp.asarray(trans), **kw))
    got = ops.depth_alignment(torch.from_numpy(depth), torch.from_numpy(rot),
                              torch.from_numpy(trans), **kw).numpy()
    oob = (px < 0) | (px >= w) | (py < 0) | (py >= h)
    px, py = np.where(oob, 0.0, px), np.where(oob, 0.0, py)
    x0, x1 = np.trunc(px - 0.5).astype(int), np.trunc(px + 0.5).astype(int)
    y0, y1 = np.trunc(py - 0.5).astype(int), np.trunc(py + 0.5).astype(int)
    flat = np.concatenate([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1])
    naive = np.full(h * w, 10000.0, np.float32)
    keep = flat < h * w
    np.minimum.at(naive, flat[keep], np.tile(depth.reshape(-1), 4)[keep])
    naive = np.where(naive == 10000.0, 0.0, naive).reshape(h, w)
    assert (naive[1:, 0] != want[1:, 0]).sum() > 5
    np.testing.assert_array_equal(got, want)


# ---- keypoints and orientation -----------------------------------------------

def test_refine_keypoints_subpixel_matches_jax_and_the_host_copy(gray_image):
    scores = np.array(jops.shi_tomasi_score(jnp.asarray(gray_image), block_size=5))[:, 0]
    kj, sj = jops.select_topk_keypoints(jnp.asarray(scores),
                                        jops.nms_maxpool(jnp.asarray(scores), 3), 64)
    kpts, ks = np.asarray(kj).copy(), np.asarray(sj).copy()
    # Border and invalid keypoints pass through.
    kpts[0, -3:] = [[0.0, 10.0], [119.0, 159.0], [-1.0, -1.0]]
    ks[0, -1] = 0.0
    rk, rs = ops.refine_keypoints_subpixel(torch.from_numpy(scores), torch.from_numpy(kpts),
                                           torch.from_numpy(ks))
    rkj, rsj = jops.refine_keypoints_subpixel(jnp.asarray(scores), jnp.asarray(kpts),
                                              jnp.asarray(ks))
    np.testing.assert_allclose(rk.numpy(), np.asarray(rkj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(rs.numpy(), np.asarray(rsj), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(rk.numpy()[0, -3:], kpts[0, -3:])
    assert np.abs(rk.numpy() - kpts).max() > 0.05
    only = ops.refine_keypoints_subpixel(torch.from_numpy(scores), torch.from_numpy(kpts))
    assert torch.equal(only, rk)

    host_in = np.concatenate([kpts[0], ks[0][:, None]], axis=1)
    valid = host_in[:, 0] >= 0
    host_out = host_refine(scores[0], host_in[valid])
    np.testing.assert_allclose(rk.numpy()[0][valid], host_out[:, :2], atol=1e-5)
    np.testing.assert_allclose(rs.numpy()[0][valid], host_out[:, 2], atol=1e-3, rtol=1e-4)


def test_angle_estimation_multiscale_matches_jax(gray_image):
    got, scale = ops.angle_estimation_multiscale(torch.from_numpy(gray_image), num_scales=3)
    want, j_scale = jops.angle_estimation_multiscale(jnp.asarray(gray_image), num_scales=3)
    assert got.shape == scale.shape == gray_image.shape
    d = np.abs(got.numpy() - np.asarray(want))
    assert np.minimum(d, 2 * np.pi - d).max() <= 1e-4
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
    assert torch.equal(got, ops.angle_estimation(torch.from_numpy(gray_image)))


# ---- host outlier filters ----------------------------------------------------

def test_outlier_filters_equal_the_originals():
    rng = np.random.default_rng(12)
    p = rng.dirichlet(np.ones(33), size=33).astype(np.float32)
    p[:5, :5] += np.eye(5, dtype=np.float32) * 2
    for ratio in (1.2, 2.0):
        np.testing.assert_array_equal(ops.probability_ratio_filter(p[:32, :32], ratio),
                                      jops.probability_ratio_filter(p[:32, :32], ratio))
    for margin in (0.0, 0.3):
        np.testing.assert_array_equal(ops.dustbin_margin_filter(p, margin),
                                      jops.dustbin_margin_filter(p, margin))
    assert ops.probability_ratio_filter(p[:1, :1]).tolist() == [True]
