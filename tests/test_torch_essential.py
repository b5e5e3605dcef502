"""PyTorch port vs JAX: the essential-matrix pipelines, the standalone
registry entries, and the pass-through of ``k_inv`` by ``MatchExtraction``.

The scene is a camera translating in x over a non-planar texture
(:func:`parallax_pair`): a pure image shift, like ``gray_image_pair``, makes
the 8-point system degenerate (a 3-dim null space), and any E in it fits.

Tolerances: keypoints equal; P within the flagship's 5e-3; E (unit norm, up
to sign) within 1e-3 end to end, where the two P differ by ~2e-5; the
port's solve fed JAX's own keypoints, scores and P within 1e-4, and within
1e-3 for RANSAC, whose hypothesis solves run a float32 Cholesky at
condition ~1e6 (each moves by 1e-3..1e-2 in either library) before the
inlier refit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu.ops import extract_mutual_matches as j_extract
from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.models.essential_family import essential_from_match
from test_torch_geometry import _unit_diff

H, W = 120, 160
P_ATOL = 5e-3
E_ATOL = 1e-3
E_GEOMETRY_ATOL = {"ls": 1e-4, "irls": 1e-4, "ransac": 1e-3}
FLAGSHIP = "shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix"
AKAZE = "akaze_sparse_bad_sinkhorn_essential_matrix"
SIZES = {FLAGSHIP: dict(max_keypoints=128), AKAZE: dict(max_keypoints=64)}
MODES = {"ls": {}, "irls": dict(essential_irls_iters=2),
         "ransac": dict(essential_ransac_hypotheses=32, essential_irls_iters=2)}


def _blur(a, r):
    k = 2 * r + 1
    for ax in (0, 1):
        pad = [(r + 1, r) if i == ax else (0, 0) for i in range(2)]
        c = np.cumsum(np.pad(a, pad, mode="edge"), axis=ax)
        n = c.shape[ax]
        a = (np.take(c, range(k, n), axis=ax) - np.take(c, range(0, n - k), axis=ax)) / k
    return a


def parallax_pair(h=H, w=W, shift=6.0, seed=3):
    """Two (1, 1, h, w) float32 frames of a camera translating in x over a
    textured surface whose inverse depth is a smooth non-affine field in
    [0.6, 1.4]: frame 1 samples the texture at x + shift * d(x, y)."""
    rng = np.random.default_rng(seed)
    tex = _blur(_blur(_blur(rng.uniform(0, 1, (h, w + int(2 * shift) + 4)), 2), 2), 2)
    tex = 255 * (tex - tex.min()) / (tex.max() - tex.min())
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    d = 1 + 0.4 * np.sin(2 * np.pi * xx / w * 1.3 + 0.7) * np.cos(2 * np.pi * yy / h * 0.9)
    frames = []
    for c in (0.0, shift):
        xs = xx + c * d
        x0 = np.floor(xs).astype(int)
        f = xs - x0
        img = ((1 - f) * np.take_along_axis(tex, x0, 1) + f * np.take_along_axis(tex, x0 + 1, 1)
               + rng.normal(0, 2, (h, w)))
        frames.append(np.clip(img, 0, 255).astype(np.float32)[None, None])
    return tuple(frames)


def k_inv_of(h=H, w=W):
    """The VO CLI's default intrinsics (fx = fy = 0.8 w, centred)."""
    fx = 0.8 * w
    return np.linalg.inv(np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    return parallax_pair(), k_inv_of()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", [FLAGSHIP, AKAZE])
def test_essential_pipeline_matches_jax(name, mode, scene):
    (img1, img2), k_inv = scene
    kw = dict(SIZES[name], **MODES[mode])
    k1, k2, p, e = (t.numpy() for t in models.build(name, device="cpu", **kw)(
        torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(k_inv)))
    jk1, jk2, jp, je = (np.asarray(t) for t in jax_models.build(name, **kw)(
        jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(k_inv)))
    k = kw["max_keypoints"]
    assert p.shape == (1, k + 1, k + 1) and e.shape == (3, 3)
    assert (k1[0, :, 0] >= 0).sum() > k // 2
    np.testing.assert_array_equal(k1, jk1)
    np.testing.assert_array_equal(k2, jk2)
    np.testing.assert_allclose(p, jp, atol=P_ATOL, rtol=0)
    assert _unit_diff(e, je) < E_ATOL
    s = np.linalg.svd(e.astype(np.float64), compute_uv=False)
    assert s[2] < 1e-5 * s[0]

    # The solve alone: JAX's own keypoints, scores and P into the port.
    extract, _ = jax_models.build_streaming(name, **kw)
    (_, js1, _), (_, js2, _) = extract(jnp.asarray(img1)), extract(jnp.asarray(img2))
    cfg = models.get(name).defaults.with_(**kw)
    e_geo = essential_from_match(*(torch.from_numpy(np.array(a)) for a in (
        jk1, js1, jk2, js2, jp)), torch.from_numpy(k_inv), cfg).numpy()
    assert _unit_diff(e_geo, je) < E_GEOMETRY_ATOL[mode]


@pytest.mark.parametrize("name", [FLAGSHIP, AKAZE])
def test_essential_pipelines_require_batch_one(name, scene):
    (img1, img2), k_inv = scene
    fn = models.build(name, device="cpu", max_keypoints=32)
    both1 = torch.from_numpy(np.concatenate([img1, img1]))
    both2 = torch.from_numpy(np.concatenate([img2, img2]))
    with pytest.raises(ValueError, match="batch size 1"):
        fn(both1, both2, torch.from_numpy(k_inv))


def test_match_extraction_passes_k_inv_through(scene):
    """``MatchExtraction`` hands every input to the matcher, so an essential
    pipeline wrapped with mutual-NN extraction takes ``k_inv`` and returns
    E after the extraction outputs."""
    (img1, img2), k_inv = scene
    inputs = (torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(k_inv))
    matcher = models.build(FLAGSHIP, device="cpu", max_keypoints=64, max_matches=32)
    wrapped = models.with_match_extraction(matcher)
    assert wrapped.device == matcher.device
    mk1, mk2, scores, valid, e = wrapped(*inputs)
    k1, k2, p, e_direct = matcher(*inputs)
    assert torch.equal(e, e_direct)
    want = j_extract(jnp.asarray(p.numpy()), jnp.asarray(k1.numpy()), jnp.asarray(k2.numpy()),
                     max_matches=32, threshold=matcher.cfg.match_threshold)
    for got, ref in zip((mk1, mk2, scores, valid), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert valid.sum() > 8


@pytest.mark.parametrize("name", [
    "shi_tomasi_sparse_bad_sinkhorn", "shi_tomasi_sparse_bad_sinkhorn_extraction",
    "shi_tomasi_angle_sparse_bad_sinkhorn_with_filters",
    "shi_tomasi_angle_sparse_bad_sinkhorn_with_filters_extraction",
    FLAGSHIP, AKAZE, "sinkhorn", "essential_matrix_estimator"])
def test_registry_defaults_match_jax(name):
    spec, jspec = models.get(name), jax_models.get(name)
    assert dataclasses.asdict(spec.defaults) == dataclasses.asdict(jspec.defaults)
    assert spec.takes_k_inv == jspec.takes_k_inv


def test_standalone_sinkhorn_matches_jax():
    rng = np.random.default_rng(2)
    d1, d2 = (rng.normal(0, 0.5, (1, 40, 64)).astype(np.float32) for _ in range(2))
    got = models.build("sinkhorn", device="cpu")(torch.from_numpy(d1), torch.from_numpy(d2))
    want = jax_models.build("sinkhorn", use_pallas=False)(jnp.asarray(d1), jnp.asarray(d2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_standalone_essential_estimator_matches_jax():
    """The grid estimator entry (a sqrt(K) x sqrt(K) grid; K = 64 here)."""
    p = np.random.default_rng(3).uniform(0, 1, (65, 65)).astype(np.float32)
    k_inv = np.linalg.inv(np.array([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]])).astype(np.float32)
    fn = models.build("essential_matrix_estimator", device="cpu", max_keypoints=64)
    got = fn(torch.from_numpy(p), torch.from_numpy(k_inv)).numpy()
    want = np.asarray(jax_models.build("essential_matrix_estimator", max_keypoints=64)(
        jnp.asarray(p), jnp.asarray(k_inv)))
    assert _unit_diff(got, want) < 1e-4
    with pytest.raises(ValueError):
        fn(torch.from_numpy(p), torch.from_numpy(k_inv).to("meta"))
