"""PyTorch port vs JAX: the dense-BAD family on the CPU.

Same numpy inputs from a seed through both packages:

- the stencils ``sep_conv2d``, ``box_sum2d``, ``box_average_bank`` (1e-4 on
  [0, 255] data) and the samplers ``sample_bilinear``, ``sample_bank_fused``
  (1e-4);
- ``dense_bad`` by static shifts at 256 and 512 pairs: soft-binarized within
  1e-4, hard-binarized bits equal but for under 1e-3 of them (a bank value
  an ulp off flips a bit whose response sits on its threshold);
- the oriented ``dense_bad`` by gather against JAX's gather and by tiles
  (the port's sampler) against JAX's ``oriented_route="tiled"``, each within
  2e-3, JAX's own bound (``tests/test_bad_parity.py:183``);
- ``extract_descriptors_at_keypoints`` (exact) and ``..._subpixel`` (1e-4);
- the dense matcher ``shi_tomasi_bad_sinkhorn[_extraction]`` end to end:
  keypoints equal and P within 5e-3, permutation-aware as in
  ``test_torch_flagship.py``; its streaming split equals the two-image call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu.ops import bad as jbad
from onnx_image_processing_tpu.ops import filters as jfilters
from onnx_image_processing_tpu.ops import sampling as jsampling
from onnx_image_processing_tpu.ops import extract_mutual_matches as j_extract
from onnx_image_processing_tpu_torch import models, ops
from test_torch_flagship import _common_index

DENSE = "shi_tomasi_bad_sinkhorn"
K = 128
MAX_MATCHES = 64
P_ATOL = 5e-3
ORIENTED_ATOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _image(seed, shape=(2, 1, 48, 64)):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


@pytest.mark.parametrize("name", ["sep_conv2d", "box_sum2d", "box_average_bank"])
def test_filters_match_jax(name):
    x = _image(1)[:, 0]
    col = np.array([1.0, 2.0, 0.0, -1.0, 0.5], np.float32)
    row = np.array([0.25, 0.5, 0.25], np.float32)
    calls = {
        "sep_conv2d": (lambda f, a: f.sep_conv2d(a, col, row, mode="edge")),
        "box_sum2d": (lambda f, a: f.box_sum2d(a, 5)),
        "box_average_bank": (lambda f, a: f.box_average_bank(a, 7)),
    }
    want = np.asarray(calls[name](jfilters, jnp.asarray(x)))
    got = calls[name](ops.filters, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _coords(rng, shape, h, w):
    """Sample coordinates past both borders, with integer and half-way taps."""
    y = rng.uniform(-3, h + 2, shape).astype(np.float32)
    x = rng.uniform(-3, w + 2, shape).astype(np.float32)
    y.flat[:4] = [0.0, h - 1.0, 2.5, 7.0]
    x.flat[:4] = [w - 1.0, 0.0, 3.5, 1.25]
    return y, x


def test_sample_bilinear_matches_jax():
    rng = np.random.default_rng(2)
    img = _image(2)[:, 0]
    y, x = _coords(rng, (2, 300), 48, 64)
    want = np.asarray(jsampling.sample_bilinear(jnp.asarray(img), jnp.asarray(y), jnp.asarray(x)))
    got = ops.sample_bilinear(torch.from_numpy(img), torch.from_numpy(y), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_sample_bank_fused_matches_jax(mode):
    rng = np.random.default_rng(3)
    bank = _image(3, (2, 8, 48, 64))
    y, x = _coords(rng, (2, 5, 40), 48, 64)
    chan = rng.integers(0, 8, (1, 5, 1)).astype(np.int32)
    want = np.asarray(jsampling.sample_bank_fused(jnp.asarray(bank), jnp.asarray(chan),
                                                  jnp.asarray(y), jnp.asarray(x), mode=mode))
    got = ops.sample_bank_fused(torch.from_numpy(bank), torch.from_numpy(chan),
                                torch.from_numpy(y), torch.from_numpy(x), mode=mode)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        ops.sample_bank_fused(torch.from_numpy(bank), torch.from_numpy(chan),
                              torch.from_numpy(y), torch.from_numpy(x), mode="cubic")


@pytest.fixture(scope="module")
def static_raw():
    """JAX's raw static-shift map (no binarization) per pair count, on one
    image; jitted, since eager JAX dispatches each of the 2P shifts."""
    img = _image(4, (1, 1, 48, 64))
    cache = {}

    def get(pairs):
        if pairs not in cache:
            jp = jbad.load_bad_params(pairs)
            cache[pairs] = np.asarray(jax.jit(lambda i: jbad.dense_bad(i, jp))(jnp.asarray(img)))
        return img, cache[pairs]
    return get


@pytest.mark.parametrize("pairs,soft", [(256, True), (256, False), (512, True), (512, False)])
def test_dense_bad_static_matches_jax(pairs, soft, static_raw):
    img, raw = static_raw(pairs)
    want = np.asarray(jbad._finalize(jnp.asarray(raw), True, soft, 10.0))
    table = ops.BADTable(ops.load_bad_params(pairs))
    got = ops.dense_bad(torch.from_numpy(img), table, binarize=True, soft_binarize=soft).numpy()
    assert got.shape == want.shape == (1, pairs, 48, 64)
    if soft:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        assert (got != want).mean() < 1e-3


def test_dense_bad_raw_and_route_validation(static_raw):
    img, want = static_raw(256)
    table = ops.BADTable(ops.load_bad_params(256))
    got = ops.dense_bad(torch.from_numpy(img), table).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        ops.dense_bad(torch.from_numpy(img), table, oriented_route="fast")


@pytest.fixture(scope="module")
def oriented():
    rng = np.random.default_rng(6)
    img = _image(6, (1, 1, 40, 56))
    theta = rng.uniform(-np.pi, np.pi, img.shape).astype(np.float32)
    table = ops.BADTable(ops.load_bad_params(256))
    return img, theta, table, jbad.load_bad_params(256)


@pytest.mark.parametrize("route", ["gather", "tiled"])
def test_dense_bad_oriented_matches_jax(route, oriented):
    img, theta, table, jp = oriented
    want = np.asarray(jax.jit(lambda i, t: jbad.dense_bad(
        i, jp, orientation=t, oriented_route=route))(jnp.asarray(img), jnp.asarray(theta)))
    got = ops.dense_bad(torch.from_numpy(img), table, orientation=torch.from_numpy(theta),
                        oriented_route=route).numpy()
    assert got.shape == (1, 256, 40, 56)
    np.testing.assert_allclose(got, want, atol=ORIENTED_ATOL, rtol=0)
    if route == "gather":   # 'auto' takes the gather route on a CPU tensor
        auto = ops.dense_bad(torch.from_numpy(img), table, orientation=torch.from_numpy(theta))
        np.testing.assert_array_equal(auto.numpy(), got)


def test_extract_descriptors_at_keypoints_match_jax():
    rng = np.random.default_rng(7)
    dmap = _image(7, (2, 16, 30, 40))
    kp = np.stack([rng.integers(0, 30, (2, 25)), rng.integers(0, 40, (2, 25))],
                  -1).astype(np.float32)
    want = np.asarray(jbad.extract_descriptors_at_keypoints(jnp.asarray(dmap), jnp.asarray(kp)))
    got = ops.extract_descriptors_at_keypoints(torch.from_numpy(dmap), torch.from_numpy(kp))
    np.testing.assert_array_equal(got.numpy(), want)
    sub = kp + rng.uniform(-0.5, 0.5, kp.shape).astype(np.float32)
    want = np.asarray(jbad.extract_descriptors_at_keypoints_subpixel(
        jnp.asarray(dmap), jnp.asarray(sub)))
    got = ops.extract_descriptors_at_keypoints_subpixel(torch.from_numpy(dmap),
                                                        torch.from_numpy(sub))
    assert got.shape == (2, 25, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def dense_out(gray_image_pair):
    img1, img2 = gray_image_pair
    jax_out = tuple(np.asarray(o) for o in jax_models.build(DENSE, max_keypoints=K)(
        jnp.asarray(img1), jnp.asarray(img2)))
    port = models.build(DENSE, max_keypoints=K, device="cpu")
    port_out = tuple(o.numpy() for o in port(torch.from_numpy(img1), torch.from_numpy(img2)))
    return jax_out, port_out


def test_dense_matcher_keypoints_and_p_match_jax(dense_out):
    (k1j, k2j, pj), (k1t, k2t, pt) = dense_out
    assert pt.shape == pj.shape == (1, K + 1, K + 1)
    assert (k1t[0, :, 0] >= 0).sum() > K // 4
    ia1, ib1, s1 = _common_index(k1t[0], k1j[0])
    ia2, ib2, s2 = _common_index(k2t[0], k2j[0])
    assert max(s1, s2) <= 2, f"keypoint sets differ by {s1}, {s2}"
    np.testing.assert_allclose(pt[0][np.ix_(ia1, ia2)], pj[0][np.ix_(ib1, ib2)],
                               atol=P_ATOL, rtol=0)


def test_dense_matcher_extraction_matches_jax(gray_image_pair, dense_out):
    img1, img2 = gray_image_pair
    k1j, k2j, pj = dense_out[0]
    mk1_j, mk2_j, s_j, v_j = (np.asarray(o) for o in j_extract(
        jnp.asarray(pj), jnp.asarray(k1j), jnp.asarray(k2j),
        max_matches=MAX_MATCHES, threshold=0.1))
    fn = models.build(DENSE + "_extraction", max_keypoints=K, max_matches=MAX_MATCHES,
                      device="cpu")
    mk1, mk2, s, v = (o.numpy() for o in fn(torch.from_numpy(img1), torch.from_numpy(img2)))
    assert v.sum() > MAX_MATCHES // 2
    np.testing.assert_array_equal(v, v_j)
    np.testing.assert_array_equal(mk1, mk1_j)
    np.testing.assert_array_equal(mk2, mk2_j)
    np.testing.assert_allclose(s, s_j, atol=P_ATOL, rtol=0)
    d = (mk2 - mk1)[v]   # gray_image_pair's second image is the first rolled by (5, 8)
    assert abs(np.median(d[:, 0]) - 5) <= 0.5 and abs(np.median(d[:, 1]) - 8) <= 0.5


def test_dense_streaming_equals_two_image(gray_image_pair):
    img1, img2 = (torch.from_numpy(i) for i in gray_image_pair)
    extract, match = models.build_streaming(DENSE + "_extraction", device="cpu",
                                            max_keypoints=K, max_matches=MAX_MATCHES)
    two = models.build(DENSE + "_extraction", device="cpu", max_keypoints=K,
                       max_matches=MAX_MATCHES)
    for a, b in zip(match(extract(img1), extract(img2)), two(img1, img2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    fn = models.shi_tomasi_bad_sinkhorn_match
    module = two.matcher
    for a, b in zip(fn(img1, img2, module.cfg, module.table), module(img1, img2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", [DENSE, DENSE + "_extraction", "bad"])
def test_dense_registry_defaults_match_jax(name):
    ours, theirs = models.get(name).defaults, jax_models.get(name).defaults
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
