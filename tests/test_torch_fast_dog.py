"""PyTorch port vs JAX: the FAST and DoG detectors, their registry heads,
and the registry's full list of names.

Same numpy inputs through both packages on the CPU. FAST maps (0 or 1) must
be equal, and so must the keypoints selected on them (all ties: the lowest
index goes first). DoG bands and scores agree within 1e-4 on [0, 255]
images: both sides use the same float32 taps in the same order, but the two
libraries round their multiply-adds differently (a few ulps at 255).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu.ops import dog_responses as j_dog_responses
from onnx_image_processing_tpu.ops import dog_score as j_dog_score
from onnx_image_processing_tpu.ops import fast_score as j_fast_score
from onnx_image_processing_tpu.ops import nms_select_topk as j_nms_select_topk
from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.kernels import launch_counts, reset_launch_counts
from onnx_image_processing_tpu_torch.ops import dog_responses, dog_score, fast_score, nms_select_topk

DOG_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def batch_image():
    rng = np.random.default_rng(9)
    return np.round(rng.uniform(0, 255, (2, 1, 40, 56))).astype(np.float32)


@pytest.mark.parametrize("threshold,use_nms,nms_radius",
                         [(20.0, False, 3), (10.0, True, 3), (30.0, True, 2)])
def test_fast_matches_jax(gray_image, batch_image, threshold, use_nms, nms_radius):
    for img in (gray_image, batch_image):
        got = fast_score(torch.from_numpy(img), threshold=threshold, use_nms=use_nms,
                         nms_radius=nms_radius).numpy()
        want = np.asarray(j_fast_score(jnp.asarray(img), threshold=threshold,
                                       use_nms=use_nms, nms_radius=nms_radius))
        assert got.shape == img.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < got.size


def test_fast_detects_synthetic_corner():
    """A bright square on a dark background fires at its corners only."""
    img = np.zeros((1, 1, 32, 32), np.float32)
    img[:, :, 10:22, 10:22] = 200.0
    got = fast_score(torch.from_numpy(img), threshold=20.0).numpy()[0, 0]
    assert got.sum() > 0
    assert got[13:19, 13:19].sum() == 0
    np.testing.assert_array_equal(got, np.asarray(j_fast_score(jnp.asarray(img)))[0, 0])


@pytest.mark.parametrize("topk_mode", ["block", "sort"])
def test_keypoints_on_the_fast_tie_map_match_jax(gray_image, topk_mode):
    """Every FAST score is 1: selection keeps JAX's lowest-index-first order."""
    img = gray_image
    t = fast_score(torch.from_numpy(img), threshold=10.0)[:, 0]
    j = j_fast_score(jnp.asarray(img), threshold=10.0)[:, 0]
    kt, st = nms_select_topk(t, 64, 0.0, 8, nms_radius=2, topk_mode=topk_mode)
    kj, sj = j_nms_select_topk(j, 64, 0.0, 8, nms_radius=2, topk_mode=topk_mode,
                               use_pallas=False)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st.numpy() == 1.0).sum() == 64


@pytest.mark.parametrize("num_scales", [3, 5])
def test_dog_matches_jax(gray_image, batch_image, num_scales):
    for img in (gray_image, batch_image):
        bands = dog_responses(torch.from_numpy(img), num_scales=num_scales).numpy()
        score = dog_score(torch.from_numpy(img), num_scales=num_scales).numpy()
        j_bands = np.asarray(j_dog_responses(jnp.asarray(img), num_scales=num_scales))
        j_score = np.asarray(j_dog_score(jnp.asarray(img), num_scales=num_scales))
        assert bands.shape == (img.shape[0], num_scales - 1) + img.shape[2:]
        assert score.shape == img.shape
        np.testing.assert_allclose(bands, j_bands, atol=DOG_ATOL, rtol=0)
        np.testing.assert_allclose(score, j_score, atol=DOG_ATOL, rtol=0)
        assert np.abs(j_bands).max() > 1.0


def test_dog_explicit_kernel_size_matches_jax(batch_image):
    kw = dict(num_scales=4, sigma_base=1.2, sigma_ratio=1.5, kernel_size=9)
    np.testing.assert_allclose(dog_score(torch.from_numpy(batch_image), **kw).numpy(),
                               np.asarray(j_dog_score(jnp.asarray(batch_image), **kw)),
                               atol=DOG_ATOL, rtol=0)


@pytest.mark.parametrize("kw,match", [(dict(kernel_size=8), "odd"),
                                      (dict(num_scales=1), "at least 2")])
def test_dog_rejects_what_jax_rejects(kw, match):
    img = torch.zeros((1, 1, 16, 16))
    with pytest.raises(ValueError, match=match):
        dog_responses(img, **kw)
    with pytest.raises(ValueError, match=match):
        j_dog_responses(jnp.zeros((1, 1, 16, 16)), **kw)


def test_registry_names_equal_jax():
    assert models.names() == jax_models.names()
    assert len(models.names()) == 24


@pytest.mark.parametrize("name", ["fast", "dog", "dog_with_score"])
def test_registry_heads_match_jax(name, gray_image):
    ours = models.get(name).defaults
    assert dataclasses.asdict(ours) == dataclasses.asdict(jax_models.get(name).defaults)
    head = models.build(name, device="cpu")
    reset_launch_counts()
    got = head(torch.from_numpy(gray_image)).numpy()
    assert all(c == 0 for c in launch_counts().values())
    want = np.asarray(jax_models.build(name)(jnp.asarray(gray_image)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=DOG_ATOL, rtol=0)


def test_registry_fast_overrides_reach_the_op(gray_image):
    kw = dict(fast_threshold=30.0, fast_use_nms=True, fast_nms_radius=2)
    got = models.build("fast", device="cpu", **kw)(torch.from_numpy(gray_image)).numpy()
    np.testing.assert_array_equal(
        got, fast_score(torch.from_numpy(gray_image), 30.0, True, 2).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jax_models.build("fast", **kw)(jnp.asarray(gray_image))))
    default = models.build("fast", device="cpu")(torch.from_numpy(gray_image)).numpy()
    assert not np.array_equal(got, default)


def test_registry_dog_overrides_reach_the_op(gray_image):
    kw = dict(dog_num_scales=4, dog_sigma_base=2.0, dog_sigma_ratio=1.5)
    got = models.build("dog_with_score", device="cpu", **kw)(torch.from_numpy(gray_image))
    np.testing.assert_array_equal(
        got.numpy(), dog_score(torch.from_numpy(gray_image), 4, 2.0, 1.5).numpy())
    want = jax_models.build("dog_with_score", **kw)(jnp.asarray(gray_image))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DOG_ATOL, rtol=0)
    bands = models.build("dog", device="cpu", dog_num_scales=3)(torch.from_numpy(gray_image))
    assert bands.shape == (1, 2, 120, 160)
