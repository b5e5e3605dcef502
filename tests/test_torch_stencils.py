"""PyTorch port vs JAX: the separable stencils of the detect stage.

Same numpy inputs through both packages on the CPU. Tolerance: 1e-5 of the
map's max. Both sides use the same taps in the same order; what is left is
float32 rounding where the two libraries' kernels differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu.ops import filters as jf
from onnx_image_processing_tpu.ops.orientation import angle_moments as j_angle_moments
from onnx_image_processing_tpu.ops.shi_tomasi import shi_tomasi_score as j_shi_tomasi
from onnx_image_processing_tpu_torch.ops import filters as tf
from onnx_image_processing_tpu_torch.ops import angle_estimation, angle_moments, shi_tomasi_score

REL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close_to_max(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= REL_TOL * np.abs(ref).max()


@pytest.fixture(scope="module")
def batch_image():
    rng = np.random.default_rng(5)
    return rng.uniform(0, 255, (2, 1, 48, 72)).astype(np.float32)


@pytest.mark.parametrize("mode", ["edge", "zero", "neg_inf"])
def test_pad2d_matches_jax(mode, batch_image):
    x = batch_image[:, 0]
    np.testing.assert_array_equal(
        tf.pad2d(torch.from_numpy(x), 3, 5, mode=mode).numpy(),
        np.asarray(jf.pad2d(jnp.asarray(x), 3, 5, mode=mode)))


@pytest.mark.parametrize("taps", [[1.0, 2.0, 1.0], [-1.0, 0.0, 1.0], [0.0, 0.0]])
def test_conv1d_matches_jax(taps, batch_image):
    x = batch_image[:, 0]
    for t_fn, j_fn in ((tf.conv1d_h, jf.conv1d_h), (tf.conv1d_w, jf.conv1d_w)):
        np.testing.assert_array_equal(t_fn(torch.from_numpy(x), taps).numpy(),
                                      np.asarray(j_fn(jnp.asarray(x), taps)))


@pytest.mark.parametrize("block_size", [3, 5])
def test_shi_tomasi_score_matches_jax(block_size, gray_image, batch_image):
    for img in (gray_image, batch_image):
        _close_to_max(shi_tomasi_score(torch.from_numpy(img), block_size),
                      j_shi_tomasi(jnp.asarray(img), block_size=block_size))


def test_angle_moments_match_jax(gray_image, batch_image):
    for img in (gray_image, batch_image):
        t10, t01 = angle_moments(torch.from_numpy(img), patch_size=15, sigma=2.5)
        j10, j01 = j_angle_moments(jnp.asarray(img), patch_size=15, sigma=2.5)
        _close_to_max(t10, j10)
        _close_to_max(t01, j01)
    theta = angle_estimation(torch.from_numpy(gray_image))
    assert theta.shape == gray_image.shape
    assert float(theta.abs().max()) <= np.pi


def test_stencil_arguments_validated():
    img = torch.zeros((1, 1, 16, 16))
    with pytest.raises(ValueError):
        shi_tomasi_score(img, block_size=4)
    with pytest.raises(ValueError):
        angle_moments(img, patch_size=14)
