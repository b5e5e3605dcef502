"""PyTorch port vs JAX: the single-image heads on the CPU (``gray_image``,
120x160, registry defaults otherwise).

- ``shi_tomasi``: scores within 1e-5 of the map's max (CPU ``sqrt`` may
  differ from XLA's in the last bit).
- ``shi_tomasi_angle``: scores as above, angles within 1e-4 rad on the
  circle (the moments may differ in their last bits between the libraries,
  and atan2 magnifies that where both moments are small: 1.3e-5 rad seen).
- ``shi_tomasi_bad``: scores as above, the dense map (raw responses at the
  registry defaults) within 1e-4.
- ``shi_tomasi_angle_sparse_bad``: keypoints equal (or at most 2 swaps),
  scores within 1e-5 of their max and descriptors within 1e-4 on the
  common keypoints but for under 1e-3 of the entries (a rotated sample
  landing within an ulp of a rounding boundary); with ``fused_detect`` the
  port agrees with its own unfused head in keypoints and, on the common
  keypoints, in descriptors within 2e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.kernels import launch_counts, reset_launch_counts
from test_torch_flagship import _common_index

HEADS = ["shi_tomasi", "shi_tomasi_angle", "shi_tomasi_bad", "shi_tomasi_angle_sparse_bad"]
K = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(name, img, **kw):
    jout = jax_models.build(name, **kw)(jnp.asarray(img))
    tout = models.build(name, device="cpu", **kw)(torch.from_numpy(img))
    if not isinstance(jout, (tuple, list)):
        jout, tout = (jout,), (tout,)
    return [np.asarray(o) for o in jout], [o.numpy() for o in tout]


def _assert_scores(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_shi_tomasi_matches_jax(gray_image):
    (want,), (got,) = _run("shi_tomasi", gray_image)
    assert got.shape == (1, 1, 120, 160)
    _assert_scores(got, want)


def test_shi_tomasi_angle_matches_jax(gray_image):
    (sj, aj), (st, at) = _run("shi_tomasi_angle", gray_image)
    _assert_scores(st, sj)
    d = np.abs(at - aj)
    assert np.minimum(d, 2 * np.pi - d).max() <= 1e-4


def test_shi_tomasi_bad_matches_jax(gray_image):
    (sj, mj), (st, mt) = _run("shi_tomasi_bad", gray_image)
    _assert_scores(st, sj)
    assert mt.shape == mj.shape == (1, 256, 120, 160)
    np.testing.assert_allclose(mt, mj, atol=1e-4, rtol=0)


def test_shi_tomasi_angle_sparse_bad_matches_jax(gray_image):
    (kj, sj, dj), (kt, st, dt) = _run("shi_tomasi_angle_sparse_bad", gray_image,
                                      max_keypoints=K)
    assert kt.shape == (1, K, 2) and dt.shape == (1, K, 256)
    assert (kt[0, :, 0] >= 0).sum() > K // 2
    it, ij, swaps = _common_index(kt[0], kj[0])
    assert swaps <= 2
    it, ij = it[:-1], ij[:-1]   # drop the dustbin index _common_index appends
    assert np.abs(st[0][it] - sj[0][ij]).max() <= 1e-5 * np.abs(sj).max()
    assert (np.abs(dt[0][it] - dj[0][ij]) > 1e-4).mean() < 1e-3


def test_shi_tomasi_angle_sparse_bad_fused_matches_unfused(gray_image):
    img = torch.from_numpy(gray_image)
    kx, _, dx = (t.numpy() for t in models.build(
        "shi_tomasi_angle_sparse_bad", max_keypoints=K, device="cpu")(img))
    reset_launch_counts()
    kf, _, df = (t.numpy() for t in models.build(
        "shi_tomasi_angle_sparse_bad", max_keypoints=K, fused_detect=True, device="cpu")(img))
    assert all(c == 0 for c in launch_counts().values())
    ix, jf, swaps = _common_index(kx[0], kf[0])
    assert swaps <= 2
    np.testing.assert_allclose(df[0][jf[:-1]], dx[0][ix[:-1]], atol=2e-3, rtol=0)


def test_heads_select_without_border_margin(gray_image):
    """The single-image head selects with margin 0 (the reference detector's
    default); a margin in the config is honoured."""
    head = models.build("shi_tomasi_angle_sparse_bad", max_keypoints=512, device="cpu")
    k = head(torch.from_numpy(gray_image))[0].numpy()[0]
    k = k[k[:, 0] >= 0]
    near_border = (k[:, 0] < 7) | (k[:, 1] < 7) | (k[:, 0] > 112) | (k[:, 1] > 152)
    assert near_border.any()
    head = models.build("shi_tomasi_angle_sparse_bad", max_keypoints=512, border_margin=7,
                        device="cpu")
    k = head(torch.from_numpy(gray_image))[0].numpy()[0]
    k = k[k[:, 0] >= 0]
    assert ((k >= 7) & (k <= [112, 152])).all()


@pytest.mark.parametrize("name", HEADS)
def test_head_registry_defaults_match_jax(name):
    ours, theirs = models.get(name).defaults, jax_models.get(name).defaults
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_heads_move_with_their_table(gray_image):
    head = models.build("bad", device="cpu")
    assert head.device == torch.device("cpu") and head.table.num_pairs == 256
    with pytest.raises(ValueError):
        head(torch.from_numpy(gray_image).to("meta"))
    assert head.to("meta").table.thresholds.device.type == "meta"
