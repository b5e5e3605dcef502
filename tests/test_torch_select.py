"""PyTorch port vs JAX: the select frontend and keypoint top-k.

The port's plain select frontend (the CPU side of its CUDA kernel) must be
bit-identical to the JAX Pallas kernel run in interpret mode: every output
is a max, a compare or a copy. Top-k must keep lax.top_k's rule that equal
values go lowest index first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu.kernels import select_frontend as j_sf
from onnx_image_processing_tpu.ops import nms_maxpool as j_nms_maxpool
from onnx_image_processing_tpu.ops import nms_select_topk as j_nms_select_topk
from onnx_image_processing_tpu.ops import select_topk_keypoints as j_select
from onnx_image_processing_tpu_torch.kernels import select_frontend as t_sf
from onnx_image_processing_tpu_torch.ops import (nms_maxpool, nms_select_topk,
                                                 select_topk_keypoints)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tie_map(seed=77, shape=(2, 120, 160)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 5, shape) / 4.0).astype(np.float32)


def _assert_block_grids_equal(s, r, thr, margin):
    bm_t, bi_t = t_sf.nms_block_reduce(torch.from_numpy(s), r, thr, margin)
    bm_j, bi_j = j_sf.nms_block_reduce(jnp.asarray(s), r, thr, margin,
                                       interpret=True)
    assert bi_t.dtype == torch.int32
    np.testing.assert_array_equal(bm_t.numpy(), np.asarray(bm_j))
    np.testing.assert_array_equal(bi_t.numpy(), np.asarray(bi_j))


@pytest.mark.parametrize("h,w,r,margin,thr,b", [
    (120, 160, 5, 7, 0.0, 2),     # flagship radius and margin
    (64, 80, 1, 4, 0.0, 2),       # minimum radius
    (123, 217, 3, 8, 0.05, 2),    # odd, non-multiple-of-block sizes
    (96, 128, 7, 10, 0.0, 1),     # largest radius the TPU kernel takes
])
def test_select_plain_bitexact_vs_pallas_interpret(h, w, r, margin, thr, b):
    rng = np.random.default_rng(h * 7 + w)
    _assert_block_grids_equal(rng.random((b, h, w), dtype=np.float32),
                              r, thr, margin)


def test_select_plain_ties_bitexact_vs_pallas_interpret():
    """Quantized scores with massive in-block ties: the minimum-index rule."""
    _assert_block_grids_equal(_tie_map(), 3, 0.1, 8)


@pytest.mark.parametrize("mode", ["block", "sort"])
def test_nms_select_topk_ties_match_jax(mode):
    """Keypoints and scores exactly equal on a tie map, where only the
    lowest-index-first rule decides which tied candidates fill K."""
    s = _tie_map(seed=3)
    k_t, s_t = nms_select_topk(torch.from_numpy(s), 200, 0.0, 7, nms_radius=5,
                               topk_mode=mode)
    k_j, s_j = j_nms_select_topk(jnp.asarray(s), 200, 0.0, 7, nms_radius=5,
                                 topk_mode=mode, use_pallas=False)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_nms_select_topk_random_and_tiny_maps_match_jax():
    rng = np.random.default_rng(101)
    s = rng.random((2, 123, 217), dtype=np.float32)
    k_t, s_t = nms_select_topk(torch.from_numpy(s), 64, 0.01, 8, nms_radius=3)
    k_j, s_j = j_nms_select_topk(jnp.asarray(s), 64, 0.01, 8, nms_radius=3,
                                 use_pallas=False)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    # Fewer blocks than slots: both take the flat path; invalid slots pad.
    tiny = rng.random((1, 16, 24), dtype=np.float32)
    k_t, _ = nms_select_topk(torch.from_numpy(tiny), 64, 0.0, 2, nms_radius=3)
    k_j, _ = j_nms_select_topk(jnp.asarray(tiny), 64, 0.0, 2, nms_radius=3,
                               use_pallas=False)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    assert (k_t.numpy()[0, -1] == -1).all()


@pytest.mark.parametrize("nms_radius", [None, 3])
def test_select_topk_keypoints_matches_jax(nms_radius):
    """The unfused selection (mask given) in flat and block mode."""
    s = np.random.default_rng(7).random((2, 90, 110), dtype=np.float32)
    mask_t = nms_maxpool(torch.from_numpy(s), 3)
    mask_j = j_nms_maxpool(jnp.asarray(s), 3)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    k_t, s_t = select_topk_keypoints(torch.from_numpy(s), mask_t, 100, 0.05, 6,
                                     nms_radius=nms_radius)
    k_j, s_j = j_select(jnp.asarray(s), mask_j, 100, 0.05, 6, nms_radius=nms_radius)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_nms_select_topk_rejects_unported_mode():
    """``topk_mode="approx"`` equals JAX's approximate selection off a TPU
    (where ``lax.approx_max_k`` is the exact top-k) bit for bit, on the
    input of ``tests/test_detector_parity.py::test_topk_approx_mode_plumbing``;
    an unknown mode raises."""
    s = np.random.default_rng(11).uniform(0, 10, (2, 120, 161)).astype(np.float32)
    k_j, s_j = j_select(jnp.asarray(s), j_nms_maxpool(jnp.asarray(s), 5), 100, 0.0, 4,
                        nms_radius=5, approx=True)
    k_t, s_t = nms_select_topk(torch.from_numpy(s), 100, 0.0, 4, nms_radius=5,
                               topk_mode="approx")
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    k_b, s_b = nms_select_topk(torch.from_numpy(s), 100, 0.0, 4, nms_radius=5)
    assert torch.equal(k_t, k_b) and torch.equal(s_t, s_b)
    with pytest.raises(ValueError, match="unknown topk_mode"):
        nms_select_topk(torch.zeros((1, 32, 32)), 8, topk_mode="exact")


def _jax_block_topk(s, k, thr, margin, r):
    k_j, s_j = j_nms_select_topk(jnp.asarray(s), k, thr, margin, nms_radius=r,
                                 topk_mode="block", use_pallas=False)
    return np.asarray(k_j), np.asarray(s_j)


@pytest.mark.parametrize("kind,k,thr", [
    ("ties", 200, 0.0),        # quantized map: the lowest block index wins a tie
    ("ties", 600, 0.0),        # the whole 20 x 30 block grid (K = Hb * Wb)
    ("random", 600, 0.0),      # K = Hb * Wb on a float map
    ("random", 64, 0.2),       # a threshold
    ("sparse", 300, 0.0),      # K above the count of positive blocks
    ("signed", 150, -0.3),     # score_threshold < 0: negative maxima stay invalid
])
def test_nms_select_blocks_plain_matches_jax(kind, k, thr):
    """The fused select's plain version (the CPU side of its CUDA kernel)
    equals JAX's block-mode nms_select_topk: keypoints, scores and the
    invalid slots, bit for bit."""
    rng = np.random.default_rng(len(kind) * 31 + k)
    h, w, r, margin = 120, 180, 5, 7
    if kind == "ties":
        s = _tie_map(seed=k, shape=(2, h, w))
    elif kind == "sparse":
        s = rng.random((2, h, w), dtype=np.float32) * (rng.random((2, h, w)) < 0.002)
        s = s.astype(np.float32)
    else:
        s = rng.random((2, h, w), dtype=np.float32)
        if kind == "signed":
            s = (s - 0.6).astype(np.float32)
    k_t, s_t = t_sf.nms_select_blocks(torch.from_numpy(s), r, k, thr, margin)
    k_j, s_j = _jax_block_topk(s, k, thr, margin, r)
    np.testing.assert_array_equal(k_t.numpy(), k_j)
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    assert k_t.shape == (2, k, 2) and k_t.dtype == torch.float32
    if kind == "sparse":
        assert (k_t.numpy()[:, -1] == -1).all() and (s_t.numpy()[:, -1] == 0).all()


def test_nms_select_topk_block_mode_is_the_fused_select():
    """nms_select_topk in block mode returns nms_select_blocks' result."""
    s = np.random.default_rng(9).random((2, 96, 128), dtype=np.float32)
    want = t_sf.nms_select_blocks(torch.from_numpy(s), 3, 100, 0.01, 8)
    got = nms_select_topk(torch.from_numpy(s), 100, 0.01, 8, nms_radius=3)
    for g, e in zip(got, want):
        assert torch.equal(g, e)


@pytest.mark.parametrize("name,kw", [
    ("shi_tomasi_angle_sparse_bad_sinkhorn", dict(fused_detect=True)),
    ("akaze_sparse_bad_sinkhorn", {})])
def test_approx_routes_select_as_block(name, kw):
    """The fused detect's and AKAZE's selection take ``approx`` as ``block``:
    the pipelines' outputs are equal bit for bit."""
    from onnx_image_processing_tpu_torch import models

    rng = np.random.default_rng(5)
    img1 = torch.from_numpy(rng.uniform(0, 255, (1, 1, 96, 128)).astype(np.float32))
    img2 = torch.roll(img1, 5, dims=3)
    outs = [models.build(name, max_keypoints=32, num_pairs=256, topk_mode=mode,
                         device="cpu", **kw)(img1, img2) for mode in ("block", "approx")]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
