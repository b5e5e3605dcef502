"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from onnx_image_processing_tpu_torch import models, ops
from onnx_image_processing_tpu_torch.kernels import (akaze_ladder, detect_frontend,
                                                     launch_counts, reset_launch_counts,
                                                     select_frontend, sinkhorn_kernel,
                                                     sparse_sampler)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("h,w,r,margin,thr", [
    (120, 160, 5, 7, 0.0), (64, 80, 1, 4, 0.0), (123, 217, 3, 8, 0.05),
    (96, 128, 7, 10, 0.0), (50, 70, 15, 0, 0.0)])
def test_select_kernel_bitexact(dev, h, w, r, margin, thr):
    rng = np.random.default_rng(h + w)
    for s in (rng.random((2, h, w), dtype=np.float32),
              (rng.integers(0, 5, (2, h, w)) / 4.0).astype(np.float32)):
        s = torch.from_numpy(s).to(dev)
        bm_k, bi_k = select_frontend.nms_block_reduce(s, r, thr, margin)
        bm_p, bi_p = select_frontend.nms_block_reduce_plain(s, r, thr, margin)
        assert torch.equal(bm_k, bm_p) and torch.equal(bi_k, bi_p)


@pytest.mark.parametrize("bilinear", [False, True])
def test_sampler_kernel_matches_plain(dev, bilinear):
    rng = np.random.default_rng(3)
    table = ops.BADTable(ops.load_bad_params(512)).to(dev)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 1, 100, 130)).astype(np.float32)).to(dev)
    kp = np.stack([rng.integers(0, 100, (2, 40)), rng.integers(0, 130, (2, 40))], -1)
    mm = ops.angle_moments(img)
    args = (*ops.box_sample_inputs(img, torch.from_numpy(kp.astype(np.float32)).to(dev),
                                   table, mm),
            table.sample_radius, table.groups, 56, table.max_radius)
    out_k = sparse_sampler.box_sample(*args, bilinear=bilinear)
    out_p = sparse_sampler.box_sample_plain(*args, bilinear=bilinear)
    assert (out_k - out_p).abs().max().item() <= 1e-3


@pytest.mark.parametrize("n,m,eps", [(64, 96, 0.05), (128, 100, 1.0), (512, 512, 0.05)])
def test_sinkhorn_kernel_matches_plain(dev, n, m, eps):
    rng = np.random.default_rng(n + m)
    d1 = torch.from_numpy(rng.normal(0, 0.5, (2, n, 64)).astype(np.float32)).to(dev)
    d2 = torch.from_numpy(rng.normal(0, 0.5, (2, m, 64)).astype(np.float32)).to(dev)
    ls, lmu, lnu = ops.sinkhorn_inputs(d1, d2, eps)
    p_k = sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, 20)
    p_p = sinkhorn_kernel.sinkhorn_core_plain(ls, lmu, lnu, 20)
    torch.testing.assert_close(p_k, p_p, rtol=1e-5, atol=1e-6)


def test_flagship_launches_each_kernel(dev):
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (1, 1, 120, 160)).astype(np.float32)).to(dev)
            for _ in range(2)]
    fn = models.build("shi_tomasi_angle_sparse_bad_sinkhorn_extraction",
                      max_keypoints=128, max_matches=64, device=dev)
    reset_launch_counts()
    out = fn(*imgs)
    torch.cuda.synchronize()
    assert launch_counts() == {"select_frontend": 1, "sparse_sampler": 1, "sinkhorn": 1,
                               "detect_frontend": 0, "akaze_ladder": 0}
    assert out[0].shape == (1, 64, 2) and out[0].is_cuda


# The two stencil kernels round every multiply and add on their own, in their
# plain versions' order, so they are held to bit-identity.
@pytest.mark.parametrize("h,w,block,nms,with_angle", [
    (120, 160, 5, 5, True), (97, 131, 3, 3, True), (64, 80, 3, 0, True),
    (96, 144, 3, 5, False), (33, 40, 1, 2, True)])
def test_detect_frontend_kernel_bitexact(dev, h, w, block, nms, with_angle):
    rng = np.random.default_rng(h * w)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 1, h, w)).astype(np.float32)).to(dev)
    got = detect_frontend.detect_frontend(img, block, 15, 2.5, nms, with_angle)
    want = detect_frontend.detect_frontend_plain(img, block, 15, 2.5, nms, with_angle)
    for g, e in zip(got, want):
        assert (g is None) == (e is None)
        if g is not None:
            assert torch.equal(g, e), (g - e).abs().max().item()


@pytest.mark.parametrize("h,w,scales,iters,nms,patch", [
    (96, 128, 3, 3, 5, 15), (70, 101, 2, 1, 7, 9), (40, 40, 1, 0, 3, 15)])
def test_akaze_ladder_kernel_bitexact(dev, h, w, scales, iters, nms, patch):
    rng = np.random.default_rng(h + w)
    img = torch.from_numpy(rng.uniform(0, 255, (2, h, w)).astype(np.float32)).to(dev)
    args = (scales, iters, 0.05, 0.001, nms, patch, 2.5)
    got = akaze_ladder.akaze_ladder(img, *args)
    want = akaze_ladder.akaze_ladder_plain(img, *args)
    for g, e in zip(got, want):
        assert torch.equal(g, e), (g - e).abs().max().item()
    assert (got[0] > 0).any()


@pytest.mark.parametrize("fused", [False, True])
def test_flagship_fused_detect_launches(dev, fused):
    rng = np.random.default_rng(1)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (1, 1, 120, 160)).astype(np.float32)).to(dev)
            for _ in range(2)]
    fn = models.build("shi_tomasi_angle_sparse_bad_sinkhorn_extraction", max_keypoints=128,
                      max_matches=64, fused_detect=fused, device=dev)
    reset_launch_counts()
    fn(*imgs)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["detect_frontend"] == int(fused)
    assert counts["select_frontend"] == int(not fused)


def test_akaze_matcher_launches_each_kernel(dev):
    rng = np.random.default_rng(2)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (1, 1, 120, 160)).astype(np.float32)).to(dev)
            for _ in range(2)]
    fn = models.build("akaze_sparse_bad_sinkhorn_extraction", max_keypoints=128,
                      max_matches=64, device=dev)
    reset_launch_counts()
    out = fn(*imgs)
    torch.cuda.synchronize()
    assert launch_counts() == {"select_frontend": 1, "sparse_sampler": 1, "sinkhorn": 1,
                               "detect_frontend": 0, "akaze_ladder": 1}
    assert out[0].shape == (1, 64, 2) and out[0].is_cuda


def test_kernel_wrappers_validate_inputs(dev):
    with pytest.raises(ValueError):
        select_frontend.nms_block_reduce(torch.zeros((2, 8, 8), device=dev), 16)
    with pytest.raises(ValueError):
        select_frontend.nms_block_reduce(torch.zeros((2, 8, 8), device=dev).transpose(1, 2), 2)
    ls = torch.zeros((1, 5, 5), device=dev)
    with pytest.raises(ValueError):
        sinkhorn_kernel.sinkhorn_core(ls, torch.zeros((1, 4), device=dev),
                                      torch.zeros((1, 5), device=dev))
    with pytest.raises(ValueError):
        detect_frontend.detect_frontend(torch.zeros((2, 8, 8), device=dev))
    with pytest.raises(ValueError):
        detect_frontend.detect_frontend(torch.zeros((1, 1, 8, 8), device=dev), nms_radius=16)
    with pytest.raises(ValueError):
        akaze_ladder.akaze_ladder(torch.zeros((1, 1, 8, 8), device=dev))
    with pytest.raises(ValueError):
        akaze_ladder.akaze_ladder(torch.zeros((1, 8, 8), device=dev), orientation_patch_size=14)
