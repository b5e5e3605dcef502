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


def _sinkhorn_case(dev, n, m, seed, b=2):
    """Log-scores of an (n+1) x (m+1) problem, B=b, with row n // 2 at -1e4
    so that its exps underflow as a dustbin row's can."""
    rng = np.random.default_rng(seed)
    d1 = torch.from_numpy(rng.normal(0, 0.5, (b, n, 64)).astype(np.float32)).to(dev)
    d2 = torch.from_numpy(rng.normal(0, 0.5, (b, m, 64)).astype(np.float32)).to(dev)
    ls, lmu, lnu = ops.sinkhorn_inputs(d1, d2, 0.05)
    ls[:, n // 2, :] = -1e4
    return ls, lmu, lnu


@pytest.mark.parametrize("iters", [1, 20])
@pytest.mark.parametrize("n,m", [(512, 512), (1024, 1024), (64, 128), (128, 64)])
def test_sinkhorn_kernel_one_launch(dev, n, m, iters):
    """One launch per call, B=2 (two bands of CTAs): the flagship's 513 x
    513, the 1025 x 1025 of the AKAZE, dense and VO paths, and the ragged
    65 x 129 and 129 x 65 (CTAs that own columns but no rows, and the
    reverse); deterministic from run to run."""
    ls, lmu, lnu = _sinkhorn_case(dev, n, m, n + m + iters)
    reset_launch_counts()
    p_k = sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, iters)
    torch.cuda.synchronize()
    assert launch_counts()["sinkhorn"] == 1
    p_p = sinkhorn_kernel.sinkhorn_core_plain(ls, lmu, lnu, iters)
    assert (p_k - p_p).abs().max().item() <= 1e-5
    assert torch.equal(p_k, sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, iters))


@pytest.mark.parametrize("n,m", [(64, 128), (128, 64)])
def test_sinkhorn_kernel_ragged_repeated(dev, n, m):
    """The ragged shapes at B=1, 20 sweeps, 200 calls in a row: a CTA that
    owns rows but no columns (or the reverse) must never find a potential
    rewritten before it read it (the kernel traps after a spin that no real
    wait reaches), and every call gives the same P."""
    ls, lmu, lnu = _sinkhorn_case(dev, n, m, n * m, b=1)
    first = sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, 20)
    assert (first - sinkhorn_kernel.sinkhorn_core_plain(ls, lmu, lnu, 20)).abs().max().item() <= 1e-5
    outs = [sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, 20) for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, p) for p in outs)


@pytest.mark.parametrize("n,m", [(4096, 4096), (4096, 2048)])
def test_sinkhorn_kernel_partly_resident(dev, n, m):
    """Past what shared memory holds, the rows and columns that do not fit
    are read from device memory on each sweep (strided for a column)."""
    ls, lmu, lnu = _sinkhorn_case(dev, n, m, n + m, b=1)
    plan = sinkhorn_kernel.device_plan(n + 1, m + 1, dev)
    assert plan.res_rows < plan.lines and plan.res_cols < plan.lines
    p_k = sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, 20)
    p_p = sinkhorn_kernel.sinkhorn_core_plain(ls, lmu, lnu, 20)
    assert (p_k - p_p).abs().max().item() <= 1e-5


@pytest.mark.parametrize("n,b", [(512, 8), (1024, 3), (1024, 8)])
def test_sinkhorn_kernel_batch_bands(dev, n, b):
    """B entries in one launch, side by side on bands of CTAs (4 at 513, 2
    at 1025), the rest in later rounds of the same launch."""
    ls, lmu, lnu = _sinkhorn_case(dev, n, n, n + b, b=b)
    plan = sinkhorn_kernel.device_plan(n + 1, n + 1, dev, b)
    assert 1 < plan.groups < b
    reset_launch_counts()
    p_k = sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, 20)
    assert launch_counts()["sinkhorn"] == 1
    p_p = sinkhorn_kernel.sinkhorn_core_plain(ls, lmu, lnu, 20)
    assert (p_k - p_p).abs().max().item() <= 1e-5


def _edge_sampler_args(dev, seed=9, h=90, w=110, k=16):
    """Raw sampler inputs whose windows are clamped at all four edges of the
    padded image (origins below 0 and past the last fitting one), with
    sample coordinates on the window's edges and inside it."""
    rng = np.random.default_rng(seed)
    table = ops.BADTable(ops.load_bad_params(512)).to(dev)
    r, ps = table.max_radius, 56
    hp, wp = h + 2 * r, w + 2 * r
    psi = ps + 2 * r
    img = rng.uniform(0, 255, (2, hp, wp)).astype(np.float32)
    sy = rng.choice([-9, 0, hp - psi, hp - psi + 7], (2, k)).astype(np.int32)
    sx = rng.choice([-3, 0, wp - psi, wp - psi + 5], (2, k)).astype(np.int32)
    s = table.off_y.shape[0]
    ly = rng.uniform(-0.5, ps - 0.5, (2, k, s)).astype(np.float32)
    lx = rng.uniform(-0.5, ps - 0.5, (2, k, s)).astype(np.float32)
    ly[:, ::2, ::3], lx[:, 1::2, ::3] = 0.0, ps - 1.0
    tensors = [torch.from_numpy(a).to(dev) for a in (img, sy, sx, ly, lx)]
    return (*tensors, table.sample_radius, table.groups, ps, r)


@pytest.mark.parametrize("bilinear", [False, True])
def test_sampler_kernel_edges_and_radius_groups(dev, bilinear):
    """Every radius group 1..7, windows clamped at all four edges: nearest
    mode bit-identical to the plain version, bilinear within 1e-3."""
    args = _edge_sampler_args(dev)
    assert [g[0] for g in args[6]] == list(range(1, 8))
    out_k = sparse_sampler.box_sample(*args, bilinear=bilinear)
    out_p = sparse_sampler.box_sample_plain(*args, bilinear=bilinear)
    if bilinear:
        assert (out_k - out_p).abs().max().item() <= 1e-3
    else:
        assert torch.equal(out_k, out_p)


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
                               "detect_frontend": 0, "akaze_ladder": 0,
                               "sparse_sampler_ablate": 0}
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
                               "detect_frontend": 0, "akaze_ladder": 1,
                               "sparse_sampler_ablate": 0}
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


def _sampler_args(dev, seed=5, h=96, w=128, k=48):
    rng = np.random.default_rng(seed)
    table = ops.BADTable(ops.load_bad_params(512)).to(dev)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 1, h, w)).astype(np.float32)).to(dev)
    kp = np.stack([rng.integers(0, h, (2, k)), rng.integers(0, w, (2, k))], -1)
    inputs = ops.box_sample_inputs(img, torch.from_numpy(kp.astype(np.float32)).to(dev),
                                   table, ops.angle_moments(img))
    return (*inputs, table.sample_radius, table.groups, 56, table.max_radius)


@pytest.mark.parametrize("skip", [(), ("load",), ("boxsum",), ("store",)])
def test_sampler_ablation_variants(dev, skip):
    """The full variant is the production kernel, bit for bit; 'boxsum' is
    its plain definition (radius 0), bit for bit; 'load' gives finite
    samples; 'store' leaves the output buffer as it was."""
    args = _sampler_args(dev)
    out = torch.full(args[3].shape, -7.0, device=dev)
    reset_launch_counts()
    got = sparse_sampler.box_sample_ablated(*args, skip=skip, out=out)
    torch.cuda.synchronize()
    assert got is out
    assert launch_counts()["sparse_sampler_ablate"] == 1
    assert launch_counts()["sparse_sampler"] == 0
    if skip == ():
        assert torch.equal(got, sparse_sampler.box_sample(*args))
        assert torch.equal(got, sparse_sampler.box_sample_plain(*args))
    elif skip == ("boxsum",):
        plain = sparse_sampler.box_sample_ablated(*(t.cpu() if torch.is_tensor(t) else t
                                                    for t in args), skip=skip)
        assert torch.equal(got.cpu(), plain)
    elif skip == ("load",):
        assert bool(torch.isfinite(got).all())
    else:
        assert bool((got == -7.0).all())


def test_dense_matcher_launches_and_oriented_map(dev):
    rng = np.random.default_rng(4)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (1, 1, 120, 160)).astype(np.float32)).to(dev)
            for _ in range(2)]
    fn = models.build("shi_tomasi_bad_sinkhorn_extraction", max_keypoints=128,
                      max_matches=64, device=dev)
    reset_launch_counts()
    out = fn(*imgs)
    torch.cuda.synchronize()
    assert launch_counts() == {"select_frontend": 1, "sparse_sampler": 1, "sinkhorn": 1,
                               "detect_frontend": 0, "akaze_ladder": 0,
                               "sparse_sampler_ablate": 0}
    assert out[0].shape == (1, 64, 2) and out[0].is_cuda
    table = ops.BADTable(ops.load_bad_params(256)).to(dev)
    theta = ops.angle_estimation(imgs[0])
    reset_launch_counts()
    tiled = ops.dense_bad(imgs[0], table, orientation=theta)
    assert launch_counts()["sparse_sampler"] >= 1
    gather = ops.dense_bad(imgs[0], table, orientation=theta, oriented_route="gather")
    assert tiled.shape == (1, 256, 120, 160)
    assert (tiled - gather).abs().max().item() <= 2e-3
