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
                                                     essential_solve, launch_counts,
                                                     reset_launch_counts, select_frontend,
                                                     sinkhorn_kernel, sparse_sampler)

pytestmark = pytest.mark.cuda

# A matcher without an essential tail launches none of the solve's kernels.
NO_ESSENTIAL = {"min_eigvec9": 0, "project_essential": 0, "essential_hypotheses": 0}


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


def _select_maps(rng, b, h, w):
    """A random map, a tie map (values k/4) and a signed map, (b, h, w) each."""
    return [rng.random((b, h, w), dtype=np.float32),
            (rng.integers(0, 5, (b, h, w)) / 4.0).astype(np.float32),
            rng.random((b, h, w), dtype=np.float32) - 0.5]


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("h,w,r,margin,thr", [
    (120, 160, 5, 7, 0.0), (64, 80, 1, 4, 0.0), (123, 217, 3, 8, 0.05),
    (96, 128, 7, 10, 0.0), (50, 70, 15, 0, -0.2)])
def test_select_topk_kernel_bitexact(dev, b, h, w, r, margin, thr):
    """The fused select (block reduce, top-k, decode) equals its plain
    composition bit for bit, for K from 1 to the whole block grid; one
    launch per call."""
    rng = np.random.default_rng(h * w + b)
    n = -(-h // (r + 1)) * -(-w // (r + 1))
    for s in _select_maps(rng, b, h, w):
        s = torch.from_numpy(s).to(dev)
        for k in sorted({1, min(100, n), n // 2, n - 1, n} - {0}):
            reset_launch_counts()
            got = select_frontend.nms_select_blocks(s, r, k, thr, margin)
            assert launch_counts()["select_frontend"] == 1
            want = select_frontend.nms_select_blocks_plain(s, r, k, thr, margin)
            for g, e in zip(got, want):
                assert torch.equal(g, e), (k, (g != e).sum().item())


@pytest.mark.parametrize("b,h,w,r,k", [
    (2, 240, 320, 1, 19200),   # the sort in device memory (K past 4096 keys)
    (2, 240, 320, 1, 5000),
    (1, 480, 640, 1, 1000),    # 76,800 blocks: read from L2, not staged
    (2, 480, 640, 3, 1024)])   # AKAZE's grid and K
def test_select_topk_kernel_large(dev, b, h, w, r, k):
    rng = np.random.default_rng(k + h)
    for s in _select_maps(rng, b, h, w)[:2]:
        s = torch.from_numpy(s).to(dev)
        got = select_frontend.nms_select_blocks(s, r, k, 0.0, 0)
        want = select_frontend.nms_select_blocks_plain(s, r, k, 0.0, 0)
        for g, e in zip(got, want):
            assert torch.equal(g, e)


def test_select_topk_kernel_repeats_and_graph_replay(dev):
    """The ticket counters reset themselves: 50 calls in a row and a CUDA
    graph of 20 calls replayed twice give the plain result every time."""
    rng = np.random.default_rng(5)
    s = torch.from_numpy(rng.random((2, 480, 640), dtype=np.float32)).to(dev)
    args = (5, 512, 0.0, 16)
    want = select_frontend.nms_select_blocks_plain(s, *args)
    outs = [select_frontend.nms_select_blocks(s, *args) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o[0], want[0]) and torch.equal(o[1], want[1]) for o in outs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        select_frontend.nms_select_blocks(s, *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [select_frontend.nms_select_blocks(s, *args) for _ in range(20)]
    for _ in range(2):
        for o in captured:
            o[0].fill_(7.0)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o[0], want[0]) and torch.equal(o[1], want[1]) for o in captured)


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
                               "detect_frontend": 0, "score_moments": 1, "akaze_ladder": 0,
                               "sparse_sampler_ablate": 0, **NO_ESSENTIAL}
    assert out[0].shape == (1, 64, 2) and out[0].is_cuda


# The two stencil kernels round every multiply and add on their own, in their
# plain versions' order, so they are held to bit-identity.
@pytest.mark.parametrize("b,h,w,block,nms,patch,with_angle", [
    (2, 120, 160, 5, 5, 15, True), (2, 97, 131, 3, 3, 15, True), (2, 64, 80, 3, 0, 15, True),
    (2, 96, 144, 3, 5, 15, False), (2, 33, 40, 1, 2, 15, True),
    # the pair, a 1080p frame and a strip shallower than the halo, with and
    # without moments (the flagship's radii, template constants)
    (2, 480, 640, 5, 5, 15, True), (2, 480, 640, 5, 5, 15, False),
    (1, 1080, 1920, 5, 5, 15, True), (1, 1080, 1920, 5, 5, 15, False),
    (2, 5, 300, 5, 5, 15, True), (2, 5, 300, 5, 5, 15, False),
    (2, 480, 640, 3, 5, 15, True),                       # box 1: the other fixed instantiation
    (2, 200, 300, 7, 3, 9, True), (1, 100, 120, 31, 15, 31, True)])   # general radii
def test_detect_frontend_kernel_bitexact(dev, b, h, w, block, nms, patch, with_angle):
    rng = np.random.default_rng(h * w + b)
    img = torch.from_numpy(rng.uniform(0, 255, (b, 1, h, w)).astype(np.float32)).to(dev)
    got = detect_frontend.detect_frontend(img, block, patch, 2.5, nms, with_angle)
    want = detect_frontend.detect_frontend_plain(img, block, patch, 2.5, nms, with_angle)
    for g, e in zip(got, want):
        assert (g is None) == (e is None)
        if g is not None:
            assert torch.equal(g, e), (g - e).abs().max().item()
    assert (want[0] > 0).any()


@pytest.mark.parametrize("b", [1, 2, 16])
@pytest.mark.parametrize("h,w", [(480, 640), (97, 131)])
@pytest.mark.parametrize("block", [3, 5])
@pytest.mark.parametrize("patch", [15, 9])
@pytest.mark.parametrize("with_angle", [True, False])
def test_score_moments_kernel_bitexact(dev, b, h, w, block, patch, with_angle):
    """The detect kernel without its NMS (the unfused route's one launch)
    equals ``shi_tomasi_score`` and ``angle_moments`` on the same card, bit
    for bit: the fixed instantiations (patch 15) and the general one."""
    rng = np.random.default_rng(h * w + b + block)
    img = torch.from_numpy(rng.uniform(0, 255, (b, 1, h, w)).astype(np.float32)).to(dev)
    reset_launch_counts()
    got = detect_frontend.score_moments(img, block, patch, 2.5, with_angle)
    assert launch_counts()["score_moments"] == 1
    want = (ops.shi_tomasi_score(img, block_size=block),
            *(ops.angle_moments(img, patch_size=patch, sigma=2.5) if with_angle
              else (None, None)))
    for g, e in zip(got, want):
        assert (g is None) == (e is None)
        if g is not None:
            assert torch.equal(g, e), (g - e).abs().max().item()
    assert (want[0] > 0).any()


def test_batched_flagship_score_moments_route_equals_plain(dev, monkeypatch):
    """The batched flagship (8 pairs of 480 x 640) through the unmasked
    detect pass and through the plain stencils on the card: the same
    keypoints, scores, descriptors and P."""
    from onnx_image_processing_tpu_torch.models import shi_tomasi_family

    rng = np.random.default_rng(31)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 255, (8, 1, 480, 640)).astype(np.float32))
              .to(dev) for _ in range(2))
    fb = models.build_batched("shi_tomasi_angle_sparse_bad_sinkhorn", device=dev)

    def run():
        feats = shi_tomasi_family._sparse_detect_describe(torch.cat([i1, i2]), fb.cfg,
                                                          fb.pipeline.table)
        out = fb(i1, i2)
        torch.cuda.synchronize()
        return (*feats, *out)

    reset_launch_counts()
    got = run()
    assert launch_counts()["score_moments"] == 2
    monkeypatch.setattr(shi_tomasi_family, "use_kernel", lambda t: False)
    reset_launch_counts()
    want = run()
    assert launch_counts()["score_moments"] == 0
    assert (want[1] > 0).sum() > 1000
    for g, e in zip(got, want):
        assert torch.equal(g, e)


def test_detect_frontend_kernel_zero_taps(dev):
    """At sigma 0.3 the outer Gaussian taps of a 15-tap patch underflow to
    0: the launch takes the general kernel, which skips every zero tap."""
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 1, 96, 128)).astype(np.float32)).to(dev)
    assert (ops.moment_taps(0.3, 15)[0] == 0).any()
    got = detect_frontend.detect_frontend(img, 5, 15, 0.3, 5)
    want = detect_frontend.detect_frontend_plain(img, 5, 15, 0.3, 5)
    _select_equal(got, want)
    args = (5, 15, 0.3, 5, 64, 0.0, 8)
    _select_equal(detect_frontend.detect_select(img, *args),
                  detect_frontend.detect_select_plain(img, *args))


def _detect_images(rng, b, h, w):
    """A uniform random image and one of three grey levels (tied scores)."""
    return [rng.uniform(0, 255, (b, 1, h, w)).astype(np.float32),
            (64.0 * rng.integers(0, 3, (b, 1, h, w))).astype(np.float32)]


def _select_equal(got, want):
    for g, e in zip(got, want):
        assert (g is None) == (e is None)
        if g is not None:
            assert torch.equal(g, e), (g.shape, (g != e).sum().item())


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("h,w,block,nms,margin,thr", [
    (120, 160, 5, 5, 7, 0.0), (97, 131, 3, 3, 8, 50.0), (64, 80, 5, 1, 4, 0.0),
    (96, 128, 7, 7, 10, 0.0), (50, 70, 5, 15, 0, -0.2)])
def test_detect_select_kernel_bitexact(dev, b, h, w, block, nms, margin, thr):
    """detect_select (detect, masks, block reduce, top-k, decode in one
    launch) equals its plain composition bit for bit: keypoints, scores and
    the three maps, for K from 1 to the whole block grid."""
    rng = np.random.default_rng(h * w + b + nms)
    n = -(-h // (nms + 1)) * -(-w // (nms + 1))
    for img in _detect_images(rng, b, h, w):
        img = torch.from_numpy(img).to(dev)
        for k in sorted({1, min(100, n), n // 2, n - 1, n} - {0}):
            args = (block, 15, 2.5, nms, k, thr, margin)
            reset_launch_counts()
            got = detect_frontend.detect_select(img, *args)
            assert launch_counts()["detect_frontend"] == 1
            _select_equal(got, detect_frontend.detect_select_plain(img, *args))


@pytest.mark.parametrize("b,h,w,nms,k,margin,with_angle", [
    (2, 240, 320, 1, 19200, 0, True),   # the sort in device memory (K past 4096 keys)
    (2, 240, 320, 1, 5000, 0, False),
    (1, 480, 640, 1, 1000, 16, True),   # 76,800 blocks: read from L2, not staged
    (2, 480, 640, 5, 512, 16, True),    # the fused flagship pair
    (1, 480, 640, 5, 512, 16, True)])   # a VO frame
def test_detect_select_kernel_large(dev, b, h, w, nms, k, margin, with_angle):
    rng = np.random.default_rng(k + h)
    for img in _detect_images(rng, b, h, w):
        img = torch.from_numpy(img).to(dev)
        args = (5, 15, 2.5, nms, k, 0.0, margin, with_angle)
        _select_equal(detect_frontend.detect_select(img, *args),
                      detect_frontend.detect_select_plain(img, *args))


def test_detect_select_kernel_repeats_and_graph_replay(dev):
    """The ticket counters reset themselves: 50 calls in a row and a CUDA
    graph of 20 calls replayed twice give the plain result every time."""
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 1, 480, 640)).astype(np.float32)).to(dev)
    args = (5, 15, 2.5, 5, 512, 0.0, 16)
    want = detect_frontend.detect_select_plain(img, *args)
    outs = [detect_frontend.detect_select(img, *args) for _ in range(50)]
    torch.cuda.synchronize()
    for o in outs:
        _select_equal(o, want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        detect_frontend.detect_select(img, *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [detect_frontend.detect_select(img, *args) for _ in range(20)]
    for _ in range(2):
        for o in captured:
            o[0].fill_(7.0)
            o[2].fill_(7.0)
        graph.replay()
        torch.cuda.synchronize()
        for o in captured:
            _select_equal(o, want)


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


@pytest.mark.parametrize("b,h,w,route", [
    (2, 480, 640, "resident"), (1, 480, 640, "resident"), (1, 1080, 1920, "resident"),
    (2, 1080, 1920, "global"), (2, 5, 300, "resident"), (1, 3, 9, "resident")])
def test_akaze_ladder_kernel_routes(dev, b, h, w, route):
    """At the defaults (3 scales of 3 steps, NMS 5, patch 15): the pair and
    the VO frame at 480x640, one 1080p frame (tiles of one launch), a 1080p
    pair (state past shared memory: per-step launches), and images
    shallower than the halo (one row of tiles). Bit-identical to the plain
    version, and to itself over repeated calls (no neighbour wait hangs or
    reads a stale halo)."""
    rng = np.random.default_rng(h * w + b)
    img = torch.from_numpy(rng.uniform(0, 255, (b, h, w)).astype(np.float32)).to(dev)
    plan = akaze_ladder.device_plan(b, h, w, 2, 7, dev)
    assert plan.route == route
    got = akaze_ladder.akaze_ladder(img)
    want = akaze_ladder.akaze_ladder_plain(img)
    for g, e in zip(got, want):
        assert torch.equal(g, e), (g - e).abs().max().item()
    again = [akaze_ladder.akaze_ladder(img) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(a[i], got[i]) for a in again for i in range(3))


def test_akaze_ladder_kernel_one_device_launch(dev):
    from onnx_image_processing_tpu_torch.tools.kernel_times import device_launches

    img = torch.rand((2, 480, 640), device=dev) * 255
    assert device_launches(lambda: akaze_ladder.akaze_ladder(img)) == 1


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
    assert counts["select_frontend"] == counts["score_moments"] == int(not fused)
    if fused:   # detect and select: one device launch, no plain chain after it
        from onnx_image_processing_tpu_torch.models.shi_tomasi_family import (
            _fused_detect_select)
        from onnx_image_processing_tpu_torch.tools.kernel_times import device_launches

        both = torch.cat(imgs)
        assert device_launches(lambda: _fused_detect_select(both, fn.cfg, 16, True)) == 1


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
                               "detect_frontend": 0, "score_moments": 0, "akaze_ladder": 1,
                               "sparse_sampler_ablate": 0, **NO_ESSENTIAL}
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
    with pytest.raises(ValueError):   # K past the 4 x 4 block grid
        select_frontend.nms_select_blocks(torch.zeros((1, 8, 8), device=dev), 1, 17)
    with pytest.raises(ValueError):   # the block top-k needs an NMS radius
        detect_frontend.detect_select(torch.zeros((1, 1, 8, 8), device=dev), nms_radius=0,
                                      max_keypoints=4)
    with pytest.raises(ValueError):   # K past the 4 x 4 block grid
        detect_frontend.detect_select(torch.zeros((1, 1, 8, 8), device=dev), nms_radius=1,
                                      max_keypoints=17)


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
                               "detect_frontend": 0, "score_moments": 1, "akaze_ladder": 0,
                               "sparse_sampler_ablate": 0, **NO_ESSENTIAL}
    assert out[0].shape == (1, 64, 2) and out[0].is_cuda
    table = ops.BADTable(ops.load_bad_params(256)).to(dev)
    theta = ops.angle_estimation(imgs[0])
    reset_launch_counts()
    tiled = ops.dense_bad(imgs[0], table, orientation=theta)
    assert launch_counts()["sparse_sampler"] >= 1
    gather = ops.dense_bad(imgs[0], table, orientation=theta, oriented_route="gather")
    assert tiled.shape == (1, 256, 120, 160)
    assert (tiled - gather).abs().max().item() <= 2e-3


def test_serving_on_the_card_matches_the_per_pair_loop(dev):
    """stream_map_chunked(build_batched(...)) on the card: 7 pairs at chunk
    3 (a padded final chunk), keypoints equal to the per-pair loop, P within
    1e-5; every result fetched through pinned buffers."""
    from onnx_image_processing_tpu_torch.parallel import stream_map_chunked
    from onnx_image_processing_tpu_torch.parallel.throughput import _drain, _fetch

    rng = np.random.default_rng(21)
    pairs = [tuple(rng.uniform(0, 255, (1, 1, 120, 160)).astype(np.float32) for _ in range(2))
             for _ in range(7)]
    name = "shi_tomasi_angle_sparse_bad_sinkhorn"
    fn = models.build(name, max_keypoints=64, device=dev)
    seq = [tuple(t.cpu().numpy()[0] for t in fn(torch.from_numpy(a).to(dev),
                                                 torch.from_numpy(b).to(dev))) for a, b in pairs]
    fb = models.build_batched(name, max_keypoints=64, device=dev)
    for depth in (1, 2):
        out = list(stream_map_chunked(fb, pairs, chunk=3, depth=depth))
        assert len(out) == 7
        for (k1, k2, p), (k1s, k2s, ps) in zip(out, seq):
            assert np.array_equal(k1, k1s) and np.array_equal(k2, k2s)
            assert np.abs(p - ps).max() <= 1e-5
    tree, event = _fetch((torch.arange(5, device=dev), 3))
    assert tree[0].is_pinned() and tree[1] == 3 and event is not None
    assert _drain((tree, event))[0].tolist() == [0, 1, 2, 3, 4]


def test_aux_ops_on_the_card_equal_the_cpu(dev):
    rng = np.random.default_rng(22)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 1, 96, 128)).astype(np.float32))
    assert torch.equal(ops.fast_score(img.to(dev)).cpu(), ops.fast_score(img))
    assert (ops.dog_score(img.to(dev)).cpu() - ops.dog_score(img)).abs().max() <= 1e-4
    pts = torch.from_numpy(rng.uniform(-3, 3, (38400, 3)).astype(np.float32))
    leaf = torch.tensor(np.float32(0.05))
    (og, mg), (oc, mc) = (ops.voxel_downsampling(pts.to(d), leaf.to(d)) for d in (dev, "cpu"))
    assert torch.equal(mg.cpu(), mc) and (og.cpu() - oc).abs().max() <= 2e-4
    depth = torch.from_numpy(rng.uniform(0.5, 3.0, (96, 128)).astype(np.float32))
    kw = dict(width=128, height=96, depth_cx=64.0, depth_cy=48.0, depth_fx=100.0,
              depth_fy=100.0, rgb_cx=64.0, rgb_cy=48.0, rgb_fx=100.0, rgb_fy=100.0)
    rot, trans = torch.eye(3), torch.tensor([0.005, 0.005, 0.0])
    assert torch.equal(ops.depth_alignment(depth.to(dev), rot.to(dev), trans.to(dev), **kw).cpu(),
                       ops.depth_alignment(depth, rot, trans, **kw))


@pytest.mark.parametrize("n", [512, 1024])
def test_sinkhorn_entry_does_not_depend_on_its_batch(dev, n):
    """An entry's P is the same bit for bit whatever batch shares the
    launch (the plan's lines per CTA change with B): the LSE sums run in one
    order for every number of warps per line."""
    rng = np.random.default_rng(n)
    d = rng.normal(0, 1, (2, 8, n, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d1, d2 = (torch.from_numpy(a).to(dev) for a in d)
    ls, lmu, lnu = ops.sinkhorn_inputs(d1, d2, 0.05)
    alone = [sinkhorn_kernel.sinkhorn_core(ls[i:i + 1].contiguous(), lmu[i:i + 1].contiguous(),
                                           lnu[i:i + 1].contiguous(), 20) for i in range(8)]
    for b in (2, 3, 4, 8):
        p = sinkhorn_kernel.sinkhorn_core(ls[:b].contiguous(), lmu[:b].contiguous(),
                                          lnu[:b].contiguous(), 20)
        assert all(torch.equal(p[i], alone[i][0]) for i in range(b)), b
    cost_b = ops.sinkhorn_inputs(d1[:3], d2[:3], 0.05)[0]
    assert torch.equal(cost_b[1], ops.sinkhorn_inputs(d1[1:2], d2[1:2], 0.05)[0][0])


def _to(args, dev):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)


@pytest.mark.parametrize("case", ["nms_block_reduce", "nms_select_blocks", "box_sample",
                                  "sinkhorn_core", "detect_frontend",
                                  "detect_frontend_no_angle", "detect_select", "score_moments",
                                  "score_moments_no_angle", "akaze_ladder"])
def test_opcheck_on_the_card(dev, case):
    """``torch.library.opcheck`` of each kernel op on CUDA tensors (the
    CPU tier's cases, moved to the card): schema, fake tensor, AOT dispatch
    with dynamic shapes, each running the hand kernel."""
    from test_torch_custom_ops import CASES, SEED

    op, make, _ = CASES[case]
    args = _to(make(np.random.default_rng(SEED)), dev)
    reset_launch_counts()
    torch.library.opcheck(op, args)
    assert sum(launch_counts().values()) > 0


def test_cuda_artifact_equals_eager(dev, tmp_path):
    """The flagship exported on the card, saved and loaded: the eager
    module's outputs bit for bit, with the same launches (each > 0)."""
    name = "shi_tomasi_angle_sparse_bad_sinkhorn_extraction"
    kw = dict(max_keypoints=256, max_matches=128)
    rng = np.random.default_rng(23)
    pair = tuple(torch.from_numpy(rng.uniform(0, 255, (1, 1, 240, 320)).astype(np.float32))
                 .to(dev) for _ in range(2))
    path = models.save_exported(models.export_model(name, 240, 320, device=dev, **kw),
                                models.artifact_path(str(tmp_path), name, dev))
    assert path.endswith(".cuda.pt2")
    loaded = models.load_exported(path)
    eager = models.build(name, device=dev, **kw)
    counts = []
    outs = []
    for fn in (eager, loaded):
        reset_launch_counts()
        outs.append(fn(*pair))
        torch.cuda.synchronize()
        counts.append(launch_counts())
    assert counts[0] == counts[1]
    assert all(counts[1][k] > 0 for k in ("select_frontend", "sparse_sampler", "sinkhorn"))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_log_marginals_equal_the_cpu(dev):
    """The Sinkhorn log-marginals, made on the device from the sizes: the
    same float32 values as on the CPU."""
    for n in (7, 47, 255, 512, 513, 1024, 4097):
        d = torch.zeros((1, n, 4))
        cpu = ops.sinkhorn_inputs(d, d[:, :3])[1:]
        card = ops.sinkhorn_inputs(d.to(dev), d[:, :3].to(dev))[1:]
        assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card)), n


# ---- the essential solve's kernels ----------------------------------------------

def _rotation(axis_angle):
    th = np.linalg.norm(axis_angle)
    k = axis_angle / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def _two_view(n, noise, seed):
    """Normalized (x, y) of n points seen from two cameras (a small
    rotation, a unit translation), with Gaussian noise."""
    rng = np.random.default_rng(seed)
    pts = np.c_[rng.uniform(-1, 1, (n, 2)), rng.uniform(2, 5, n)]
    t = rng.normal(size=3)
    cam2 = pts @ _rotation(rng.normal(0, 0.05, 3)).T + t / np.linalg.norm(t)
    x1 = pts[:, :2] / pts[:, 2:] + rng.normal(0, noise, (n, 2))
    x2 = cam2[:, :2] / cam2[:, 2:] + rng.normal(0, noise, (n, 2))
    return x1, x2


def _unit_diff(a, b):
    """Per leading index: max abs difference after scaling each trailing
    block to unit norm, up to sign (float64)."""
    a, b = (np.asarray(x, np.float64).reshape(len(x), -1) for x in (a, b))
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return np.minimum(np.abs(a - b).max(1), np.abs(a + b).max(1))


def _normal_matrices():
    """Random PSD 9x9 matrices of mixed scales, 8-point normal matrices of
    clean two-view sets, of a pure shift (a 3-dim null space), a zero
    matrix and a diagonal one with tied smallest entries."""
    rng = np.random.default_rng(31)
    mats = [(a.T @ a) for a in rng.normal(size=(48, 40, 9)) * rng.uniform(0.01, 100, (48, 1, 9))]
    for seed in range(12):
        x1, x2 = _two_view(64, 1e-4, seed)
        if seed % 4 == 3:
            x2 = x1 + 0.05
        h1, h2 = np.c_[x1, np.ones(64)], np.c_[x2, np.ones(64)]
        a = (h1[:, :, None] * h2[:, None, :]).reshape(64, 9)
        mats.append(a.T @ a)
    mats += [np.zeros((9, 9)), np.diag([3.0, 1, 1, 2, 5, 1, 7, 8, 9])]
    return np.stack(mats).astype(np.float32)


def test_min_eigvec9_kernel_matches_plain(dev):
    """Up to sign within 1e-6 where the two smallest eigenvalues part by at
    least 1e-6 of the largest; elsewhere (a repeated smallest eigenvalue:
    another vector of the same space) the residual |Mv| at most the plain
    version's + 1e-6 |M|. A zero matrix gives e0, ties the lowest index."""
    m = _normal_matrices()
    got = essential_solve.min_eigvec9(torch.from_numpy(m).to(dev)).cpu().numpy()
    want = essential_solve.min_eigvec9_plain(torch.from_numpy(m)).numpy()
    lam = np.linalg.eigvalsh(m.astype(np.float64))
    apart = lam[:, 1] - lam[:, 0] >= 1e-6 * np.abs(lam).max(1)
    assert (_unit_diff(got, want)[apart] <= 1e-6).all()
    m64 = m.astype(np.float64)
    resid = [np.linalg.norm(np.einsum("bij,bj->bi", m64, v.astype(np.float64)), axis=1)
             for v in (got, want)]
    fro = np.linalg.norm(m64, axis=(1, 2))
    assert (resid[0][~apart] <= resid[1][~apart] + 1e-6 * fro[~apart]).all()
    assert (~apart).sum() >= 4
    np.testing.assert_array_equal(got[-2], np.eye(9)[0])
    np.testing.assert_array_equal(np.abs(got[-1]), np.eye(9)[1])


def test_project_essential_kernel_matches_plain(dev):
    rng = np.random.default_rng(32)
    e = rng.normal(size=(300, 3, 3)).astype(np.float32)
    for i in range(20):   # near-essential matrices
        u, _, vt = np.linalg.svd(rng.normal(size=(3, 3)))
        e[i] = u @ np.diag([1.0, 1 + 0.01 * rng.normal(), 1e-3 * rng.normal()]) @ vt
    got = essential_solve.project_essential(torch.from_numpy(e).to(dev)).cpu().numpy()
    want = essential_solve.project_essential_plain(torch.from_numpy(e)).numpy()
    assert _unit_diff(got, want).max() <= 1e-5
    zero = essential_solve.project_essential(torch.zeros((1, 3, 3), device=dev))
    assert torch.equal(zero, torch.zeros_like(zero))


def _samples(s=256, seed=33):
    """``s`` minimal samples of one noisy two-view set: weights, points."""
    rng = np.random.default_rng(seed)
    x1, x2 = _two_view(300, 1e-3, seed)
    idx = np.stack([rng.choice(300, 8, replace=False) for _ in range(s)])
    w = np.ones((s, 8), np.float32)
    w[::5, 7] = 0.0   # an invalid pick: a rank-deficient system
    return (torch.from_numpy(w), torch.from_numpy(x1[idx].astype(np.float32)),
            torch.from_numpy(x2[idx].astype(np.float32)), x1, x2)


def test_essential_hypotheses_kernel_matches_plain(dev):
    """A float32 solve of an ill-conditioned minimal sample moves far from
    the float64 one, in the plain version too, so two float32 solves part
    by as much: the kernel's median distance from the
    float64 solve is held to 4x the plain version's (the rule of
    ``test_torch_geometry._as_accurate_as_jax``), and the best MSAC score of
    its hypotheses to no less than (1 - 1e-3) x the plain version's."""
    w, p1, p2, x1, x2 = _samples()
    got = essential_solve.essential_hypotheses(w.to(dev), p1.to(dev), p2.to(dev)).cpu()
    want = essential_solve.essential_hypotheses_plain(w, p1, p2)
    f64 = essential_solve.essential_hypotheses_plain(w.double(), p1.double(), p2.double())
    assert torch.isfinite(got).all()
    full = (w > 0).all(1).numpy()   # samples with a zero weight have no unique solution
    assert (np.median(_unit_diff(got.numpy(), f64.numpy())[full])
            <= 4 * np.median(_unit_diff(want.numpy(), f64.numpy())[full]))
    from onnx_image_processing_tpu_torch.geometry import sampson_error_matched

    tau = (0.75 / 500) ** 2
    c1, c2 = (torch.from_numpy(x.astype(np.float32)) for x in (x1, x2))
    best = [float(torch.clamp_min(1 - sampson_error_matched(e.float(), c1, c2) / tau, 0)
                  .sum(1).max()) for e in (got, want)]
    assert best[0] >= (1 - 1e-3) * best[1]


def test_essential_kernels_repeat_and_graph_replay(dev):
    """Deterministic: 20 calls in a row, and a CUDA graph of the three
    calls replayed twice, give the eager result bit for bit."""
    w, p1, p2, _, _ = _samples(128)
    w, p1, p2 = w.to(dev), p1.to(dev), p2.to(dev)
    m = torch.from_numpy(_normal_matrices()).to(dev)
    e = torch.from_numpy(np.random.default_rng(34).normal(size=(64, 3, 3))
                         .astype(np.float32)).to(dev)

    def calls():
        return (essential_solve.min_eigvec9(m), essential_solve.project_essential(e),
                essential_solve.essential_hypotheses(w, p1, p2))

    want = calls()
    for _ in range(20):
        assert all(torch.equal(a, b) for a, b in zip(calls(), want))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for _ in range(2):
        for t in captured:
            t.fill_(7.0)
        reset_launch_counts()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, want))
        assert sum(launch_counts().values()) == 0   # a replay is not a wrapper call


@pytest.mark.parametrize("case", ["min_eigvec9", "project_essential", "essential_hypotheses"])
def test_essential_opcheck_on_the_card(dev, case):
    w, p1, p2, _, _ = _samples(16)
    args = {"min_eigvec9": (torch.from_numpy(_normal_matrices()[:5]),),
            "project_essential": (torch.from_numpy(np.random.default_rng(35).normal(
                size=(4, 3, 3)).astype(np.float32)),),
            "essential_hypotheses": (w, p1, p2)}[case]
    op = getattr(essential_solve, case + "_op")
    reset_launch_counts()
    torch.library.opcheck(op, tuple(a.to(dev) for a in args))
    assert sum(launch_counts().values()) > 0


def test_essential_wrappers_validate_inputs(dev):
    with pytest.raises(ValueError):
        essential_solve.min_eigvec9(torch.zeros((2, 9, 9), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        essential_solve.essential_hypotheses(torch.ones((4, 7), device=dev),
                                             torch.zeros((4, 7, 2), device=dev),
                                             torch.zeros((4, 7, 2), device=dev))
    with pytest.raises(ValueError):
        essential_solve.project_essential(torch.zeros((2, 3, 3), dtype=torch.float16, device=dev))
