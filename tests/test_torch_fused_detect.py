"""PyTorch port vs JAX: the detect frontend's plain version and the flagship
with ``fused_detect=True``, on the CPU.

Tolerances. Each map: within 2e-2, or within 1e-5 of the map's max|.|
where that is larger. The first is the JAX package's bound for its own
kernel against its oracle (``tests/test_kernels.py``); the second is the
port's stencil bound against JAX (``tests/test_torch_stencils.py``), needed
because the score reaches ~1e6, where one float32 ulp is 0.0625, and
torch's CPU sqrt and XLA's round the last bit apart. NMS survivor maps
differ on < 1e-4 of pixels. The
fused flagship: equal keypoints, or at most 2 swaps per image, with P within
5e-3 on the common keypoints. Fused vs unfused inside the port: keypoint
sets within 2 swaps, descriptors within 2e-3 on the common keypoints.
``detect_select_plain`` (detect, then the premasked block top-k) against
JAX's ``_fused_detect_select``: keypoint sets within 2 swaps per image, the
scores of the common keypoints and the three maps within the map tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onnx_image_processing_tpu.kernels.detect_frontend as jdf
from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu.core.config import MatcherConfig as JaxMatcherConfig
from onnx_image_processing_tpu.models.shi_tomasi_family import (
    _fused_detect_select as jax_fused_detect_select)
from onnx_image_processing_tpu_torch import models, ops
from onnx_image_processing_tpu_torch.core import MatcherConfig
from onnx_image_processing_tpu_torch.kernels import detect_frontend, launch_counts, reset_launch_counts
from onnx_image_processing_tpu_torch.models import shi_tomasi_family
from onnx_image_processing_tpu_torch.models.shi_tomasi_family import _sparse_detect_describe
from onnx_image_processing_tpu_torch.ops import BADTable, load_bad_params

NAME = "shi_tomasi_angle_sparse_bad_sinkhorn"
K = 128
P_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_kernel_interpreted(monkeypatch):
    """JAX's detect frontend in interpret mode, as its own test runs it."""
    orig = jdf.detect_frontend
    monkeypatch.setattr(jdf, "detect_frontend",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _map_close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    atol = max(2e-2, 1e-5 * float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, atol=atol, rtol=0)


def test_detect_frontend_plain_matches_jax_kernel():
    rng = np.random.default_rng(31)
    img = rng.uniform(0, 255, (2, 1, 200, 300)).astype(np.float32)
    got = [o.numpy() for o in detect_frontend.detect_frontend_plain(
        torch.from_numpy(img), block_size=3, nms_radius=5)]
    want = [np.asarray(o) for o in jdf.detect_frontend(jnp.asarray(img), interpret=True)]
    for g, e in zip(got, want):
        _map_close(g, e)
    assert ((got[0] > 0) != (want[0] > 0)).mean() < 1e-4
    assert (got[0] > 0).sum() > 100


def test_detect_frontend_no_angle_matches_jax_kernel():
    rng = np.random.default_rng(33)
    img = rng.uniform(0, 255, (1, 1, 96, 144)).astype(np.float32)
    got = detect_frontend.detect_frontend(torch.from_numpy(img), with_angle=False)
    want = jdf.detect_frontend(jnp.asarray(img), with_angle=False, interpret=True)
    assert got[1] is None and got[2] is None and want[1] is None
    _map_close(got[0].numpy(), want[0])


def _common_index(a, b):
    inv_a = {tuple(v): i for i, v in enumerate(a.tolist())}
    inv_b = {tuple(v): i for i, v in enumerate(b.tolist())}
    shared = sorted(set(inv_a) & set(inv_b))
    return (np.array([inv_a[v] for v in shared] + [len(a)]),
            np.array([inv_b[v] for v in shared] + [len(b)]),
            len(set(inv_a) ^ set(inv_b)))


def test_fused_flagship_matches_jax_fused_flagship(gray_image_pair, jax_kernel_interpreted):
    img1, img2 = gray_image_pair
    k1j, k2j, pj = (np.asarray(o) for o in jax_models.build(
        NAME, max_keypoints=K, fused_detect=True)(jnp.asarray(img1), jnp.asarray(img2)))
    fn = models.build(NAME, max_keypoints=K, fused_detect=True, device="cpu")
    assert fn.cfg.fused_detect
    reset_launch_counts()
    k1t, k2t, pt = (o.numpy() for o in fn(torch.from_numpy(img1), torch.from_numpy(img2)))
    assert all(c == 0 for c in launch_counts().values())
    assert pt.shape == pj.shape == (1, K + 1, K + 1)
    assert (k1t[0, :, 0] >= 0).sum() > K // 4
    ia1, ib1, s1 = _common_index(k1t[0], k1j[0])
    ia2, ib2, s2 = _common_index(k2t[0], k2j[0])
    assert max(s1, s2) <= 2, f"keypoint sets differ by {s1}, {s2}"
    np.testing.assert_allclose(pt[0][np.ix_(ia1, ia2)], pj[0][np.ix_(ib1, ib2)],
                               atol=P_ATOL, rtol=0)


def test_fused_extraction_matches_jax(gray_image_pair, jax_kernel_interpreted):
    img1, img2 = gray_image_pair
    out_j = [np.asarray(o) for o in jax_models.build(
        NAME + "_extraction", max_keypoints=K, max_matches=64,
        fused_detect=True)(jnp.asarray(img1), jnp.asarray(img2))]
    mk1, mk2, s, v = (o.numpy() for o in models.build(
        NAME + "_extraction", max_keypoints=K, max_matches=64, fused_detect=True,
        device="cpu")(torch.from_numpy(img1), torch.from_numpy(img2)))
    assert v.sum() > 32
    np.testing.assert_array_equal(v, out_j[3])
    np.testing.assert_array_equal(mk1, out_j[0])
    np.testing.assert_array_equal(mk2, out_j[1])
    np.testing.assert_allclose(s, out_j[2], atol=P_ATOL, rtol=0)


@pytest.mark.parametrize("topk_mode", ["block", "sort"])
def test_fused_matches_unfused_in_the_port(topk_mode):
    rng = np.random.default_rng(35)
    both = torch.from_numpy(rng.uniform(0, 255, (2, 1, 120, 160)).astype(np.float32))
    table = BADTable(load_bad_params(256))
    cfg = MatcherConfig(max_keypoints=64, topk_mode=topk_mode)
    kx, _, dx = _sparse_detect_describe(both, cfg, table)
    kp, _, dp = _sparse_detect_describe(both, cfg.with_(fused_detect=True), table)
    for b in range(2):
        ix = {tuple(v): i for i, v in enumerate(kx[b].tolist())}
        ip = {tuple(v): i for i, v in enumerate(kp[b].tolist())}
        assert len(set(ix) ^ set(ip)) <= 2
        for kpt in set(ix) & set(ip):
            np.testing.assert_allclose(dp[b, ip[kpt]].numpy(), dx[b, ix[kpt]].numpy(),
                                       atol=2e-3, rtol=0)


@pytest.mark.parametrize("h,w", [(120, 160), (97, 131)])
def test_detect_select_plain_matches_jax_fused_detect_select(h, w, jax_kernel_interpreted):
    rng = np.random.default_rng(h + w)
    img = rng.uniform(0, 255, (2, 1, h, w)).astype(np.float32)
    kw = dict(max_keypoints=64, block_size=5, nms_radius=5, topk_mode="block")
    margin = 16
    kj, sj, (m10j, m01j) = (o if isinstance(o, tuple) else np.asarray(o) for o in
                            jax_fused_detect_select(jnp.asarray(img), JaxMatcherConfig(**kw),
                                                    margin, True))
    masked_j = np.asarray(jdf.detect_frontend(jnp.asarray(img), block_size=5, nms_radius=5)[0])
    kt, st, masked_t, m10t, m01t = (o.numpy() for o in detect_frontend.detect_select_plain(
        torch.from_numpy(img), 5, 15, 2.5, 5, 64, 0.0, margin))
    assert kt.shape == (2, 64, 2) and st.shape == (2, 64)
    assert (st > 0).sum() > 64
    for b in range(2):
        ia, ib, swaps = _common_index(kt[b], np.asarray(kj[b]))
        assert swaps <= 2, f"keypoint sets differ by {swaps}"
        _map_close(st[b][ia[:-1]], np.asarray(sj[b])[ib[:-1]])
    for got, want in ((masked_t, masked_j), (m10t, m10j), (m01t, m01j)):
        _map_close(got, np.asarray(want))


@pytest.mark.parametrize("topk_mode,k,route", [("block", 64, "detect_select"),
                                               ("sort", 64, "detect_frontend"),
                                               ("block", 200, "detect_frontend")])
def test_fused_detect_select_route(monkeypatch, topk_mode, k, route):
    """Block mode with at least K blocks runs detect_select (one launch on
    a CUDA tensor); sort mode, and fewer blocks than K (a 48x64 map has 8 x
    11 = 88 blocks of 6 x 6), run the detect frontend and the premasked
    top-k after it. Either gives the plain composition's keypoints."""
    calls = []
    for name in ("detect_select", "detect_frontend"):
        orig = getattr(detect_frontend, name)
        monkeypatch.setattr(detect_frontend, name,
                            lambda *a, _o=orig, _n=name, **kw: calls.append(_n) or _o(*a, **kw))
    rng = np.random.default_rng(k)
    img = torch.from_numpy(rng.uniform(0, 255, (1, 1, 48, 64)).astype(np.float32))
    cfg = MatcherConfig(max_keypoints=k, topk_mode=topk_mode, nms_radius=5, block_size=5)
    kpts, kscores, (m10, m01) = shi_tomasi_family._fused_detect_select(img, cfg, 4, True)
    assert calls == [route]
    masked, m10_p, m01_p = detect_frontend.detect_frontend_plain(img, 5, 15, 2.5, 5)
    want = shi_tomasi_family._select_premasked(masked, cfg, 4)
    assert torch.equal(kpts, want[0]) and torch.equal(kscores, want[1])
    assert torch.equal(m10, m10_p) and torch.equal(m01, m01_p)


@pytest.mark.parametrize("frontend,with_angle", [("sparse", True), ("sparse", False),
                                                 ("dense", False)])
def test_unfused_route_takes_score_moments(monkeypatch, frontend, with_angle):
    """Where the device check asks for the kernel, the unfused sparse
    frontend (angle on and off) and the dense frontend take the score and
    the moments from one call of ``score_moments``; its plain version
    gives the plain stencils' keypoints, scores and descriptors. On a real
    CPU tensor no kernel counter ticks."""
    rng = np.random.default_rng(17 + with_angle)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 1, 48, 64)).astype(np.float32))
    cfg = MatcherConfig(max_keypoints=32, nms_radius=5, block_size=5)
    table = BADTable(load_bad_params(cfg.num_pairs))
    if frontend == "sparse":
        run = lambda: _sparse_detect_describe(img, cfg, table, with_angle=with_angle)
    else:
        run = lambda: shi_tomasi_family._dense_detect_describe(img, cfg, table)
    want = run()   # the CPU route: the plain stencils
    calls = []
    orig = detect_frontend.score_moments
    monkeypatch.setattr(detect_frontend, "score_moments",
                        lambda *a, **kw: calls.append(kw["with_angle"]) or orig(*a, **kw))
    monkeypatch.setattr(shi_tomasi_family, "use_kernel", lambda t: True)
    reset_launch_counts()
    got = run()
    assert calls == [with_angle]
    assert all(c == 0 for c in launch_counts().values())
    assert (want[1] > 0).sum() > 8
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("block,patch,with_angle", [(5, 15, True), (3, 9, True), (5, 15, False)])
def test_score_moments_plain_is_the_stencils(block, patch, with_angle):
    """``score_moments`` on a CPU tensor is ``shi_tomasi_score`` and
    ``angle_moments``; without the angle its moments are None."""
    rng = np.random.default_rng(block + patch)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 1, 37, 53)).astype(np.float32))
    score, m10, m01 = detect_frontend.score_moments(img, block, patch, 2.5, with_angle)
    assert torch.equal(score, ops.shi_tomasi_score(img, block_size=block))
    if with_angle:
        want = ops.angle_moments(img, patch_size=patch, sigma=2.5)
        assert torch.equal(m10, want[0]) and torch.equal(m01, want[1])
    else:
        assert m10 is None and m01 is None
