"""The port's batch data parallelism (``parallel/mesh.py``) on a mesh of
8 x ``torch.device("cpu")``: the counterpart of the JAX package's
``tests/test_parallel.py`` on its virtual 8-device CPU host.

The port's CPU path is batch-independent (every stage works per image or
per pair, the Sinkhorn cost one entry at a time), so a sharded call equals
the unsharded one bit for bit. The last test shards over every GPU; it is
marked ``cuda`` and skips below two devices.
"""

import numpy as np
import pytest
import torch

from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.core.jit import WARMUP_CALLS
from onnx_image_processing_tpu_torch.parallel import (batch_sharding, device_put_batch,
                                                      make_mesh, shard_batch)
from onnx_image_processing_tpu_torch.parallel.mesh import ShardedTensor

FLAGSHIP = "shi_tomasi_angle_sparse_bad_sinkhorn"
SMALL = dict(max_keypoints=32, num_pairs=256)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh([torch.device("cpu")] * 8)


def _pairs(seed, b=8, h=72, w=96):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (b, 1, h, w)).astype(np.float32) for _ in range(2)]


def _assert_sharded_equal(sharded, local, mesh):
    assert len(sharded) == len(local)
    for s, t in zip(sharded, local):
        assert isinstance(s, ShardedTensor)
        assert s.sharding == batch_sharding(mesh)
        assert [p.device for p in s.shards] == list(mesh.devices)
        assert s.shape == tuple(t.shape)
        assert torch.equal(s.gather("cpu"), t)


def test_sharded_matcher_equals_unsharded(mesh):
    """The flagship at B = 8, one pair per device, equals the unsharded call."""
    fn = models.build(FLAGSHIP, device="cpu", **SMALL)
    i1, i2 = _pairs(0)
    sharded = shard_batch(fn, mesh)(i1, i2)
    local = fn(torch.from_numpy(i1), torch.from_numpy(i2))
    _assert_sharded_equal(sharded, local, mesh)


def test_shard_batch_rejects_indivisible(mesh):
    f = shard_batch(lambda x: x * 2, mesh)
    with pytest.raises(ValueError, match="batch 3 not divisible by mesh size 8"):
        f(torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="not divisible"):
        device_put_batch(np.zeros((12, 2), np.float32), mesh)


def test_device_put_batch_places_shards(mesh):
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    placed = device_put_batch(x, mesh)
    assert len(placed.shards) == len(mesh) == 8
    assert all(p.shape == (2, 4) and p.device == d for p, d in zip(placed.shards, mesh.devices))
    np.testing.assert_array_equal(placed.shards[3].numpy(), x[6:8])
    np.testing.assert_array_equal(placed.gather().numpy(), x)
    with pytest.raises(ValueError, match="axis"):
        device_put_batch(x, mesh, axis_name="pairs")


def test_streaming_shards_over_mesh(mesh):
    """Extract, then match over the feature tuples, both sharded: the
    feature trees pass through as sharded leaves, and the result equals the
    unsharded streaming composition."""
    ex_fn, ma_fn = models.build_streaming(FLAGSHIP, device="cpu", max_keypoints=16,
                                          num_pairs=256)
    f0, f1 = _pairs(4, h=48, w=64)
    sharded_ex = shard_batch(ex_fn, mesh)
    feats0 = sharded_ex(device_put_batch(f0, mesh))
    feats1 = sharded_ex(f1)
    assert isinstance(feats0, tuple) and all(isinstance(x, ShardedTensor) for x in feats0)
    out = shard_batch(lambda a, c: ma_fn(a, c), mesh)(feats0, feats1)
    local = ma_fn(ex_fn(torch.from_numpy(f0)), ex_fn(torch.from_numpy(f1)))
    _assert_sharded_equal(out, local, mesh)


def test_jit_method_equals_shard_map(mesh):
    """``method="jit"`` (one call on the gathered batch, outputs split
    again) gives the same result; it also serves a function that reduces
    across the batch, which the per-shard method cannot."""
    fn = models.build(FLAGSHIP, device="cpu", **SMALL)
    i1, i2 = _pairs(1)
    by_jit = shard_batch(fn, mesh, method="jit")(i1, i2)
    by_map = shard_batch(fn, mesh)(i1, i2)
    for a, b in zip(by_jit, by_map):
        assert [p.shape for p in a.shards] == [p.shape for p in b.shards]
        assert torch.equal(a.gather(), b.gather())

    def centre(x):
        return x - x.mean(dim=0, keepdim=True)

    x = torch.arange(16.0).reshape(16, 1)
    assert torch.equal(shard_batch(centre, mesh, method="jit")(x).gather(), centre(x))
    assert not torch.equal(shard_batch(centre, mesh)(x).gather(), centre(x))


def test_unknown_method_raises(mesh):
    with pytest.raises(ValueError, match="unknown shard_batch method 'pmap'"):
        shard_batch(lambda x: x, mesh, method="pmap")


def test_make_mesh_needs_cuda_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    m = make_mesh(["cpu", "cpu"], axis_name="pairs")
    assert m.devices == (torch.device("cpu"),) * 2 and m.axis_name == "pairs"
    assert batch_sharding(m, "pairs").mesh is m


@pytest.mark.cuda
def test_shard_batch_over_gpus():
    """The flagship sharded over every card (two or more) from a module on
    cuda:0 (copied to the others) equals the unsharded call on cuda:0, and
    each card ran its shard's kernels: its replica's first call, two eager
    warm-ups and the captured call, then one replay. A kernel op given a tensor on the
    last card while cuda:0 is current launches on the last card (each op
    makes its tensor's device current)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from onnx_image_processing_tpu_torch.kernels import (launch_counts, reset_launch_counts,
                                                         select_frontend, sinkhorn_kernel)

    mesh = make_mesh()
    n = len(mesh)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(n))
    fn = models.build(FLAGSHIP, device="cuda:0", max_keypoints=256)
    i1, i2 = _pairs(2, b=2 * n, h=240, w=320)
    reset_launch_counts()
    sharded = shard_batch(fn, mesh)
    out = sharded(i1, i2)
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    counts = launch_counts()
    calls = (WARMUP_CALLS + 1) * n
    assert counts["select_frontend"] == calls and counts["sinkhorn"] == calls, counts
    assert [(r.graphs, r.replays) for r in sharded.replicas.values()] == [(1, 1)] * n
    assert [p.device for p in out[2].shards] == list(mesh.devices)
    local = fn(torch.from_numpy(i1).cuda(0), torch.from_numpy(i2).cuda(0))
    for s, t in zip(out, local):
        assert torch.equal(s.gather("cuda:0"), t)

    last = mesh.devices[-1]
    rng = np.random.default_rng(3)
    with torch.cuda.device(0):
        s = torch.from_numpy(rng.random((2, 120, 160), dtype=np.float32)).to(last)
        assert torch.equal(select_frontend.nms_select_blocks(s, 5, 64)[0],
                           select_frontend.nms_select_blocks_plain(s, 5, 64)[0])
        ls = torch.from_numpy(rng.normal(size=(3, 40, 57)).astype(np.float32)).to(last)
        mu = torch.full((3, 40), -np.log(40.0), device=last)
        nu = torch.full((3, 57), -np.log(57.0), device=last)
        p = sinkhorn_kernel.sinkhorn_core(ls, mu, nu)
        assert p.device == last
        torch.testing.assert_close(p, sinkhorn_kernel.sinkhorn_core_plain(ls, mu, nu),
                                   rtol=0, atol=1e-5)

    # Every kernel (the fused flagship's detect kernel, AKAZE's ladder) on
    # the last card, from cuda:0 and from the last card itself: equal.
    a, b = (torch.from_numpy(x[:1]).to(last) for x in (i1, i2))
    for name, kw in ((FLAGSHIP, dict(fused_detect=True)), ("akaze_sparse_bad_sinkhorn", {})):
        m = models.build(name, device=last, max_keypoints=256, **kw)
        with torch.cuda.device(last):
            want = m(a, b)
        reset_launch_counts()
        with torch.cuda.device(0):
            got = m(a, b)
        torch.cuda.synchronize(last)
        assert sum(launch_counts().values()) >= 3
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
