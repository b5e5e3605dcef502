"""``models.jit`` (``core/jit.py``), the port's ``jax.jit``, on the CPU.

On CPU tensors a jitted pipeline calls its module, so it is held here
against the JAX package's jitted builds on the same seeded inputs, at the
tolerances of the streaming and serving parity tests (keypoints and matched
coordinates equal, P and match scores within 5e-3): the flagship's
``_extraction``, its streaming split and ``build_batched`` at chunk 2. Beside
them: the signature key, the forwarded attributes, copies, the mesh's jitted
replicas and the entry points that call through ``jit``. The graphs
themselves (capture, replay, the clones of the outputs) need the card:
``tests/test_torch_jit_cuda.py``.
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu_torch import core, models
from onnx_image_processing_tpu_torch.cli import feature_detection as fd
from onnx_image_processing_tpu_torch.cli import image_matching as im
from onnx_image_processing_tpu_torch.cli import image_matching_extraction as ime
from onnx_image_processing_tpu_torch.cli import visual_odometry as vo
from onnx_image_processing_tpu_torch.core.jit import Jitted, signature
from onnx_image_processing_tpu_torch.parallel import make_mesh, shard_batch
from test_torch_essential import parallax_pair

FLAGSHIP = "shi_tomasi_angle_sparse_bad_sinkhorn"
H, W = 64, 96
KW = dict(max_keypoints=64, max_matches=24)
P_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    return parallax_pair(H, W)


def _assert_matches_jax(ours, ref, score_index):
    """Coordinates, keypoints and masks equal; the float leaf at
    ``score_index`` (P or the match scores) within P_ATOL."""
    ours, ref = [t.numpy() for t in ours], [np.asarray(t) for t in ref]
    assert len(ours) == len(ref)
    for i, (got, want) in enumerate(zip(ours, ref)):
        assert got.shape == want.shape and got.dtype == want.dtype
        if i == score_index:
            np.testing.assert_allclose(got, want, atol=P_ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(got, want)


def test_jitted_extraction_matches_jax(scene):
    name = FLAGSHIP + "_extraction"
    module = models.build(name, device="cpu", **KW)
    fn = models.jit(module)
    a, b = (torch.from_numpy(x) for x in scene)
    ours = fn(a, b)
    for x, y in zip(ours, module(a, b)):
        assert torch.equal(x, y)
    ref = jax_models.build(name, use_pallas=False, **KW)(*(jnp.asarray(x) for x in scene))
    _assert_matches_jax(ours, ref, 2)
    assert ours[3].sum() >= 8
    assert fn.graphs == 0 and fn.replays == 0


@pytest.mark.parametrize("name", [FLAGSHIP, FLAGSHIP + "_extraction"])
def test_jitted_streaming_split_matches_jax(name, scene):
    extract, match = map(models.jit, models.build_streaming(name, device="cpu", **KW))
    a, b = (torch.from_numpy(x) for x in scene)
    feats = extract(a), extract(b)
    assert all(isinstance(f, tuple) and len(f) == 3 for f in feats)
    ours = match(*feats)
    j_extract, j_match = jax_models.build_streaming(name, use_pallas=False, **KW)
    ref = j_match(*(j_extract(jnp.asarray(x)) for x in scene))
    _assert_matches_jax(ours, ref, 2)
    for mine, theirs in zip(feats[0], j_extract(jnp.asarray(scene[0]))):
        if mine.dtype == torch.float32 and mine.ndim == 3 and mine.shape[-1] != 2:
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=P_ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_jitted_build_batched_matches_jax():
    pairs = [parallax_pair(H, W, seed=s) for s in range(4)]
    img1, img2 = (np.concatenate(side) for side in zip(*pairs))
    fb = models.jit(models.build_batched(FLAGSHIP, chunk=2, device="cpu", **KW))
    assert fb.chunk == 2 and fb.pipeline is fb.module.pipeline
    ours = fb(torch.from_numpy(img1), torch.from_numpy(img2))
    assert ours[2].shape == (4, 65, 65)
    ref = jax_models.build_batched(FLAGSHIP, chunk=2, use_pallas=False, **KW)(
        jnp.asarray(img1), jnp.asarray(img2))
    _assert_matches_jax(ours, ref, 2)


def test_signature_is_a_pure_key():
    x, y = torch.zeros(2, 3), torch.ones(2, 3)
    key = signature((x, y))
    assert signature((y, x)) == key                          # values do not count
    assert signature((x.t().contiguous().t(), y)) == key     # nor strides
    assert signature((torch.zeros(2, 4), y)) != key          # shape
    assert signature((x.double(), y)) != key                 # dtype
    assert signature((torch.zeros(2, 3, device="meta"), y)) != key   # device
    assert signature(((x, y),)) != key                       # tree
    assert signature(([x, y],)) != signature(((x, y),))
    assert signature((x,)) != key
    for leaf in (3, 0.5, None, np.zeros(3)):
        with pytest.raises(TypeError, match="every input leaf must be a tensor"):
            signature((x, leaf))


def test_call_checks_its_inputs():
    fn = models.jit(lambda *xs: xs[0] * 2)
    with pytest.raises(TypeError, match="must be a tensor"):
        fn(torch.zeros(2), 1.0)
    with pytest.raises(ValueError, match="must lie on one device"):
        fn(torch.zeros(2), torch.zeros(2, device="meta"))
    assert torch.equal(fn(torch.ones(2)), torch.full((2,), 2.0))


def test_attributes_are_the_modules():
    module = models.build(FLAGSHIP, device="cpu", max_keypoints=32)
    fn = models.jit(module)
    assert isinstance(fn, core.Jitted) and fn.module is module
    assert models.jit(fn) is fn and models.Jitted is Jitted
    assert fn.cfg is module.cfg and fn.device == torch.device("cpu")
    assert fn.pipeline_name == FLAGSHIP and fn.capture_blocker is None
    assert (fn.graphs, fn.replays, fn.capture_seconds, fn.captures) == (0, 0, 0.0, [])
    with pytest.raises(AttributeError, match="table"):
        fn.table                                             # not forwarded
    extract, match = models.build_streaming(FLAGSHIP + "_extraction", device="cpu",
                                            max_keypoints=32)
    assert models.jit(extract).pipeline_name == FLAGSHIP + "_streaming_extract"
    assert models.jit(match).pipeline_name == FLAGSHIP + "_extraction_streaming_match"
    assert models.jit(match).capture_blocker is None


def test_copies_start_without_graphs():
    """A copy holds its own module and no graph; ``to()`` moves the module
    and drops every graph (a graph reads memory of the device it was
    captured on)."""
    fn = models.jit(models.build(FLAGSHIP, device="cpu", max_keypoints=32))
    fn._graphs[("stale",)] = None
    dup = copy.deepcopy(fn)
    assert isinstance(dup, Jitted) and dup.graphs == 0 and fn.graphs == 1
    assert dup.module is not fn.module and dup.module.cfg == fn.module.cfg
    assert dup.pipeline_name == FLAGSHIP
    assert fn.to("cpu") is fn and fn.graphs == 0


def test_shard_batch_jits_each_replica(scene):
    """Over an explicit CPU mesh every device's replica is a ``Jitted``
    (one, shared: the module lies on the CPU), a jitted argument is used as
    it is, and the sharded call equals the unsharded one."""
    mesh = make_mesh([torch.device("cpu")] * 4)
    module = models.build(FLAGSHIP, device="cpu", max_keypoints=32)
    pairs = [parallax_pair(H, W, seed=s) for s in range(4)]
    img1, img2 = (np.concatenate(side) for side in zip(*pairs))
    local = module(torch.from_numpy(img1), torch.from_numpy(img2))
    jitted = models.jit(module)
    for fn, method in ((module, "shard_map"), (jitted, "shard_map"), (jitted, "jit")):
        sharded = shard_batch(fn, mesh, method=method)
        (replica,) = set(sharded.replicas.values())
        assert isinstance(replica, Jitted) and replica.module is module
        assert (replica is jitted) == (fn is jitted)
        out = sharded(img1, img2)
        assert all(torch.equal(s.gather(), t) for s, t in zip(out, local))


def test_vo_matcher_is_jitted(scene):
    cfg = models.get(FLAGSHIP).defaults.with_(**KW)
    extract, match = vo.build_vo_matcher(FLAGSHIP, cfg, True, "cpu")
    none, two = vo.build_vo_matcher(FLAGSHIP + "_extraction", cfg, False, "cpu")
    assert none is None and all(isinstance(f, Jitted) for f in (extract, match, two))
    assert extract.module.matcher is match.module.matcher
    a, b = (torch.from_numpy(x) for x in scene)
    for x, y in zip(match(extract(a), extract(b)), two(a, b)):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jit_clis")
    paths = []
    for i, img in enumerate(parallax_pair(H, W)):
        paths.append(os.path.join(d, f"{i}.png"))
        Image.fromarray(img[0, 0].astype(np.uint8)).save(paths[-1])
    return paths


@pytest.mark.parametrize("cli,device_fn,args", [
    (fd, "detect", ["-m", "shi_tomasi", "--benchmark"]),
    (im, "match", ["-k", "64"]),
    (ime, "match", ["--max-matches", "24"])])
def test_image_clis_call_through_jit(cli, device_fn, args, pngs, tmp_path, monkeypatch, capsys):
    """The CLIs' device function and host benchmark get ``models.jit`` of
    the pipeline, as the JAX CLIs get a jitted ``build``."""
    seen = []
    real_fn, real_bench = getattr(cli, device_fn), cli.run_benchmark

    def device_call(fn, *arrays):
        seen.append(("device", fn))
        return real_fn(fn, *arrays)

    def bench(fn, tensors, timing):
        seen.append(("benchmark", fn))
        return real_bench(fn, tensors, timing)

    monkeypatch.setattr(cli, device_fn, device_call)
    monkeypatch.setattr(cli, "run_benchmark", bench)
    images = ["-i", pngs[0]] if cli is fd else ["-i1", pngs[0], "-i2", pngs[1]]
    assert cli.main(images + args + ["--height", str(H), "--width", str(W), "--device", "cpu",
                                     "-o", str(tmp_path / "out.png")]) == 0
    assert [kind for kind, _ in seen] == ["device", "benchmark"]
    assert all(isinstance(fn, Jitted) for _, fn in seen)
    assert "Elapsed:" in capsys.readouterr().out
