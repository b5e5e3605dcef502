"""The port's CLI timing layer on the CPU (``cli/common.py``): the chain
protocol against the JAX package's ``lax.scan`` chain, ``benchmark_chain``,
``--timing`` in the three image CLIs, and the CUDA-graph chain's refusal
of a pipeline that names a capture blocker (no registry name does).

The JAX chain below is the body of the JAX package's
``cli/common.py`` ``benchmark_chain`` (its ``lax.scan`` over ``fn``),
written out so that its summed scalar can be read. At 96x128 with 64
keypoints the flagship's first output is keypoint coordinates, so the two
chains' sums must be equal exactly.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.cli import common
from onnx_image_processing_tpu_torch.cli import feature_detection as fd
from onnx_image_processing_tpu_torch.cli import image_matching as im
from onnx_image_processing_tpu_torch.cli import image_matching_extraction as ime

FLAGSHIP = "shi_tomasi_angle_sparse_bad_sinkhorn"
CHAIN_LEN = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_chain(fn, args, length):
    """The JAX package's differential chain body, ``lax.scan``-ed ``length``
    times and jitted; returns the summed scalar."""
    @jax.jit
    def run(*a):
        def body(carry, _):
            out = fn(*carry)
            leaf = out[0] if isinstance(out, (tuple, list)) else out
            s = leaf.ravel()[0].astype(carry[0].dtype)
            new = tuple(c + s * 1e-12 for c in carry)
            return new, s
        _, outs = jax.lax.scan(body, a, None, length=length)
        return outs.sum()

    return float(run(*args))


def _pair(h=96, w=128, seed=7):
    rng = np.random.default_rng(seed)
    img1 = rng.uniform(0, 255, (1, 1, h, w)).astype(np.float32)
    return img1, np.roll(img1, 5, axis=3).copy()


def test_flagship_chain_sum_equals_jax():
    img1, img2 = _pair()
    j_fn = jax_models.build(FLAGSHIP, max_keypoints=64)
    want = _jax_chain(j_fn, (jnp.asarray(img1), jnp.asarray(img2)), CHAIN_LEN)
    fn = models.build(FLAGSHIP, max_keypoints=64, device="cpu")
    with torch.inference_mode():
        got = float(common._chain(fn, (torch.from_numpy(img1), torch.from_numpy(img2)),
                                  CHAIN_LEN))
        first = float(fn(torch.from_numpy(img1), torch.from_numpy(img2))[0][0, 0, 0])
    assert got == want
    assert got == CHAIN_LEN * first > 0


def test_benchmark_chain_on_the_cpu_needs_no_graph(monkeypatch):
    """On CPU tensors the chain is a plain loop: nothing asks for CUDA."""
    fn = models.build("shi_tomasi", device="cpu")
    img = torch.from_numpy(_pair(48, 64)[0])

    def no_cuda(*a, **k):
        raise AssertionError("the CPU chain touched CUDA")

    for attr in ("graph", "CUDAGraph", "is_available", "synchronize"):
        monkeypatch.setattr(torch.cuda, attr, no_cuda)
    with torch.inference_mode():
        t = common.chain_times(fn, (img,), n=2, reps=2)
        ms = common.benchmark_chain(fn, (img,), n=2, reps=1)
    assert math.isfinite(t.ms_per_frame) and t.ms_per_frame > 0
    assert t.long_s > 0 and t.short_s > 0
    assert t.capture_s == 0.0 and t.peak_bytes is None
    assert math.isfinite(ms) and ms > 0


def test_chain_carries_every_input():
    """Each call runs on the previous call's carry: every input moves by
    s * 1e-12, and the s are summed."""
    seen = []

    def fn(a, b):
        seen.append((a.clone(), b.clone()))
        return (a[..., :1] * 0 + 2.0, b)

    a = torch.zeros((1, 2)); b = torch.ones((1, 2))
    total = common._chain(fn, (a, b), 3)
    assert float(total) == 6.0
    assert torch.equal(seen[0][0], a) and torch.equal(seen[0][1], b)
    assert torch.equal(seen[2][0], a + 2e-12 + 2e-12)
    assert torch.equal(seen[1][1], b + 2.0 * 1e-12)


ESSENTIAL = ["shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix",
             "akaze_sparse_bad_sinkhorn_essential_matrix", "essential_matrix_estimator"]


@pytest.mark.parametrize("name", ESSENTIAL)
def test_essential_names_carry_no_capture_blocker(name):
    """The essential solve runs as kernels on the card and reads nothing on
    the host, so these names capture like the rest."""
    fn = models.build(name, device="cpu")
    assert fn.pipeline_name == name and fn.capture_blocker is None


def test_captured_names_carry_no_blocker():
    """Every registry name (the matchers, their extraction and essential
    forms, the heads, sinkhorn, the estimator and voxel downsampling)
    captures on the card."""
    blocked = {n for n in models.names() if models.get(n).capture_blocker}
    assert blocked == set()
    fn = models.build(FLAGSHIP, fused_detect=True, device="cpu")
    assert fn.capture_blocker is None and common._path_name(fn) == FLAGSHIP
    assert common._path_name(lambda *a: a) == "function"


def test_chain_refuses_a_blocked_function_before_capture(monkeypatch):
    """A pipeline that names a capture blocker is refused on the card
    before anything is captured or synchronized; on the CPU it runs."""
    def fn(x):
        return x + 1

    fn.capture_blocker = "it reads a value on the host"
    fn.pipeline_name = "blocked"

    def no_cuda(*a, **k):
        raise AssertionError("touched CUDA before the refusal")

    for attr in ("graph", "CUDAGraph", "synchronize", "reset_peak_memory_stats",
                 "memory_allocated"):
        monkeypatch.setattr(torch.cuda, attr, no_cuda)

    class OnTheCard:   # chain_times reads only the device of its first argument
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="blocked cannot be captured in a CUDA graph: "
                                         "it reads a value on the host"):
        common.benchmark_chain(fn, (OnTheCard(),), n=2, reps=1)
    assert common.chain_times(fn, (torch.zeros(3),), n=2, reps=1).ms_per_frame > 0


@pytest.mark.parametrize("name", ESSENTIAL)
def test_essential_chain_on_the_cpu_equals_its_calls(name):
    """The CPU chain of an essential name (a plain loop) equals its calls
    made one by one: each on the carry (every input moved by s * 1e-12),
    their first outputs' first elements s summed in float32."""
    kw = dict(max_keypoints=64) if name != "essential_matrix_estimator" else {}
    fn = models.build(name, device="cpu", **kw)
    args = models.arg_specs(models.get(name), fn.cfg, 64, 80, device="cpu")
    with torch.inference_mode():
        got = common._chain(fn, args, CHAIN_LEN)
        carry, calls = args, []
        for _ in range(CHAIN_LEN):
            calls.append(fn(*carry)[0].reshape(-1)[0])
            carry = tuple(c + calls[-1] * 1e-12 for c in carry)
        t = common.chain_times(fn, args, n=1, reps=1)
    assert got.dtype == torch.float32 and torch.equal(got, calls[0] + calls[1] + calls[2])
    assert math.isfinite(t.ms_per_frame) and t.capture_s == 0.0


# ---- the three CLIs -------------------------------------------------------

H, W = 64, 80
SIZE = ["--height", str(H), "--width", str(W)]
CHAIN_LINE = r"Elapsed \(device, chain protocol\): [0-9.]+ ms/frame \([0-9.]+ fps\)"
HOST_LINE = r"Elapsed: [0-9.]+ ms/frame \([0-9.]+ fps\) on cpu\n"


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    img1, img2 = _pair(H, W, seed=11)
    d = tmp_path_factory.mktemp("timing")
    paths = (os.path.join(d, "a.png"), os.path.join(d, "b.png"))
    for p, a in zip(paths, (img1, img2)):
        Image.fromarray(a[0, 0].astype(np.uint8)).save(p)
    return paths


def _cli_args(cli, pngs, out):
    if cli is fd:
        return ["-i", pngs[0], "--benchmark", "-k", "50", "-o", out]
    if cli is im:
        return ["-i1", pngs[0], "-i2", pngs[1], "-k", "32", "-o", out]
    return ["-i1", pngs[0], "-i2", pngs[1], "--max-matches", "16", "-o", out]


@pytest.mark.parametrize("timing", ["chain", "host"])
@pytest.mark.parametrize("cli", [fd, im, ime], ids=["feature_detection", "image_matching",
                                                   "image_matching_extraction"])
def test_cli_timing_flag(cli, timing, pngs, tmp_path, capsys, monkeypatch):
    """``--timing chain --device cpu`` prints the chain line (a short chain
    here: the protocol itself is held above), ``--timing host`` the host
    loop's line, as before. The extraction CLI has no keypoint flag; its
    pipeline is built with 32 keypoints to keep the CPU's sampler short."""
    monkeypatch.setattr(common.benchmark_chain, "__defaults__", (2, 1))
    if cli is ime:
        build = models.build
        monkeypatch.setattr(models, "build",
                            lambda name, **kw: build(name, max_keypoints=32, **kw))
    out = str(tmp_path / "o.png")
    assert cli.main(_cli_args(cli, pngs, out) + SIZE + ["--device", "cpu",
                                                       "--timing", timing]) == 0
    text = capsys.readouterr().out
    assert os.path.getsize(out) > 0
    assert re.search(CHAIN_LINE if timing == "chain" else HOST_LINE, text), text
    assert re.search(HOST_LINE if timing == "chain" else CHAIN_LINE, text) is None


def test_timing_defaults_to_host(pngs):
    for cli in (fd, im, ime):
        assert cli.parse_args(_cli_args(cli, pngs, "x.png")).timing == "host"
    with pytest.raises(SystemExit):
        im.parse_args(_cli_args(im, pngs, "x.png") + ["--timing", "scan"])
