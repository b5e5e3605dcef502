"""The CLI timing layer on the card: whole pipelines captured in CUDA
graphs (``cli/common.py`` ``capture``, ``chain_times``).

Marked ``cuda``; each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_timing_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.cli import common

pytestmark = pytest.mark.cuda

FLAGSHIP = "shi_tomasi_angle_sparse_bad_sinkhorn"
H, W = 120, 160


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(dev, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (1, 1, H, W)).astype(np.float32)
    return (torch.from_numpy(img).to(dev),
            torch.from_numpy(np.roll(img, 5, axis=3).copy()).to(dev))


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name,kw", [
    (FLAGSHIP, dict(max_keypoints=64)),
    (FLAGSHIP, dict(max_keypoints=64, fused_detect=True)),
    (FLAGSHIP + "_extraction", dict(max_keypoints=64, max_matches=32)),
    ("akaze_sparse_bad_sinkhorn", dict(max_keypoints=64)),
    ("shi_tomasi_bad_sinkhorn", dict(max_keypoints=128))])
def test_graph_of_one_call_equals_eager(dev, name, kw):
    """A graph of one call, replayed again and again on two inputs in turn
    (copied into the tensors it was captured on), equals the eager call on
    the same input bit for bit."""
    fn = models.build(name, device=dev, **kw)
    inputs = (_pair(dev), _pair(dev, seed=4))
    static = tuple(a.clone() for a in inputs[0])
    with torch.inference_mode():
        eager = [_leaves(fn(*x)) for x in inputs]
        cap = common.capture(lambda: fn(*static), dev)
        for i in range(6):
            for dst, src in zip(static, inputs[i % 2]):
                dst.copy_(src)
            cap.graph.replay()
            torch.cuda.synchronize(dev)
            assert all(torch.equal(a, b) for a, b in zip(_leaves(cap.out), eager[i % 2]))
    assert not all(torch.equal(a, b) for a, b in zip(*eager))


def test_voxel_downsampling_captures(dev):
    fn = models.build("voxel_downsampling", device=dev)
    args = models.arg_specs(models.get("voxel_downsampling"), fn.cfg, H, W, device=dev)
    eager = fn(*args)
    cap = common.capture(lambda: fn(*args), dev)
    cap.graph.replay()
    torch.cuda.synchronize(dev)
    assert all(torch.equal(a, b) for a, b in zip(cap.out, eager))


def test_chain_on_the_card(dev):
    fn = models.build(FLAGSHIP, max_keypoints=64, device=dev)
    args = _pair(dev)
    with torch.inference_mode():
        t = common.chain_times(fn, args, n=4, reps=2)
        first = float(fn(*args)[0][0, 0, 0])
        cap = common.capture(lambda: common._chain(fn, args, 3), dev)
        cap.graph.replay()
        torch.cuda.synchronize(dev)
    assert math.isfinite(t.ms_per_frame) and t.ms_per_frame > 0
    assert t.capture_s > 0 and t.peak_bytes > 0
    assert float(cap.out) == 3 * first


@pytest.mark.parametrize("name", ["akaze_sparse_bad_sinkhorn_essential_matrix",
                                  "essential_matrix_estimator"])
def test_essential_names_raise_before_capture(dev, name):
    spec = models.get(name)
    fn = models.build(name, device=dev)
    args = models.arg_specs(spec, fn.cfg, H, W, device=dev)
    with pytest.raises(ValueError, match="cuSOLVER"):
        common.benchmark_chain(fn, args, n=2, reps=1)
