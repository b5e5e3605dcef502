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
from onnx_image_processing_tpu_torch.models.registry import k_inv_for

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


ESSENTIAL = [("shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix", dict(max_keypoints=64)),
             ("shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix",
              dict(max_keypoints=64, essential_ransac_hypotheses=128, essential_irls_iters=2)),
             ("akaze_sparse_bad_sinkhorn_essential_matrix", dict(max_keypoints=64)),
             ("essential_matrix_estimator", {})]


def _essential_inputs(dev, name, fn):
    """The path's inputs and a second set (another pair; P mirrored)."""
    spec = models.get(name)
    if spec.make_args is not None:
        args = models.arg_specs(spec, fn.cfg, H, W, device=dev)
        return args, (args[0].flip(-1), args[1])
    k_inv = torch.from_numpy(k_inv_for(H, W)).to(dev)
    return (*_pair(dev), k_inv), (*_pair(dev, seed=4), k_inv)


@pytest.mark.parametrize("name,kw", ESSENTIAL)
def test_essential_names_capture(dev, name, kw):
    """The essential solve reads nothing on the host: a graph of one call,
    replayed on two inputs in turn, equals the eager call bit for bit, and
    the chain protocol runs."""
    fn = models.build(name, device=dev, **kw)
    inputs = _essential_inputs(dev, name, fn)
    static = tuple(a.clone() for a in inputs[0])
    with torch.inference_mode():
        eager = [_leaves(fn(*x)) for x in inputs]
        cap = common.capture(lambda: fn(*static), dev)
        for i in range(4):
            for dst, src in zip(static, inputs[i % 2]):
                dst.copy_(src)
            cap.graph.replay()
            torch.cuda.synchronize(dev)
            assert all(torch.equal(a, b) for a, b in zip(_leaves(cap.out), eager[i % 2]))
        t = common.chain_times(fn, inputs[0], n=2, reps=1)
    assert not all(torch.equal(a, b) for a, b in zip(*eager))
    assert math.isfinite(t.ms_per_frame) and t.capture_s > 0


@pytest.mark.parametrize("name,kw", ESSENTIAL)
def test_essential_path_calls_no_cusolver(dev, name, kw, monkeypatch):
    """On CUDA tensors the essential path reaches neither
    ``torch.linalg.eigh`` nor ``torch.linalg.svd``; it launches the
    minimum-eigenvector and projection kernels (and, with RANSAC, the
    hypothesis kernel)."""
    from onnx_image_processing_tpu_torch.kernels import launch_counts, reset_launch_counts

    for attr in ("eigh", "svd"):
        real = getattr(torch.linalg, attr)

        def refuse(t, *a, real=real, attr=attr, **k):
            if t.is_cuda:
                raise AssertionError(f"torch.linalg.{attr} on a CUDA tensor")
            return real(t, *a, **k)

        monkeypatch.setattr(torch.linalg, attr, refuse)
    fn = models.build(name, device=dev, **kw)
    reset_launch_counts()
    out = _leaves(fn(*_essential_inputs(dev, name, fn)[0]))
    torch.cuda.synchronize(dev)
    counts = launch_counts()
    assert counts["min_eigvec9"] > 0 and counts["project_essential"] > 0
    assert (counts["essential_hypotheses"] > 0) == bool(kw.get("essential_ransac_hypotheses"))
    assert torch.isfinite(out[-1]).all() and out[-1].shape == (3, 3)
