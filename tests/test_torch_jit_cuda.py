"""``models.jit`` on the card: whole calls captured in CUDA graphs
(``core/jit.py``), replayed on new inputs and held to the eager module.

Marked ``cuda``; each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_jit_cuda.py -q
"""

import copy

import numpy as np
import pytest
import torch
from torch import nn

from onnx_image_processing_tpu_torch import models

pytestmark = pytest.mark.cuda

FLAGSHIP = "shi_tomasi_angle_sparse_bad_sinkhorn"
H, W = 120, 160
KW = dict(max_keypoints=64, max_matches=32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _images(dev, seed, b=1, h=H, w=W):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (b, 1, h, w)).astype(np.float32)
    return (torch.from_numpy(img).to(dev),
            torch.from_numpy(np.roll(img, 5, axis=3).copy()).to(dev))


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for x in out for leaf in _leaves(x)]
    return [out]


def _equal(a, b) -> bool:
    a, b = _leaves(a), _leaves(b)
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))


def _paths(dev):
    """(label, eager module, its two inputs): the flagship, its streaming
    match (feature tuples in) and ``build_batched`` at chunk 2 over 4 pairs."""
    flagship = models.build(FLAGSHIP + "_extraction", device=dev, **KW)
    extract, match = models.build_streaming(FLAGSHIP + "_extraction", device=dev, **KW)
    pairs = (_images(dev, 1), _images(dev, 2))
    with torch.no_grad():
        feats = [tuple(extract(x) for x in pair) for pair in pairs]
    batched = models.build_batched(FLAGSHIP, chunk=2, device=dev, **KW)
    return [("flagship", flagship, pairs),
            ("streaming extract", extract, [(p[0],) for p in pairs]),
            ("streaming match", match, feats),
            ("batched chunk 2", batched, (_images(dev, 3, b=4), _images(dev, 4, b=4)))]


@pytest.mark.parametrize("index", range(4))
def test_replays_equal_eager_and_keep_held_outputs(dev, index):
    """Alternating inputs: every call equals the eager module on the same
    inputs bit for bit, one graph serves them all, and call i's outputs are
    unchanged after call i + 1 (each call returns fresh tensors)."""
    label, module, inputs = _paths(dev)[index]
    with torch.inference_mode():
        eager = [module(*x) for x in inputs]
        assert not _equal(*eager), label
        fn = models.jit(module)
        held = [fn(*inputs[i % 2]) for i in range(5)]
        torch.cuda.synchronize(dev)
    assert all(_equal(h, eager[i % 2]) for i, h in enumerate(held)), label
    assert (fn.graphs, fn.replays) == (1, 5) and fn.capture_seconds > 0
    outs = [t.data_ptr() for h in held for t in _leaves(h)]
    assert len(set(outs)) == len(outs)


def test_new_shape_makes_a_second_graph(dev):
    fn = models.jit(models.build(FLAGSHIP, device=dev, **KW))
    small, large = _images(dev, 5), _images(dev, 6, h=2 * H, w=2 * W)
    with torch.inference_mode():
        fn(*small)
        fn(*small)
        assert fn.graphs == 1
        out = fn(*large)
        want = fn.module(*large)
    assert fn.graphs == 2 and fn.replays == 3 and _equal(out, want)
    # Outside inference mode too: the static buffers take the copy.
    assert _equal(fn(*large), want)


class _ReadsHost(nn.Module):
    pipeline_name = "reads_host"

    def forward(self, x):
        return x * float(x.sum().item())


def test_a_host_read_raises_at_capture_naming_the_pipeline(dev):
    fn = models.jit(_ReadsHost())
    with pytest.raises(RuntimeError, match="CUDA-graph capture of reads_host failed"):
        fn(torch.ones(4, device=dev))
    assert fn.graphs == 0
    # The card is usable afterwards, and nothing fell back to eager.
    assert torch.equal(torch.ones(4, device=dev) * 2, torch.full((4,), 2.0, device=dev))


def test_a_capture_blocker_raises_before_capture(dev):
    module = models.build(FLAGSHIP, device=dev, **KW)
    module.capture_blocker = "it reads a value on the host"
    fn = models.jit(module)
    with pytest.raises(ValueError, match=f"{FLAGSHIP} cannot be captured in a CUDA graph: "
                                         "it reads a value on the host"):
        fn(*_images(dev, 7))
    assert fn.graphs == 0 and fn.replays == 0


def test_mixed_devices_raise(dev):
    fn = models.jit(models.build(FLAGSHIP, device=dev, **KW))
    a, b = _images(dev, 8)
    with pytest.raises(ValueError, match="must lie on one device"):
        fn(a, b.cpu())


def test_copies_start_without_a_graph(dev):
    fn = models.jit(models.build(FLAGSHIP, device=dev, **KW))
    pair = _images(dev, 9)
    with torch.inference_mode():
        want = fn(*pair)
    assert fn.graphs == 1
    dup = copy.deepcopy(fn).to(dev)
    assert dup.graphs == 0 and dup.replays == 0 and fn.graphs == 1
    with torch.inference_mode():
        assert _equal(dup(*pair), want)
    assert dup.graphs == 1
    assert fn.to(dev) is fn and fn.graphs == 0
