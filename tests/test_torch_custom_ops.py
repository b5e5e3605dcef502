"""The port's hand kernels as ``torch.library`` custom ops, on the CPU.

Each of the eight kernel entries that a registry pipeline reaches is a
custom op in the ``oip`` namespace; on a CPU tensor it runs the kernel's
plain version. Checked here, at small shapes:

- ``torch.library.opcheck`` (schema, fake tensor, autograd registration,
  AOT dispatch with dynamic shapes) of each op;
- each op's fake (meta) output shapes against its CPU outputs, at the
  traced shape and, with symbolic input sizes, at a second shape;
- a CPU export of the flagship, the fused flagship and the AKAZE matcher
  holds the ops' nodes (what a CUDA artifact relies on: there the same
  nodes run the hand kernels).
"""

import numpy as np
import pytest
import sympy
import torch
from torch.export import Dim
from torch.utils._python_dispatch import TorchDispatchMode

from onnx_image_processing_tpu_torch import models, ops
from onnx_image_processing_tpu_torch.kernels import (akaze_ladder, detect_frontend,
                                                     select_frontend, sinkhorn_kernel,
                                                     sparse_sampler)
from onnx_image_processing_tpu_torch.ops import bad as bad_ops

SEED = 7


def _texture(rng, *shape):
    """A smooth texture in [0, 255] (corners for the detectors), float32."""
    h, w = shape[-2:]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 127 + 80 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
    return np.clip(base + rng.normal(0, 3, shape), 0, 255).astype(np.float32)


def _sampler_args(rng, b=2, h=64, w=80, k=16):
    table = ops.BADTable(ops.load_bad_params(256))
    image = torch.from_numpy(_texture(rng, b, 1, h, w))
    kpts = torch.from_numpy(np.stack([rng.uniform(0, h - 1, (b, k)),
                                      rng.uniform(0, w - 1, (b, k))], -1).astype(np.float32))
    xp, sy, sx, ly, lx = ops.box_sample_inputs(image, kpts, table)
    flat = [v for g in table.groups for v in g]
    return (xp, sy, sx, ly, lx, table.sample_radius, flat, bad_ops._PATCH, table.max_radius,
            False)


def _sinkhorn_args(rng, b=2, n=32, m=48, d=16):
    d1 = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32))
    d2 = torch.from_numpy(rng.normal(size=(b, m, d)).astype(np.float32))
    return (*ops.sinkhorn_inputs(d1, d2, epsilon=0.5), 20)


def _scores(rng, b=2, h=40, w=48):
    return torch.from_numpy(rng.uniform(0, 1, (b, h, w)).astype(np.float32))


def _image(rng, b=2, h=40, w=48):
    return torch.from_numpy(_texture(rng, b, 1, h, w))


# op, its arguments (from a numpy rng), and the symbolic dimensions of its
# tensor inputs ({input position: {axis: Dim}}) for the dynamic-shape check.
_H, _W = Dim("h", min=8), Dim("w", min=8)
CASES = {
    "nms_block_reduce": (select_frontend.nms_block_reduce_op,
                         lambda r, **s: (_scores(r, **s), 2, 0.01, 3), {0: {1: _H, 2: _W}}),
    "nms_select_blocks": (select_frontend.nms_select_blocks_op,
                          lambda r, **s: (_scores(r, **s), 2, 16, 0.01, 3), {0: {1: _H, 2: _W}}),
    "box_sample": (sparse_sampler.box_sample_op, lambda r, **s: _sampler_args(r), None),
    "sinkhorn_core": (sinkhorn_kernel.sinkhorn_core_op, lambda r, **s: _sinkhorn_args(r),
                      {0: {1: Dim("n1", min=2), 2: Dim("m1", min=2)}}),
    "detect_frontend": (detect_frontend.detect_frontend_op,
                        lambda r, **s: (_image(r, **s), 3, 7, 1.5, 2, True),
                        {0: {2: _H, 3: _W}}),
    "detect_frontend_no_angle": (detect_frontend.detect_frontend_op,
                                 lambda r, **s: (_image(r, **s), 3, 7, 1.5, 2, False),
                                 {0: {2: _H, 3: _W}}),
    "detect_select": (detect_frontend.detect_select_op,
                      lambda r, **s: (_image(r, **s), 3, 7, 1.5, 2, 16, 0.0, 2, True),
                      {0: {2: _H, 3: _W}}),
    "score_moments": (detect_frontend.score_moments_op,
                      lambda r, **s: (_image(r, **s), 5, 15, 2.5, True), {0: {2: _H, 3: _W}}),
    "score_moments_no_angle": (detect_frontend.score_moments_op,
                               lambda r, **s: (_image(r, **s), 5, 15, 2.5, False),
                               {0: {2: _H, 3: _W}}),
    "akaze_ladder": (akaze_ladder.akaze_ladder_op,
                     lambda r, **s: (_image(r, **s)[:, 0].contiguous(), 2, 2, 0.05, 0.001, 5,
                                     7, 1.5),
                     {0: {1: _H, 2: _W}}),
}


def _leaves(out):
    return out if isinstance(out, (tuple, list)) else (out,)


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck(case):
    op, make, _ = CASES[case]
    args = make(np.random.default_rng(SEED))
    torch.library.opcheck(op, args)


def test_every_kernel_entry_is_an_op():
    """The eight entries, each once in the ``oip`` namespace; the sampler's
    stage ablation (a tool, no pipeline) stays a direct call."""
    names = {op._opoverload._schema.name for op, _, _ in CASES.values()}
    assert names == {f"oip::{n}" for n in (
        "nms_block_reduce", "nms_select_blocks", "box_sample", "sinkhorn_core",
        "detect_frontend", "detect_select", "score_moments", "akaze_ladder")}
    assert not hasattr(torch.ops.oip, "box_sample_ablated")


@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_shapes_equal_cpu_shapes(case):
    """The fake implementation's output shapes and types equal the CPU
    run's, at the traced shape and, where the inputs have symbolic sizes,
    at a second shape (the symbolic output sizes evaluated there)."""
    op, make, dims = CASES[case]
    rng = np.random.default_rng(SEED)
    args = make(rng)

    class Call(torch.nn.Module):
        def forward(self, *tensors):
            it = iter(tensors)
            return op(*(next(it) if isinstance(a, torch.Tensor) else a for a in args))

    tensors = tuple(a for a in args if isinstance(a, torch.Tensor))
    dynamic = None
    if dims:
        dynamic = (tuple(dims.get(i) for i in range(len(tensors))),)
    ep = torch.export.export(Call(), tensors, dynamic_shapes=dynamic, strict=False)
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    fakes = [a.meta["val"] for a in out_node.args[0]]
    shapes = [args]
    if dims:
        shapes.append(make(rng, h=37, w=53) if case != "sinkhorn_core"
                      else _sinkhorn_args(rng, n=20, m=27))
    placeholders = [n.meta["val"] for n in ep.graph.nodes if n.op == "placeholder"
                    and n.name.startswith("tensors")]
    for concrete in shapes:
        real = _leaves(op(*concrete))
        bind = {}
        for fake, t in zip(placeholders, (a for a in concrete if isinstance(a, torch.Tensor))):
            for size, value in zip(fake.shape, t.shape):
                if isinstance(size, torch.SymInt):
                    bind[size.node.expr] = value
        assert len(fakes) == len(real)
        for f, r in zip(fakes, real):
            got = tuple(int(sympy.sympify(s.node.expr).xreplace(bind))
                        if isinstance(s, torch.SymInt) else s for s in f.shape)
            assert (got, f.dtype) == (tuple(r.shape), r.dtype), case


def test_detect_ops_keep_the_none_contract():
    """Without the angle the ops give (B, 1, 0, 0) moments; the wrappers
    give None, as before."""
    image = _image(np.random.default_rng(SEED))
    score, m10, m01 = detect_frontend.detect_frontend_op(image, 3, 7, 1.5, 2, False)
    assert m10.shape == m01.shape == (2, 1, 0, 0)
    out = detect_frontend.detect_frontend(image, 3, 7, 1.5, 2, with_angle=False)
    assert out[1] is None and out[2] is None and torch.equal(out[0], score)
    sel = detect_frontend.detect_select(image, 3, 7, 1.5, 2, 16, 0.0, 2, with_angle=False)
    assert sel[3] is None and sel[4] is None
    score, m10, m01 = detect_frontend.score_moments_op(image, 3, 7, 1.5, False)
    assert m10.shape == m01.shape == (2, 1, 0, 0)
    out = detect_frontend.score_moments(image, 3, 7, 1.5, with_angle=False)
    assert out[1] is None and out[2] is None and torch.equal(out[0], score)


class _Record(TorchDispatchMode):
    """Names of the operators dispatched while active."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.name())
        return func(*args, **(kwargs or {}))


def _wrapper_calls(rng):
    """(op name, public wrapper call, its plain version's call)."""
    s = _scores(rng)
    image = _image(rng)
    args = _sampler_args(rng)
    groups = tuple(tuple(args[6][i:i + 3]) for i in range(0, len(args[6]), 3))
    box = (*args[:6], groups, *args[7:])
    sk = _sinkhorn_args(rng)
    lad = (image[:, 0].contiguous(), 2, 2, 0.05, 0.001, 5, 7, 1.5)
    return [
        ("nms_block_reduce", lambda: select_frontend.nms_block_reduce(s, 2, 0.01, 3),
         lambda: select_frontend.nms_block_reduce_plain(s, 2, 0.01, 3)),
        ("nms_select_blocks", lambda: select_frontend.nms_select_blocks(s, 2, 16, 0.01, 3),
         lambda: select_frontend.nms_select_blocks_plain(s, 2, 16, 0.01, 3)),
        ("box_sample", lambda: sparse_sampler.box_sample(*box),
         lambda: sparse_sampler.box_sample_plain(*box)),
        ("sinkhorn_core", lambda: sinkhorn_kernel.sinkhorn_core(*sk),
         lambda: sinkhorn_kernel.sinkhorn_core_plain(*sk)),
        ("detect_frontend", lambda: detect_frontend.detect_frontend(image, 3, 7, 1.5, 2),
         lambda: detect_frontend.detect_frontend_plain(image, 3, 7, 1.5, 2)),
        ("detect_select", lambda: detect_frontend.detect_select(image, 3, 7, 1.5, 2, 16, 0.0, 2),
         lambda: detect_frontend.detect_select_plain(image, 3, 7, 1.5, 2, 16, 0.0, 2)),
        ("score_moments", lambda: detect_frontend.score_moments(image, 3, 7, 1.5),
         lambda: detect_frontend.score_moments_plain(image, 3, 7, 1.5)),
        ("akaze_ladder", lambda: akaze_ladder.akaze_ladder(*lad),
         lambda: akaze_ladder.akaze_ladder_plain(*lad)),
    ]


def test_eager_calls_go_through_the_ops():
    """Each public wrapper dispatches its op first (one path for eager
    calls and exported graphs) and gives its plain version's results."""
    for name, call, plain in _wrapper_calls(np.random.default_rng(SEED)):
        with _Record() as rec:
            got = call()
        assert rec.names[0] == f"oip::{name}", (name, rec.names[:3])
        assert all(torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(plain()))), name


@pytest.mark.parametrize("label,overrides,expect", [
    ("flagship", {}, {"nms_select_blocks", "box_sample", "sinkhorn_core"}),
    ("fused", {"fused_detect": True}, {"detect_select", "box_sample", "sinkhorn_core"}),
    ("AKAZE", {}, {"akaze_ladder", "nms_select_blocks", "box_sample", "sinkhorn_core"}),
])
def test_cpu_export_holds_op_nodes(label, overrides, expect):
    name = ("akaze_sparse_bad_sinkhorn" if label == "AKAZE"
            else "shi_tomasi_angle_sparse_bad_sinkhorn") + "_extraction"
    ep = models.export_model(name, 64, 80, device="cpu", max_keypoints=32, max_matches=16,
                             **overrides)
    found = {str(n.target).split(".")[1] for n in ep.graph.nodes
             if n.op == "call_function" and str(n.target).startswith("oip.")}
    assert found == expect
