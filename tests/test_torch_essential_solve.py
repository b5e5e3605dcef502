"""The essential solve's kernel wrappers on the CPU
(``kernels/essential_solve.py``): ``min_eigvec9``, ``project_essential`` and
``essential_hypotheses``.

On a CPU tensor each wrapper runs its plain version, the code the geometry
ran before the kernels existed, so it equals that code bit for bit (the
references below are that code, written out). Against JAX on the same
numpy inputs each is held as ``test_torch_geometry.py`` holds the
geometry: within max(4 x JAX's float32 error, 1e-5) of JAX's algorithm in
float64. The three ``oip`` ops pass ``torch.library.opcheck``, their fake
implementations give the CPU outputs' shapes under ``torch.export`` with a
symbolic batch, and the exported essential pipelines keep one node per op.
"""

import jax
import numpy as np
import pytest
import sympy
import torch
from torch.export import Dim

from onnx_image_processing_tpu.geometry import essential_matrix as J
from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.geometry import essential_matrix as T
from onnx_image_processing_tpu_torch.kernels import essential_solve as K
from test_geometry import _two_view
from test_torch_geometry import _as_accurate_as_jax, _normal_matrix

FLAGSHIP = "shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix"


def _eigh_before(m):
    """``min_eigvec9(method="eigh")`` as it was."""
    return torch.linalg.eigh(m.double())[1][..., :, 0].to(m.dtype)


def _svd_before(e):
    """``project_onto_essential_manifold(method="svd")`` as it was."""
    u, s, vt = torch.linalg.svd(e)
    v = vt.transpose(-1, -2)
    u = T._with_sign((u[..., :, 0], u[..., :, 1], u[..., :, 2]), torch.sign(T._det3(u)))
    v = T._with_sign((v[..., :, 0], v[..., :, 1], v[..., :, 2]), torch.sign(T._det3(v)))
    return T._compose(u, (s[..., 0] + s[..., 1]) / 2.0, v)


def _matrices(kind):
    if kind == "batched":
        return np.stack([_normal_matrix(s) for s in range(5)])
    if kind == "single":
        return _normal_matrix(7)
    if kind == "rank_deficient":
        x1, _, _ = _two_view(n=64, noise=0.0, seed=4)
        a = np.stack([np.kron(np.r_[p, 1.0], np.r_[p + 0.1, 1.0]) for p in x1])
        return (a.T @ a).astype(np.float32)   # a pure shift: a 3-dim null space
    return np.zeros((2, 9, 9), np.float32)


def _essentials(kind):
    rng = np.random.default_rng(12)
    if kind == "batched":
        return rng.normal(size=(6, 3, 3)).astype(np.float32)
    if kind == "single":
        return (_two_view(seed=2)[2] + 1e-3 * rng.normal(size=(3, 3))).astype(np.float32)
    if kind == "rank_deficient":
        return np.outer([1.0, 2.0, -1.0], [0.5, 0.0, 1.0]).astype(np.float32)[None]
    return np.zeros((3, 3), np.float32)


def _samples(kind, s=24, seed=5):
    """(S, 8) weights and (S, 8, 2) points of each side."""
    x1, x2, _ = _two_view(n=64, noise=1e-4, seed=seed)
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(64)[:8] for _ in range(s)])
    w = np.ones((s, 8), np.float32)
    if kind == "zero":
        w[:] = 0.0
    elif kind == "rank_deficient":
        w[::3, 6:] = 0.0
    if kind == "single":
        idx, w = idx[:1], w[:1]
    return (torch.from_numpy(w), torch.from_numpy(x1[idx].astype(np.float32)),
            torch.from_numpy(x2[idx].astype(np.float32)))


KINDS = ["batched", "single", "rank_deficient", "zero"]


@pytest.mark.parametrize("kind", KINDS)
def test_min_eigvec9_on_the_cpu_is_the_code_before(kind):
    m = torch.from_numpy(_matrices(kind))
    want = _eigh_before(m)
    for got in (K.min_eigvec9(m), T.min_eigvec9(m, method="eigh")):
        assert got.shape == m.shape[:-1] and torch.equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_project_essential_on_the_cpu_is_the_code_before(kind):
    e = torch.from_numpy(_essentials(kind))
    want = _svd_before(e)
    for got in (K.project_essential(e), T.project_onto_essential_manifold(e, method="svd")):
        assert got.shape == e.shape and torch.equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_essential_hypotheses_on_the_cpu_is_the_code_before(kind):
    w, p1, p2 = _samples(kind)
    want = T.essential_from_matched_points(w, p1, p2, method="fast", project=False)
    got = K.essential_hypotheses(w, p1, p2)
    assert got.shape == (w.shape[0], 3, 3) and torch.equal(got, want)
    assert torch.isfinite(got).all()


def test_ransac_solves_its_hypotheses_through_the_wrapper(monkeypatch):
    """The RANSAC's hypothesis stage is one wrapper call on (S, 8) samples."""
    calls = []
    real = K.essential_hypotheses

    def spy(w, p1, p2):
        calls.append((tuple(w.shape), tuple(p1.shape), tuple(p2.shape)))
        return real(w, p1, p2)

    monkeypatch.setattr(K, "essential_hypotheses", spy)
    x1, x2, _ = _two_view(n=64, noise=1e-4, seed=8)
    e = T.essential_ransac_from_candidates(torch.ones(64), torch.from_numpy(x1),
                                           torch.from_numpy(x2), 1e-6, hypotheses=32)
    assert calls == [((32, 8), (32, 8, 2), (32, 8, 2))]
    assert torch.isfinite(e).all()


@pytest.mark.parametrize("rank_deficient", [False, True])
def test_min_eigvec9_wrapper_matches_jax(rank_deficient):
    m = _normal_matrix(seed=3, rank_deficient=rank_deficient)
    got = K.min_eigvec9(torch.from_numpy(m)).numpy()
    want = np.asarray(J.min_eigvec9(m, method="eigh"))
    _as_accurate_as_jax(got, want, lambda a: J.min_eigvec9(a, method="eigh"), m)


@pytest.mark.parametrize("kind", ["random", "near_essential"])
def test_project_essential_wrapper_matches_jax(kind):
    e = _essentials("batched")[0] if kind == "random" else _essentials("single")
    got = K.project_essential(torch.from_numpy(e)).numpy()
    want = np.asarray(J.project_onto_essential_manifold(e, method="svd"))
    _as_accurate_as_jax(got, want, lambda a: J.project_onto_essential_manifold(
        a, method="svd"), e)


def test_essential_hypotheses_wrapper_matches_jax_vmap():
    w, p1, p2 = (t.numpy() for t in _samples("batched", s=16, seed=9))
    got = K.essential_hypotheses(*map(torch.from_numpy, (w, p1, p2))).numpy()
    solve = jax.vmap(lambda a, b, c: J.essential_from_matched_points(
        a, b, c, method="fast", project=False))
    _as_accurate_as_jax(got, np.asarray(solve(w, p1, p2)), solve, w, p1, p2)


def _op_args(case):
    if case == "min_eigvec9":
        return (torch.from_numpy(_matrices("batched")),)
    if case == "project_essential":
        return (torch.from_numpy(_essentials("batched")),)
    return _samples("batched", s=6)


CASES = ["min_eigvec9", "project_essential", "essential_hypotheses"]


@pytest.mark.parametrize("case", CASES)
def test_opcheck(case):
    torch.library.opcheck(getattr(K, case + "_op"), _op_args(case))


@pytest.mark.parametrize("case", CASES)
def test_fake_shapes_under_export(case):
    """Exported with a symbolic batch, the op's fake output shape, evaluated
    at the traced batch and at another, equals the CPU output's."""
    op = getattr(K, case + "_op")

    class Call(torch.nn.Module):
        def forward(self, *tensors):
            return op(*tensors)

    args = _op_args(case)
    batch = Dim("batch", min=2)
    ep = torch.export.export(Call(), args, strict=False,
                             dynamic_shapes=(tuple({0: batch} for _ in args),))
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"]
    assert [str(n.target) for n in nodes] == [f"oip.{case}.default"]
    fake = next(n for n in ep.graph.nodes if n.op == "output").args[0][0].meta["val"]
    for b in (args[0].shape[0], 3):
        concrete = tuple(a[:b] if b <= a.shape[0] else torch.cat([a, a])[:b] for a in args)
        real = op(*concrete)
        size = {s.node.expr: b for s in fake.shape if isinstance(s, torch.SymInt)}
        got = tuple(int(sympy.sympify(s.node.expr).xreplace(size))
                    if isinstance(s, torch.SymInt) else s for s in fake.shape)
        assert (got, fake.dtype) == (tuple(real.shape), real.dtype)


@pytest.mark.parametrize("name,overrides,expect", [
    (FLAGSHIP, {}, {"min_eigvec9", "project_essential"}),
    (FLAGSHIP, dict(essential_ransac_hypotheses=16, essential_irls_iters=1),
     {"min_eigvec9", "project_essential", "essential_hypotheses"}),
    ("essential_matrix_estimator", dict(max_keypoints=64), {"min_eigvec9", "project_essential"}),
])
def test_cpu_export_holds_the_solve_ops(name, overrides, expect):
    kw = {} if name == "essential_matrix_estimator" else dict(max_keypoints=32)
    ep = models.export_model(name, 64, 80, device="cpu", **kw, **overrides)
    found = {str(n.target).split(".")[1] for n in ep.graph.nodes
             if n.op == "call_function" and str(n.target).startswith("oip.")}
    assert expect <= found
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert not any("eigh" in t or "svd" in t for t in targets)
