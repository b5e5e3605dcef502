"""PyTorch port vs JAX: ``geometry/essential_matrix.py``, function by
function on identical numpy inputs.

E is defined up to sign (an eigenvector's sign is the library's choice), so
every E and every eigenvector is compared after scaling to unit norm, up to
sign. Tolerances: exact for the top-k masks; 1e-6 for Hartley; 1e-5
relative for Sampson errors (contraction order). Eigenvectors and E: a
float32 eigenvector moves by ~eps * |M| / gap, so where the eigengap is
small (random P, 8-point systems, IRLS) two float32 libraries part by more
than any fixed bound. Those results are held to JAX's own float32 accuracy
(:func:`_as_accurate_as_jax`): the float64 answer is JAX's algorithm on
float64 inputs, and the port's float32 error against it must be at most
four times JAX's float32 error, or below a floor of 1e-5 (JAX's own bounds
for ``fast`` and ``exact3`` against float64 are 4e-6 and 1.4e-6); 1e-4 for
the IRLS solves, whose reweighting carries the first solve's error on.
Over 12 seeds of the IRLS scene the two float32 errors have the same size
(max 2.9e-4 port, 2.7e-4 JAX) and port and JAX part by at most 3.8e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu.geometry import essential_matrix as J
from onnx_image_processing_tpu_torch.geometry import essential_matrix as T
from test_geometry import _e_err, _two_view


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _unit_diff(a, b) -> float:
    """Max abs difference of two arrays scaled to unit norm, up to sign
    (over the last two axes, or the last one for vectors)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return float(min(np.abs(a - b).max(), np.abs(a + b).max()))


def _as_accurate_as_jax(port, jax32, jax_fn, *args64, floor=1e-5):
    """``port`` (float32) is within max(4 x JAX's float32 error, ``floor``)
    of ``jax_fn(*args64)`` run in float64, unit norm, up to sign; along a
    leading batch axis, the median errors over the batch."""
    with jax.enable_x64(True):
        truth = np.asarray(jax_fn(*(jnp.asarray(np.asarray(a, np.float64)) for a in args64)))
    assert truth.dtype == np.float64
    port, jax32 = np.asarray(port), np.asarray(jax32)
    if port.ndim == truth.ndim == 3:
        err_port = np.median([_unit_diff(p, t) for p, t in zip(port, truth)])
        err_jax = np.median([_unit_diff(j, t) for j, t in zip(jax32, truth)])
        assert err_port <= max(4 * err_jax, floor), (err_port, err_jax)
        return
    err_port, err_jax = _unit_diff(port, truth), _unit_diff(jax32, truth)
    assert err_port <= max(4 * err_jax, floor), (err_port, err_jax)


def _normal_matrix(seed, rank_deficient=False):
    """A symmetric PSD 9x9 matrix: random, or the 8-point normal matrix of
    a clean two-view set (one near-zero eigenvalue)."""
    if rank_deficient:
        x1, x2, _ = _two_view(n=64, noise=1e-4, seed=seed)
        a = np.stack([np.kron(np.r_[p, 1.0], np.r_[q, 1.0]) for p, q in zip(x1, x2)])
    else:
        a = np.random.default_rng(seed).normal(size=(40, 9))
    return (a.T @ a).astype(np.float32)


@pytest.mark.parametrize("weights", ["uniform", "random", "sparse", "zero"])
def test_hartley_normalization_matches_jax(weights):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 3, (50, 2)).astype(np.float32)
    w = {"uniform": np.ones(50), "random": rng.uniform(0, 1, 50),
         "sparse": (rng.uniform(0, 1, 50) > 0.8) * 1.0, "zero": np.zeros(50)}[weights]
    w = w.astype(np.float32)
    got = T.hartley_normalization(_t(pts), _t(w))
    want = J.hartley_normalization(_j(pts), _j(w))
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-6, atol=1e-6)


def test_sampson_errors_match_jax():
    x1, x2, e_true = _two_view(n=64, noise=5e-3, seed=3)
    e = e_true.astype(np.float32)
    got = T.sampson_error_matrix(_t(e), _t(x1), _t(x2)).numpy()
    want = np.asarray(J.sampson_error_matrix(_j(e), _j(x1), _j(x2)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    es = np.random.default_rng(4).standard_normal((7, 3, 3)).astype(np.float32)
    got = T.sampson_error_matched(_t(es), _t(x1), _t(x2)).numpy()
    want = np.asarray(J.sampson_error_matched(_j(es), _j(x1), _j(x2)))
    assert got.shape == (7, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("top_k", [1, 3, 5])
@pytest.mark.parametrize("levels", [None, 4])
def test_kth_largest_and_topk_weights_match_jax(top_k, levels):
    """Exact, including P with many ties (``levels`` distinct values)."""
    rng = np.random.default_rng(top_k)
    p = rng.uniform(0, 1, (33, 41))
    if levels:
        p = np.floor(p * levels) / levels
    p = p.astype(np.float32)
    for axis in (0, 1):
        np.testing.assert_array_equal(T._kth_largest(_t(p), top_k, axis).numpy(),
                                      np.asarray(J._kth_largest(_j(p), top_k, axis)))
    got = T.bidirectional_topk_weights(_t(p), top_k).numpy()
    np.testing.assert_array_equal(got, np.asarray(J.bidirectional_topk_weights(_j(p), top_k)))
    assert (got > 0).any()


def test_topk_weights_reject_short_axis():
    with pytest.raises(ValueError):
        T.bidirectional_topk_weights(torch.ones((2, 9)), 3)


@pytest.mark.parametrize("method", ["eigh", "fast", "power"])
@pytest.mark.parametrize("rank_deficient", [False, True])
def test_min_eigvec9_matches_jax(method, rank_deficient):
    m = _normal_matrix(seed=5, rank_deficient=rank_deficient)
    got = T.min_eigvec9(_t(m), method=method).numpy()
    want = np.asarray(J.min_eigvec9(_j(m), method=method))
    assert got.shape == (9,)
    _as_accurate_as_jax(got, want, lambda a: J.min_eigvec9(a, method=method), m)


def test_min_eigvec9_batched_equals_single():
    ms = np.stack([_normal_matrix(s) for s in range(4)])
    for method in ("eigh", "fast", "power"):
        batched = T.min_eigvec9(_t(ms), method=method).numpy()
        for i in range(4):
            assert _unit_diff(batched[i], T.min_eigvec9(_t(ms[i]), method=method).numpy()) < 1e-6
    with pytest.raises(ValueError):
        T.min_eigvec9(_t(ms[0]), method="qr")


@pytest.mark.parametrize("method", ["svd", "exact3", "power"])
@pytest.mark.parametrize("kind", ["random", "near_essential"])
def test_projection_matches_jax(method, kind):
    rng = np.random.default_rng(8)
    if kind == "random":
        e = rng.normal(size=(3, 3))
    else:
        e = _two_view(seed=2)[2] + 1e-3 * rng.normal(size=(3, 3))
    e = e.astype(np.float32)
    got = T.project_onto_essential_manifold(_t(e), method=method).numpy()
    want = np.asarray(J.project_onto_essential_manifold(_j(e), method=method))
    _as_accurate_as_jax(got, want, lambda a: J.project_onto_essential_manifold(
        a, method=method), e)
    np.testing.assert_allclose(np.linalg.norm(got), np.linalg.norm(want), rtol=1e-5)
    s = np.linalg.svd(got.astype(np.float64), compute_uv=False)
    assert s[2] < 1e-5 * s[0]


def test_projection_rejects_unknown_method():
    with pytest.raises(ValueError):
        T.project_onto_essential_manifold(torch.eye(3), method="qr")


@pytest.mark.parametrize("method", ["eigh", "fast"])
@pytest.mark.parametrize("project", [True, False])
def test_essential_from_matched_points_matches_jax(method, project):
    x1, x2, e_true = _two_view(n=96, noise=1e-4, seed=6)
    w = np.random.default_rng(6).uniform(0.2, 1.0, 96).astype(np.float32)
    got = T.essential_from_matched_points(_t(w), _t(x1), _t(x2), method, project).numpy()
    want = np.asarray(J.essential_from_matched_points(_j(w), _j(x1), _j(x2), method, project))
    _as_accurate_as_jax(got, want, lambda *a: J.essential_from_matched_points(
        *a, method, project), w, x1, x2)
    if project:
        assert _e_err(got, e_true) < 5e-3


def test_essential_from_matched_points_batched_matches_jax_vmap():
    """The RANSAC hypothesis solve: (S, 8) minimal sets of distinct points,
    fast, unprojected; the port's leading batch axis against JAX's vmap.

    A minimal set's shifted matrix has a condition number ~1e6 (the shift
    is 1e-6 of its trace), so each float32 Cholesky moves the result by
    1e-3..1e-2 in either library; the batch is held to JAX's median error,
    and to the port's own single solves."""
    x1, x2, _ = _two_view(n=128, noise=1e-4, seed=9)
    rng = np.random.default_rng(9)
    idx = np.stack([rng.permutation(128)[:8] for _ in range(16)])
    w8 = np.ones((16, 8), np.float32)
    w8[3, 5:] = 0.0  # invalid picks: a 4-dim null space, any E in it solves
    got = T.essential_from_matched_points(_t(w8), _t(x1[idx]), _t(x2[idx]), "fast",
                                          False).numpy()
    assert got.shape == (16, 3, 3) and np.isfinite(got).all()
    for i in (0, 3, 15):
        one = T.essential_from_matched_points(_t(w8[i]), _t(x1[idx[i]]), _t(x2[idx[i]]),
                                              "fast", False).numpy()
        assert _unit_diff(got[i], one) < 1e-6
    solve = jax.vmap(lambda w, a, b: J.essential_from_matched_points(
        w, a, b, method="fast", project=False))
    want = np.asarray(solve(_j(w8), _j(x1[idx]), _j(x2[idx])))
    full = np.arange(16) != 3
    _as_accurate_as_jax(got[full], want[full], solve, w8[full], x1[idx][full], x2[idx][full])


@pytest.mark.parametrize("method", ["eigh", "fast"])
@pytest.mark.parametrize("irls_iters,tau", [(0, None), (2, None), (3, (2.0 / 300.0) ** 2)])
def test_weighted_points_solve_and_irls_match_jax(method, irls_iters, tau):
    """The (N, M) soft-weight solve and its Cauchy IRLS, on a P-like weight
    matrix: the true pairs weighted, plus 10% weakly weighted wrong pairs."""
    rng = np.random.default_rng(12)
    x1, x2, e_true = _two_view(n=80, noise=1e-4, seed=12)
    w = np.zeros((80, 80), np.float32)
    w[np.arange(80), np.arange(80)] = rng.uniform(0.5, 1.0, 80)
    wrong = rng.choice(80, 8, replace=False)
    w[wrong, rng.permutation(wrong)] = rng.uniform(0.05, 0.2, 8)
    got = T.essential_from_weighted_points(_t(w), _t(x1), _t(x2), method=method,
                                           irls_iters=irls_iters, irls_tau=tau).numpy()
    solve = lambda *a: J.essential_from_weighted_points(  # noqa: E731
        *a, method=method, irls_iters=irls_iters, irls_tau=tau)
    want = np.asarray(solve(_j(w), _j(x1), _j(x2)))
    _as_accurate_as_jax(got, want, solve, w, x1, x2, floor=1e-4)
    assert _unit_diff(got, want) < 1e-4


def test_weighted_points_power_mode_matches_jax_and_refuses_irls():
    x1, x2, _ = _two_view(n=64, noise=1e-3, seed=13)
    w = np.eye(64, dtype=np.float32)
    got = T.essential_from_weighted_points(_t(w), _t(x1), _t(x2), method="power").numpy()
    solve = lambda *a: J.essential_from_weighted_points(*a, method="power")  # noqa: E731
    _as_accurate_as_jax(got, np.asarray(solve(_j(w), _j(x1), _j(x2))), solve, w, x1, x2)
    with pytest.raises(ValueError):
        T.essential_from_weighted_points(_t(w), _t(x1), _t(x2), method="power", irls_iters=1)


@pytest.mark.parametrize("method", ["eigh", "fast", "power"])
def test_zero_weights_are_finite(method):
    """No matches anywhere: every solve stays finite, as in JAX."""
    rng = np.random.default_rng(11)
    p0 = _t(rng.uniform(-1, 1, (64, 2)).astype(np.float32))
    w0 = torch.zeros((64, 64))
    assert torch.isfinite(T.essential_from_weighted_points(w0, p0, p0, method=method)).all()
    if method != "power":
        assert torch.isfinite(T.essential_from_matched_points(
            torch.zeros(64), p0, p0, method=method)).all()
        e = T.essential_ransac_from_candidates(torch.zeros(64), p0, p0, 1e-4,
                                               hypotheses=16, polish_iters=2)
        assert torch.isfinite(e).all()


@pytest.mark.parametrize("method", ["eigh", "fast", "power"])
def test_grid_estimator_on_random_p_matches_jax(method):
    """The standalone estimator on a random (1025, 1025) P, as the
    reference's own self-test (grid 32 x 32)."""
    p = np.random.default_rng(42).uniform(0, 1, (1025, 1025)).astype(np.float32)
    k_inv = np.linalg.inv(np.array([[16.0, 0, 16], [0, 16.0, 16], [0, 0, 1]])).astype(np.float32)
    got = T.estimate_essential_matrix(_t(p), _t(k_inv), image_shape=(32, 32),
                                      method=method).numpy()
    want = np.asarray(J.estimate_essential_matrix(_j(p), _j(k_inv), image_shape=(32, 32),
                                                  method=method))
    # The float64 answer: the same top-k weights (an exact mask of the f32
    # P) and grid coordinates, solved in float64.
    w = np.asarray(J.bidirectional_topk_weights(_j(p[:1024, :1024]), 3))
    idx = np.arange(1024)
    coords = (np.stack([idx % 32, idx // 32, np.ones(1024)], -1) @ k_inv.T.astype(np.float64))[:, :2]
    _as_accurate_as_jax(got, want, lambda *a: J.essential_from_weighted_points(
        *a, method=method), w, coords, coords)
    with pytest.raises(ValueError):
        T.estimate_essential_matrix(_t(p), _t(k_inv), image_shape=(16, 16))
