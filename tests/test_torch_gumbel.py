"""The RANSAC Gumbel table made in numpy (``geometry/_gumbel.py``) vs
``jax.random``, and the port's in-graph RANSAC vs JAX's.

Bits: exact. Floats: the table is ``-log(-log(u))``; the port takes each log
correctly rounded, XLA's float32 log may be an ulp off, and near G = 0 one
ulp of the inner log (~1.2e-7) is many ulps of G. So the bound is 2 ulps at
the scale max(|G|, 1): one for each log. The (S, 8) hypothesis indices of
``top_k(log w + G, 8)`` must be equal. RANSAC's E: within 1e-4 of JAX's
(unit norm, up to sign) and of the truth within JAX's own bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu.geometry import essential_matrix as J
from onnx_image_processing_tpu_torch.geometry import _gumbel
from onnx_image_processing_tpu_torch.geometry import essential_matrix as T
from onnx_image_processing_tpu_torch.ops.keypoints import _top_k
from test_geometry import _e_err, _two_view
from test_torch_geometry import _unit_diff


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("seed,shape", [(0, (32, 64)), (0, (128, 512)), (0, (256, 1024)),
                                        (7, (3, 5))])
def test_table_matches_jax_random(seed, shape):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_gumbel.random_bits(seed, shape),
                                  np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    got = _gumbel.gumbel_table(seed, *shape)
    want = np.asarray(jax.random.gumbel(key, shape, jnp.float32))
    assert got.dtype == np.float32 and got.shape == shape
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 2 * ulp).all()
    assert np.mean(got == want) > 0.5


def test_seed_must_be_32_bit():
    with pytest.raises(ValueError):
        _gumbel.random_bits(-1, (2, 2))


@pytest.mark.parametrize("hypotheses,n,valid_frac", [(32, 64, 0.7), (128, 512, 0.3),
                                                     (256, 1024, 0.5), (16, 64, 5 / 64)])
def test_hypothesis_indices_match_jax(hypotheses, n, valid_frac):
    """``top_k(log w + G, 8)`` over the table: the same (S, 8) minimal sets
    as JAX, lowest index first among the -inf of invalid rows (the last
    case has 5 valid candidates)."""
    rng = np.random.default_rng(n)
    w = rng.uniform(0.01, 1.0, n).astype(np.float32)
    w[rng.permutation(n)[:n - max(5, int(valid_frac * n))]] = 0.0
    logw = np.where(w > 0, np.log(np.maximum(w, 1e-30)), -np.inf).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(logw)[None, :]
                            + jax.random.gumbel(jax.random.PRNGKey(0), (hypotheses, n),
                                                jnp.float32), 8)
    _, got = _top_k(torch.from_numpy(logw)[None, :]
                    + torch.from_numpy(_gumbel.gumbel_table(0, hypotheses, n)), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ransac_inputs(outlier_frac):
    x1, x2, e_true = _two_view(outlier_frac=outlier_frac)
    tau = (2.0 / 300.0) ** 2
    s_true = np.asarray(J.sampson_error_matched(jnp.asarray(e_true.astype(np.float32)),
                                                jnp.asarray(x1), jnp.asarray(x2)))
    rng = np.random.default_rng(1)
    w = np.where(s_true < tau, rng.uniform(0.5, 1.0, len(x1)),
                 rng.uniform(0.1, 0.6, len(x1))).astype(np.float32)
    return w, x1, x2, tau, e_true


@pytest.mark.parametrize("outlier_frac", [0.3, 0.4])
def test_ransac_from_candidates_matches_jax(outlier_frac):
    """Two-view set with permuted outliers (as ``test_geometry.py``)."""
    w, x1, x2, tau, e_true = _ransac_inputs(outlier_frac)
    got = T.essential_ransac_from_candidates(torch.from_numpy(w), torch.from_numpy(x1),
                                             torch.from_numpy(x2), tau, hypotheses=128,
                                             polish_iters=2).numpy()
    want = np.asarray(J.essential_ransac_from_candidates(
        jnp.asarray(w), jnp.asarray(x1), jnp.asarray(x2), tau, hypotheses=128,
        polish_iters=2))
    assert _unit_diff(got, want) < 1e-4
    assert _e_err(got, e_true) < 0.1


def _contaminated_p(n=128, seed=6, dead_rows=0, dead_cols=0):
    """P of a two-view set with 30% wrong assignments (as
    ``test_geometry.py``), optionally with all-zero rows / columns for
    invalid keypoints; returns the keypoint-level inputs."""
    rng = np.random.default_rng(seed)
    x1, x2, e_true = _two_view(n=n, noise=5e-4)
    perm = np.arange(n)
    idx = rng.choice(n, int(0.3 * n), replace=False)
    perm[idx] = idx[rng.permutation(len(idx))]
    p = np.zeros((n + 1, n + 1), np.float32)
    p[np.arange(n), perm] = rng.uniform(0.5, 1.0, n).astype(np.float32)
    valid1, valid2 = np.ones(n, bool), np.ones(n, bool)
    valid1[:dead_rows] = False
    valid2[n - dead_cols:] = False
    kpts1 = np.stack([x1[:, 1], x1[:, 0]], -1).astype(np.float32)
    kpts2 = np.stack([x2[:, 1], x2[:, 0]], -1).astype(np.float32)
    return (p, kpts1, kpts2, valid1, valid2, np.eye(3, dtype=np.float32)), e_true


@pytest.mark.parametrize("dead_rows,dead_cols", [(0, 0), (20, 0), (0, 25), (128, 0)])
def test_keypoint_ransac_mode_matches_jax(dead_rows, dead_cols):
    """The keypoint-level RANSAC: mutual argmax candidates (first index on
    ties) over P with invalid keypoints zeroed -- none, some rows, some
    columns, all rows (every row all-zero: no candidate; E stays finite)."""
    args, e_true = _contaminated_p(dead_rows=dead_rows, dead_cols=dead_cols)
    kw = dict(ransac_hypotheses=128, irls_iters=2, ransac_px=3e-3)
    got = T.estimate_essential_from_keypoints(*(torch.from_numpy(a) for a in args), **kw).numpy()
    want = np.asarray(J.estimate_essential_from_keypoints(*(jnp.asarray(a) for a in args), **kw))
    assert np.isfinite(got).all()
    if dead_rows == 128:
        return
    assert _unit_diff(got, want) < 1e-4
    assert _e_err(got, e_true) < 0.05


def test_ransac_candidates_take_first_index_on_ties():
    """Rows of P with two equal maxima: the candidate is the lower column,
    as ``jnp.argmax``, so the weights and the E agree with JAX."""
    args, _ = _contaminated_p(n=64, seed=3)
    p = args[0]
    p[5, 10] = p[5].max()  # a tie with the row's own best
    p[9, :] = 0.25         # a whole row tied
    kw = dict(ransac_hypotheses=64, irls_iters=1, ransac_px=3e-3)
    got = T.estimate_essential_from_keypoints(*(torch.from_numpy(a) for a in args), **kw).numpy()
    want = np.asarray(J.estimate_essential_from_keypoints(*(jnp.asarray(a) for a in args), **kw))
    assert _unit_diff(got, want) < 1e-4
