"""PyTorch port vs JAX: the Sinkhorn remainder -- the L1 cost (direct and
streamed in column chunks), ``sinkhorn_match_with_scores``, the ratio and
dustbin masks and ``sinkhorn_match_with_filters``.

Bands: the L1 cost is a sum of 64 absolute differences of O(1) values, whose
order differs between the libraries: rtol 1e-6. P and the scores take the
Sinkhorn band of ``test_torch_sinkhorn.py`` (atol 1e-6 + rtol 1e-5). Masks
are exact, except on rows whose test statistic lies within 1e-4 (relative)
of its threshold, where a P difference inside the band may flip them: those
rows are counted and must be rare.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu.ops import sinkhorn as J
from onnx_image_processing_tpu_torch.ops import sinkhorn as T

BAND = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _descriptors(b, n, m, seed, d=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (b, n, d)).astype(np.float32),
            rng.normal(0, 0.5, (b, m, d)).astype(np.float32))


@pytest.mark.parametrize("budget", [None, 4096, 64 * 40])
def test_l1_cost_direct_and_chunked_match_jax(budget, monkeypatch):
    """``budget`` None keeps the direct form; the others force the streamed
    form (B*N*D = 2*48*64 = 6144 elements per column), one with a ragged
    last chunk."""
    d1, d2 = _descriptors(2, 48, 37, seed=5)
    want = np.asarray(J._l1_cost(jnp.asarray(d1), jnp.asarray(d2)))
    if budget is not None:
        monkeypatch.setattr(T, "_L1_DIRECT_ELEMS", budget)
    got = T._l1_cost(torch.from_numpy(d1), torch.from_numpy(d2)).numpy()
    assert got.shape == (2, 48, 37)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    direct = np.abs(d1[:, :, None, :] - d2[:, None, :, :]).sum(-1)
    np.testing.assert_allclose(got, direct, rtol=1e-6)


@pytest.mark.parametrize("distance_type", ["l1", "L2"])
def test_sinkhorn_match_distance_types_match_jax(distance_type):
    d1, d2 = _descriptors(2, 64, 80, seed=11)
    eps = 2.0 if distance_type == "l1" else 0.05
    got = T.sinkhorn_match(torch.from_numpy(d1), torch.from_numpy(d2), epsilon=eps,
                           distance_type=distance_type).numpy()
    want = np.asarray(J.sinkhorn_match(jnp.asarray(d1), jnp.asarray(d2), epsilon=eps,
                                       distance_type=distance_type, use_pallas=False))
    np.testing.assert_allclose(got, want, **BAND)


def test_unknown_distance_type_raises():
    d = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError):
        T.sinkhorn_match(d, d, distance_type="cosine")


def test_sinkhorn_match_with_scores_matches_jax():
    d1, d2 = _descriptors(2, 64, 96, seed=3)
    p, s0, s1 = T.sinkhorn_match_with_scores(torch.from_numpy(d1), torch.from_numpy(d2),
                                             epsilon=0.05)
    pj, s0j, s1j = J.sinkhorn_match_with_scores(jnp.asarray(d1), jnp.asarray(d2),
                                                epsilon=0.05, use_pallas=False)
    assert s0.shape == (2, 64) and s1.shape == (2, 96)
    for got, want in ((p, pj), (s0, s0j), (s1, s1j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    np.testing.assert_array_equal(s0.numpy(), p[:, :64, :96].amax(-1).numpy())


def _tied_rows(seed):
    """(2, 24, 10) probabilities drawn from 4 levels, so most rows have tied
    top values, plus rows with a single best, and a 1-column matrix."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 4, (2, 24, 10)).astype(np.float32) / 8.0
    p[:, 0] = 0.0                  # all tied at zero
    p[:, 1] = 0.25                 # all tied
    p[:, 2, 3] = 0.9               # one clear best
    return p


@pytest.mark.parametrize("threshold", [1.0, 1.5, 2.0, 4.0])
def test_probability_ratio_mask_with_ties_matches_jax(threshold):
    p = _tied_rows(seed=int(threshold * 10))
    got = T.probability_ratio_mask(torch.from_numpy(p), threshold).numpy()
    want = np.asarray(J.probability_ratio_mask(jnp.asarray(p), threshold))
    np.testing.assert_array_equal(got, want)
    one = p[..., :1]
    np.testing.assert_array_equal(
        T.probability_ratio_mask(torch.from_numpy(one), threshold).numpy(),
        np.asarray(J.probability_ratio_mask(jnp.asarray(one), threshold)))


@pytest.mark.parametrize("margin", [0.0, 0.1, 0.3])
def test_dustbin_margin_mask_matches_jax(margin):
    rng = np.random.default_rng(7)
    p = rng.uniform(0, 1, (2, 25, 17)).astype(np.float32)
    p[:, 3, -1] = p[:, 3, :-1].max(-1)  # best == dustbin: margin 0 passes
    got = T.dustbin_margin_mask(torch.from_numpy(p), margin).numpy()
    want = np.asarray(J.dustbin_margin_mask(jnp.asarray(p), margin))
    np.testing.assert_array_equal(got, want)


def _near(p, ratio, margin):
    """Rows whose ratio or margin statistic lies within 1e-4 of its threshold."""
    n, m = p.shape[1] - 1, p.shape[2] - 1
    core = p[:, :n, :m]
    top2 = -np.sort(-core, axis=-1)[..., :2]
    near = np.zeros(core.shape[:2], bool)
    if ratio is not None and ratio > 0:
        r = top2[..., 0] / (top2[..., 1] + 1e-8)
        near |= np.abs(r - ratio) <= 1e-4 * ratio
    if margin is not None and margin >= 0:
        d = core.max(-1) - p[:, :n, m]
        near |= np.abs(d - margin) <= 1e-4
    return near


@pytest.mark.parametrize("ratio,margin", [(None, None), (2.0, None), (None, 0.3),
                                          (2.0, 0.3), (0.0, -0.5), (1.2, 0.0)])
def test_sinkhorn_match_with_filters_matches_jax(ratio, margin):
    d1, d2 = _descriptors(2, 64, 72, seed=19)
    pf, valid = T.sinkhorn_match_with_filters(
        torch.from_numpy(d1), torch.from_numpy(d2), epsilon=0.05,
        ratio_threshold=ratio, dustbin_margin=margin)
    pfj, vj = J.sinkhorn_match_with_filters(
        jnp.asarray(d1), jnp.asarray(d2), epsilon=0.05, ratio_threshold=ratio,
        dustbin_margin=margin, use_pallas=False)
    pf, valid, pfj, vj = pf.numpy(), valid.numpy(), np.asarray(pfj), np.asarray(vj)
    assert valid.shape == (2, 64) and valid.dtype == bool
    if ratio is None or ratio <= 0:
        if margin is None or margin < 0:
            assert valid.all()
    plain = T.sinkhorn_match(torch.from_numpy(d1), torch.from_numpy(d2),
                             epsilon=0.05).numpy()
    near = _near(plain, ratio, margin)
    assert near.sum() <= 2, f"{near.sum()} rows on a threshold"
    np.testing.assert_array_equal(valid[~near], vj[~near])
    rows = np.concatenate([~near, np.ones((2, 1), bool)], axis=1)
    np.testing.assert_allclose(pf[rows], pfj[rows], **BAND)
    # Filtered rows: core zeroed, dustbin 1.0; kept rows untouched.
    n = 64
    assert (pf[:, :n, :-1][~valid] == 0).all()
    assert (pf[:, :n, -1][~valid] == 1.0).all()
    np.testing.assert_array_equal(pf[:, :n][valid], plain[:, :n][valid])
    np.testing.assert_array_equal(pf[:, n], plain[:, n])
