"""The port's streaming split: ``match(extract(img1), extract(img2))`` equals
the two-image module bit for bit on the CPU for every ported streaming name
and its ``_extraction`` variant, and agrees with JAX's streaming split at the
flagship's tolerances (keypoints and matched coordinates equal, P and match
scores within 5e-3, filter masks equal, E within 1e-3 unit norm up to sign).
All seven of JAX's streaming names are ported, the dense matcher's too.
Scene: ``test_torch_essential.parallax_pair``; AKAZE at 32 keypoints, the
rest at 64, to keep the CPU ladder cheap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu_torch import models
from test_torch_essential import k_inv_of, parallax_pair
from test_torch_geometry import _unit_diff

P_ATOL = 5e-3
E_ATOL = 1e-3
PORTED = sorted(jax_models.streaming_names())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    img1, img2 = parallax_pair()
    return img1, img2, k_inv_of()


def _kw(name):
    return dict(max_keypoints=32 if name.startswith("akaze") else 64, max_matches=24)


def _extra(name, k_inv, lib):
    base = name.removesuffix("_extraction")
    return (lib(k_inv),) if models.get(base).takes_k_inv else ()


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_ported_streaming_names():
    assert models.streaming_names() == PORTED
    assert len(PORTED) == 7
    assert models.supports_streaming("akaze_sparse_bad_sinkhorn_essential_matrix_extraction")
    assert models.supports_streaming("shi_tomasi_bad_sinkhorn_extraction")
    assert not models.supports_streaming("shi_tomasi_bad")
    assert not models.supports_streaming("sinkhorn")


@pytest.mark.parametrize("extraction", [False, True])
@pytest.mark.parametrize("name", PORTED)
def test_streaming_equals_two_image_and_matches_jax(name, extraction, scene):
    img1, img2, k_inv = scene
    full = name + "_extraction" if extraction else name
    kw = _kw(name)
    extract, match = models.build_streaming(full, device="cpu", **kw)
    a, b = torch.from_numpy(img1), torch.from_numpy(img2)
    extra = _extra(name, k_inv, torch.from_numpy)
    ours = match(extract(a), extract(b), *extra)
    two = models.build(name, device="cpu", **kw)
    if extraction:
        two = models.with_match_extraction(two)
    _assert_same(ours, two(a, b, *extra))

    j_extract, j_match = jax_models.build_streaming(full, use_pallas=False, **kw)
    ref = [np.asarray(t) for t in j_match(j_extract(jnp.asarray(img1)),
                                          j_extract(jnp.asarray(img2)),
                                          *_extra(name, k_inv, jnp.asarray))]
    ours = [t.numpy() for t in ours]
    assert len(ours) == len(ref)
    head = 4 if extraction else 3
    for i, (got, want) in enumerate(zip(ours[:head], ref[:head])):
        if np.issubdtype(want.dtype, np.floating) and i == 2:   # P, or match scores
            np.testing.assert_allclose(got, want, atol=P_ATOL, rtol=0)
        else:                                                    # coordinates, valid
            np.testing.assert_array_equal(got, want)
    for got, want in zip(ours[head:], ref[head:]):
        if want.dtype == bool:                                   # the filter mask
            np.testing.assert_array_equal(got, want)
        else:                                                    # E
            assert _unit_diff(got, want) < E_ATOL


@pytest.mark.parametrize("name,fn", [
    ("shi_tomasi_sparse_bad_sinkhorn", models.shi_tomasi_sparse_bad_sinkhorn_match),
    ("shi_tomasi_angle_sparse_bad_sinkhorn", models.shi_tomasi_angle_sparse_bad_sinkhorn_match),
    ("shi_tomasi_angle_sparse_bad_sinkhorn_with_filters",
     models.shi_tomasi_angle_sparse_bad_sinkhorn_match_with_filters),
    ("akaze_sparse_bad_sinkhorn", models.akaze_sparse_bad_sinkhorn_match)])
def test_function_forms_equal_modules(name, fn, scene):
    """The JAX package's function forms ``fn(image1, image2, cfg, table)``."""
    img1, img2, _ = scene
    module = models.build(name, device="cpu", **_kw(name))
    a, b = torch.from_numpy(img1), torch.from_numpy(img2)
    _assert_same(fn(a, b, module.cfg, module.table), module(a, b))


def test_streaming_feature_cache_reuse(scene):
    """A cached feature set matches several new frames without being
    extracted again; each result equals the two-image module on that pair
    (the VO loop's reference aging)."""
    img1, img2, k_inv = scene
    img3 = np.roll(img2, 3, axis=3)
    name = "shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix"
    kw = dict(_kw(name), essential_ransac_hypotheses=16, essential_irls_iters=1)
    extract, match = models.build_streaming(name + "_extraction", device="cpu", **kw)
    two = models.with_match_extraction(models.build(name, device="cpu", **kw))
    k = torch.from_numpy(k_inv)
    ref_feats = extract(torch.from_numpy(img1))
    for frame in (img2, img3):
        f = torch.from_numpy(frame)
        _assert_same(match(ref_feats, extract(f), k), two(torch.from_numpy(img1), f, k))


def test_streaming_essential_rejects_batched_features(scene):
    img1, img2, k_inv = scene
    extract, match = models.build_streaming(
        "akaze_sparse_bad_sinkhorn_essential_matrix", device="cpu", max_keypoints=16)
    feats1 = extract(torch.from_numpy(np.concatenate([img1, img1])))
    feats2 = extract(torch.from_numpy(np.concatenate([img2, img2])))
    with pytest.raises(ValueError, match="batch size 1"):
        match(feats1, feats2, torch.from_numpy(k_inv))


@pytest.mark.parametrize("name,message", [
    ("shi_tomasi_bad", "no streaming split"),
    ("fast", "no streaming split"),
    ("shi_tomasi", "no streaming split"),
    ("sinkhorn", "no streaming split")])
def test_streaming_unknown_or_unported_name_raises(name, message):
    with pytest.raises(KeyError, match=message):
        models.build_streaming(name, device="cpu")


def test_streaming_modules_check_devices(scene):
    img1, _, _ = scene
    extract, match = models.build_streaming("shi_tomasi_sparse_bad_sinkhorn", device="cpu",
                                            max_keypoints=16)
    assert extract.device == match.device == torch.device("cpu")
    assert extract.matcher is match.matcher
    with pytest.raises(ValueError):
        extract(torch.from_numpy(img1).to("meta"))
