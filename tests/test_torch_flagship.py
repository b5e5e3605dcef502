"""PyTorch port vs JAX: the flagship matcher slice end to end on the CPU.

``shi_tomasi_angle_sparse_bad_sinkhorn`` and its ``_extraction`` wrapper on
``gray_image_pair`` (120x160, K=128, registry defaults otherwise). Keypoints
must be equal; should a ulp-level score difference ever swap a rank-boundary
keypoint, the compare falls back to the permutation-aware rule of
``tools/soak.py`` ``_p_common_diff`` (at most 2 swaps per image, P compared
on the common keypoints). P agrees within 5e-3 there.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu.ops import extract_mutual_matches as j_extract
from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.kernels import launch_counts, reset_launch_counts

NAME = "shi_tomasi_angle_sparse_bad_sinkhorn"
K = 128
MAX_MATCHES = 64
P_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_out(gray_image_pair):
    img1, img2 = gray_image_pair
    fn = jax_models.build(NAME, max_keypoints=K)
    return tuple(np.asarray(o) for o in fn(jnp.asarray(img1), jnp.asarray(img2)))


@pytest.fixture(scope="module")
def port_out(gray_image_pair):
    img1, img2 = gray_image_pair
    fn = models.build(NAME, max_keypoints=K, device="cpu")
    return tuple(o.numpy() for o in fn(torch.from_numpy(img1), torch.from_numpy(img2)))


def _common_index(a, b):
    inv_a = {tuple(v): i for i, v in enumerate(a.tolist())}
    inv_b = {tuple(v): i for i, v in enumerate(b.tolist())}
    shared = sorted(set(inv_a) & set(inv_b))
    swaps = len(set(inv_a) ^ set(inv_b))
    return (np.array([inv_a[v] for v in shared] + [len(a)]),
            np.array([inv_b[v] for v in shared] + [len(b)]), swaps)


def test_flagship_keypoints_and_p_match_jax(jax_out, port_out):
    _assert_matches_jax(port_out, jax_out)


def _assert_matches_jax(port_out, jax_out):
    k1j, k2j, pj = jax_out
    k1t, k2t, pt = port_out
    assert pt.shape == pj.shape == (1, K + 1, K + 1)
    assert (k1t[0, :, 0] >= 0).sum() > K // 4
    if np.array_equal(k1t, k1j) and np.array_equal(k2t, k2j):
        np.testing.assert_allclose(pt, pj, atol=P_ATOL, rtol=0)
        return
    ia1, ib1, s1 = _common_index(k1t[0], k1j[0])
    ia2, ib2, s2 = _common_index(k2t[0], k2j[0])
    assert max(s1, s2) <= 2, f"keypoint sets differ by {s1}, {s2}"
    np.testing.assert_allclose(pt[0][np.ix_(ia1, ia2)], pj[0][np.ix_(ib1, ib2)],
                               atol=P_ATOL, rtol=0)


def test_flagship_extraction_matches_jax(gray_image_pair, jax_out):
    img1, img2 = gray_image_pair
    k1j, k2j, pj = jax_out
    mk1_j, mk2_j, s_j, v_j = (np.asarray(o) for o in j_extract(
        jnp.asarray(pj), jnp.asarray(k1j), jnp.asarray(k2j),
        max_matches=MAX_MATCHES, threshold=0.1))
    fn = models.build(NAME + "_extraction", max_keypoints=K,
                      max_matches=MAX_MATCHES, device="cpu")
    mk1, mk2, s, v = (o.numpy() for o in fn(torch.from_numpy(img1),
                                             torch.from_numpy(img2)))
    assert v.sum() > MAX_MATCHES // 2
    np.testing.assert_array_equal(v, v_j)
    np.testing.assert_array_equal(mk1, mk1_j)
    np.testing.assert_array_equal(mk2, mk2_j)
    np.testing.assert_allclose(s, s_j, atol=P_ATOL, rtol=0)
    # gray_image_pair's second image is the first rolled by (5, 8) px.
    d = (mk2 - mk1)[v]
    assert abs(np.median(d[:, 0]) - 5) <= 0.5 and abs(np.median(d[:, 1]) - 8) <= 0.5


@pytest.mark.parametrize("name", [NAME, NAME + "_extraction"])
def test_registry_defaults_match_jax(name):
    assert dataclasses.asdict(models.get(name).defaults) == \
        dataclasses.asdict(jax_models.get(name).defaults)
    assert models.get(name).defaults.block_size == 5


def test_port_imports_no_jax():
    code = ("import sys; import onnx_image_processing_tpu_torch as p; "
            "import onnx_image_processing_tpu_torch.models, "
            "onnx_image_processing_tpu_torch.ops, "
            "onnx_image_processing_tpu_torch.kernels.select_frontend, "
            "onnx_image_processing_tpu_torch.kernels.sparse_sampler, "
            "onnx_image_processing_tpu_torch.kernels.sinkhorn_kernel, "
            "onnx_image_processing_tpu_torch.kernels.detect_frontend, "
            "onnx_image_processing_tpu_torch.kernels.akaze_ladder, "
            "onnx_image_processing_tpu_torch.core.trace, "
            "onnx_image_processing_tpu_torch.geometry, "
            "onnx_image_processing_tpu_torch.models.streaming, "
            "onnx_image_processing_tpu_torch.cli.visual_odometry, "
            "onnx_image_processing_tpu_torch.cli.feature_detection, "
            "onnx_image_processing_tpu_torch.cli.image_matching, "
            "onnx_image_processing_tpu_torch.cli.image_matching_extraction, "
            "onnx_image_processing_tpu_torch.tools.ablate_sampler; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])


def test_launch_counters_stay_zero_on_cpu(gray_image_pair):
    img1, img2 = gray_image_pair
    fn = models.build(NAME + "_extraction", max_keypoints=K,
                      max_matches=MAX_MATCHES, device="cpu")
    reset_launch_counts()
    fn(torch.from_numpy(img1), torch.from_numpy(img2))
    counts = launch_counts()
    assert set(counts) == {"select_frontend", "sparse_sampler", "sinkhorn",
                           "detect_frontend", "akaze_ladder", "sparse_sampler_ablate",
                           "min_eigvec9", "project_essential", "essential_hypotheses"}
    assert all(c == 0 for c in counts.values()), counts


def test_inputs_on_another_device_raise(gray_image_pair):
    img1, img2 = gray_image_pair
    fn = models.build(NAME, max_keypoints=K, device="cpu")
    assert fn.device == torch.device("cpu")
    with pytest.raises(ValueError):
        fn(torch.from_numpy(img1), torch.from_numpy(img2).to("meta"))
    moved = fn.to("meta")
    assert moved.table.thresholds.device.type == "meta"


def test_unported_options_raise(gray_image_pair):
    """The flagship with ``topk_mode="approx"`` matches JAX's (which off a
    TPU selects exactly, as block) under the tolerances above; the L1 cost,
    the essential pipelines, the dense family and the auxiliary heads (FAST,
    DoG, voxel downsampling) build and run; an unknown name raises."""
    img1, img2 = gray_image_pair
    j_fn = jax_models.build(NAME, max_keypoints=K, topk_mode="approx")
    fn = models.build(NAME, max_keypoints=K, topk_mode="approx", device="cpu")
    _assert_matches_jax(
        tuple(o.numpy() for o in fn(torch.from_numpy(img1), torch.from_numpy(img2))),
        tuple(np.asarray(o) for o in j_fn(jnp.asarray(img1), jnp.asarray(img2))))
    for name in ("fast", "dog", "dog_with_score", "voxel_downsampling"):
        assert models.build(name, device="cpu").device == torch.device("cpu")
    with pytest.raises(KeyError, match="unknown pipeline"):
        models.build("harris", device="cpu")
    assert models.build("shi_tomasi_bad_sinkhorn", device="cpu").cfg.max_keypoints == 1024
    img1, img2 = (torch.from_numpy(i) for i in gray_image_pair)
    k1, k2, p = models.build(NAME, max_keypoints=32, distance_type="l1", epsilon=2.0,
                             device="cpu")(img1, img2)
    assert p.shape == (1, 33, 33) and bool(torch.isfinite(p).all())
    ess = models.build("akaze_sparse_bad_sinkhorn_essential_matrix", device="cpu")
    assert models.get("akaze_sparse_bad_sinkhorn_essential_matrix").takes_k_inv
    assert ess.cfg.max_keypoints == 1024
