"""PyTorch port vs JAX: the sparse BAD descriptor and its box sampler.

The sampler's plain version (the CPU side of its CUDA kernel) is held to
the JAX oracle ``reference_box_sample`` at 1e-4 on [0, 255] box means. The
whole descriptor is held at the bit level: hard-binarized descriptors may
differ only where a sample coordinate lands within an ulp of a rounding
boundary (atan2/sin/cos differ by ulps between the libraries), under 1e-3
of the entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu.kernels.sparse_sampler import reference_box_sample
from onnx_image_processing_tpu.ops import bad as jbad
from onnx_image_processing_tpu.ops.orientation import angle_moments as j_angle_moments
from onnx_image_processing_tpu_torch.kernels import sparse_sampler
from onnx_image_processing_tpu_torch.ops import bad as tbad

PS, R_MAX = 56, 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    return jbad.load_bad_params(512)


@pytest.fixture(scope="module")
def table(jax_params):
    return tbad.params_from_jax(jax_params)


def test_npz_loader_matches_jax(jax_params):
    port = tbad.load_bad_params(512)
    for field in ("offset_x1", "offset_x2", "offset_y1", "offset_y2", "radii",
                  "thresholds"):
        a, b = getattr(port, field), getattr(jax_params, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (port.num_pairs, port.max_radius) == (jax_params.num_pairs,
                                                 jax_params.max_radius)


def test_table_buffers_match_jax_layout(jax_params, table):
    lay = jbad.sample_layout(jax_params)
    assert table.groups == lay.groups
    assert table.off_y.shape == (805,)
    assert [g[0] for g in table.groups] == list(range(1, 8))
    np.testing.assert_array_equal(table.off_y.numpy(), lay.off_y)
    np.testing.assert_array_equal(table.off_x.numpy(), lay.off_x)
    np.testing.assert_array_equal(table.idx1.numpy(), lay.idx1)
    np.testing.assert_array_equal(table.idx2.numpy(), lay.idx2)
    np.testing.assert_array_equal(table.thresholds.numpy(), jax_params.thresholds)
    for (r, lo, hi) in table.groups:
        assert (table.sample_radius[lo:hi] == r).all()
    # The port's own loader builds the same buffers.
    own = tbad.BADTable(tbad.load_bad_params(512))
    for name, buf in table.named_buffers():
        assert torch.equal(buf, dict(own.named_buffers())[name])


@pytest.mark.parametrize("bilinear", [False, True])
def test_box_sample_plain_matches_jax_reference(bilinear, table):
    rng = np.random.default_rng(9 + bilinear)
    b, k, h, w = 2, 24, 90, 120
    s = table.off_y.shape[0]
    img = rng.uniform(0, 255, (b, h + 2 * R_MAX, w + 2 * R_MAX)).astype(np.float32)
    sy = (rng.integers(0, h - PS + 1, (b, k)) // 8 * 8).astype(np.int32)
    sx = rng.integers(0, w - PS + 1, (b, k)).astype(np.int32)
    ly = rng.uniform(0, PS - 1, (b, k, s)).astype(np.float32)
    lx = rng.uniform(0, PS - 1, (b, k, s)).astype(np.float32)
    lx[:, :, :5] = [0.0, PS - 1.0, 2.5, 3.5, 10.0]  # boundary and half-way taps
    ref = jax.jit(lambda *a: reference_box_sample(
        *a, PS, R_MAX, table.groups, bilinear=bilinear))(
        jnp.asarray(img), jnp.asarray(sy), jnp.asarray(sx), jnp.asarray(ly),
        jnp.asarray(lx))
    out = sparse_sampler.box_sample(
        torch.from_numpy(img), torch.from_numpy(sy), torch.from_numpy(sx),
        torch.from_numpy(ly), torch.from_numpy(lx), table.sample_radius,
        table.groups, PS, R_MAX, bilinear=bilinear)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def _keypoints(rng, b, k, h, w):
    kp = np.stack([rng.integers(0, h, (b, k)), rng.integers(0, w, (b, k))],
                  axis=-1).astype(np.float32)
    kp[:, -3:] = -1.0  # invalid slots get zero descriptors
    return kp


@pytest.mark.parametrize("binarize,soft,mode", [
    (True, False, "nearest"),    # the flagship's setting
    (False, True, "nearest"),
    (True, True, "bilinear"),
])
def test_sparse_bad_matches_jax(binarize, soft, mode, gray_image, jax_params, table):
    rng = np.random.default_rng(17)
    img = np.concatenate([gray_image, gray_image[:, :, ::-1, :].copy()])
    kp = _keypoints(rng, 2, 64, *img.shape[-2:])
    m10, m01 = (np.array(m) for m in j_angle_moments(jnp.asarray(img)))
    kw = dict(binarize=binarize, soft_binarize=soft, sampling_mode=mode)
    ref = np.asarray(jax.jit(lambda *a: jbad.sparse_bad(
        a[0], a[1], jax_params, orientation_mm=a[2:], use_pallas=False, **kw))(
        jnp.asarray(img), jnp.asarray(kp), jnp.asarray(m10), jnp.asarray(m01)))
    out = tbad.sparse_bad(torch.from_numpy(img), torch.from_numpy(kp), table,
                          orientation_mm=(torch.from_numpy(m10), torch.from_numpy(m01)),
                          **kw).numpy()
    assert out.shape == (2, 64, 512)
    assert (out[:, -3:] == 0).all()
    if binarize and not soft:
        assert (out != ref).mean() < 1e-3
    else:
        assert (np.abs(out - ref) > 1e-4).mean() < 1e-3


def test_sparse_bad_small_image_and_unoriented(table, jax_params):
    """Images smaller than the 56 px window are edge-extended, and the
    unoriented path samples the offsets as they are."""
    rng = np.random.default_rng(23)
    img = rng.uniform(0, 255, (1, 1, 40, 50)).astype(np.float32)
    kp = _keypoints(rng, 1, 16, 40, 50)
    kw = dict(binarize=True, soft_binarize=False)
    ref = np.asarray(jax.jit(lambda i, k: jbad.sparse_bad(
        i, k, jax_params, use_pallas=False, **kw))(jnp.asarray(img), jnp.asarray(kp)))
    out = tbad.sparse_bad(torch.from_numpy(img), torch.from_numpy(kp), table, **kw)
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError):
        tbad.sparse_bad(torch.from_numpy(img), torch.from_numpy(kp), table,
                        sampling_mode="cubic")


@pytest.mark.parametrize("skip", [(), ("boxsum",)])
def test_box_sample_ablated_cpu_branches(skip, table):
    """The ablation wrapper on a CPU tensor: the full variant is the plain
    sampler; without box sums each sample is its box's centre cell."""
    rng = np.random.default_rng(31)
    b, k, h, w = 2, 16, 80, 100
    s = table.off_y.shape[0]
    img = rng.uniform(0, 255, (b, h + 2 * R_MAX, w + 2 * R_MAX)).astype(np.float32)
    sy = (rng.integers(0, h - PS + 1, (b, k)) // 8 * 8).astype(np.int32)
    sx = rng.integers(0, w - PS + 1, (b, k)).astype(np.int32)
    ly = rng.uniform(0, PS - 1, (b, k, s)).astype(np.float32)
    lx = rng.uniform(0, PS - 1, (b, k, s)).astype(np.float32)
    args = (torch.from_numpy(img), torch.from_numpy(sy), torch.from_numpy(sx),
            torch.from_numpy(ly), torch.from_numpy(lx), table.sample_radius,
            table.groups, PS, R_MAX)
    out = torch.full((b, k, s), -7.0)
    got = sparse_sampler.box_sample_ablated(*args, skip=skip, out=out)
    assert got is out
    if not skip:
        assert torch.equal(got, sparse_sampler.box_sample(*args))
    else:
        iy = np.rint(ly).astype(np.int64) + sy[..., None] + R_MAX
        ix = np.rint(lx).astype(np.int64) + sx[..., None] + R_MAX
        want = img[np.arange(b)[:, None, None], iy, ix]
        np.testing.assert_array_equal(got.numpy(), want)


def test_box_sample_ablated_rejects_what_it_cannot_run(table):
    img = torch.zeros((1, 70, 70))
    args = (img, torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1, 1, 805)), torch.zeros((1, 1, 805)), table.sample_radius,
            table.groups, PS, R_MAX)
    with pytest.raises(ValueError, match="unknown stages"):
        sparse_sampler.box_sample_ablated(*args, skip=("roll",))
    for skip in (("load",), ("store",), ("boxsum", "store")):
        with pytest.raises(ValueError, match="no plain version"):
            sparse_sampler.box_sample_ablated(*args, skip=skip)
    assert set(sparse_sampler.STAGES) == {"load", "boxsum", "store"}
