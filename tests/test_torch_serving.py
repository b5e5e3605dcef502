"""The port's serving layer on the CPU: ``parallel.stream_map``,
``parallel.stream_map_chunked`` and ``models.build_batched``, mirroring the
JAX package's ``tests/test_parallel.py``, then the port's chunked stream
against the JAX package's on the same pairs.

Tolerances: within the port, results equal the per-pair sequential loop
(keypoints equal, P within 1e-5, the JAX test's atol); against JAX, those of
``tests/test_torch_flagship.py`` (keypoints equal, or at most 2 swapped per
image with P compared on the common keypoints; P within 5e-3).
"""

import jax
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu.parallel import stream_map_chunked as j_stream_map_chunked
from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.parallel import stream_map, stream_map_chunked

NAME = "shi_tomasi_angle_sparse_bad_sinkhorn"
SMALL = dict(max_keypoints=16, num_pairs=256)
H, W = 72, 96
P_ATOL = 1e-5
JAX_P_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pairs(n, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, (1, 1, H, W)).astype(np.float32),
             rng.uniform(0, 255, (1, 1, H, W)).astype(np.float32)) for _ in range(n)]


def _sequential(fn, pairs):
    return [tuple(o.numpy()[0] for o in fn(torch.from_numpy(a), torch.from_numpy(b)))
            for a, b in pairs]


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_allclose(g[2], w[2], atol=P_ATOL, rtol=0)


@pytest.mark.parametrize("depth", [1, 2, 4, 16])
def test_stream_map_matches_sequential(depth):
    def f(x):
        return x * 2.0, x.sum()

    xs = [torch.full((4, 4), float(i)) for i in range(7)]
    seq = [(a.numpy(), b.numpy()) for a, b in map(f, xs)]
    out = list(stream_map(f, xs, depth=depth))
    assert len(out) == len(seq)
    for (a1, b1), (a2, b2) in zip(out, seq):
        assert isinstance(a1, np.ndarray) and isinstance(b1, np.ndarray)
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("depth,produced_at_first", [(1, [0, 1]), (2, [0, 1, 2]),
                                                     (3, [0, 1, 2, 3])])
def test_stream_map_tuple_inputs_and_laziness(depth, produced_at_first):
    """At most ``depth`` steps are in flight: the first yield drains step 0
    right before step ``depth`` is dispatched."""
    produced = []

    def gen():
        for i in range(5):
            produced.append(i)
            yield torch.tensor(float(i)), torch.tensor(10.0 * i)

    it = stream_map(lambda a, b: a + b, gen(), depth=depth)
    assert produced == []
    first = next(it)
    assert produced == produced_at_first
    assert float(first) == 0.0
    assert [float(r) for r in it] == [11.0, 22.0, 33.0, 44.0]


def test_stream_map_keeps_the_structure_of_the_results():
    out = list(stream_map(lambda x: {"a": [x, x + 1], "n": 3}, [torch.ones(2)] * 2))
    assert out[1]["n"] == 3 and out[1]["a"][1].tolist() == [2.0, 2.0]


@pytest.mark.parametrize("call,match", [
    (lambda: stream_map(lambda x: x, [], depth=0), "depth"),
    (lambda: stream_map_chunked(lambda a, b: a, [], chunk=0), "chunk"),
    (lambda: stream_map_chunked(lambda a, b: a, [], chunk=2, depth=0), "depth"),
])
def test_stream_maps_reject_chunk_or_depth_below_one(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.fixture(scope="module")
def pairs():
    return _pairs(7)


@pytest.fixture(scope="module")
def sequential(pairs):
    return _sequential(models.build(NAME, device="cpu", **SMALL), pairs)


@pytest.mark.parametrize("chunk,depth", [(3, 2), (3, 1), (8, 2), (1, 3)])
def test_stream_map_chunked_matches_sequential(pairs, sequential, chunk, depth):
    """7 pairs: chunk 3 pads its final chunk of 1, chunk 8 its only one."""
    fb = models.build_batched(NAME, device="cpu", **SMALL)
    out = list(stream_map_chunked(fb, iter(pairs), chunk=chunk, depth=depth))
    assert out[0][0].shape == (16, 2) and out[0][2].shape == (17, 17)
    _assert_same_results(out, sequential)


def test_build_batched_chunks_equal_the_unchunked_call(pairs):
    a = torch.from_numpy(np.concatenate([p[0] for p in pairs[:5]]))
    b = torch.from_numpy(np.concatenate([p[1] for p in pairs[:5]]))
    whole = models.build_batched(NAME, device="cpu", **SMALL)(a, b)
    chunked = models.build_batched(NAME, chunk=2, device="cpu", **SMALL)
    assert chunked.chunk == 2 and chunked.device == torch.device("cpu")
    parts = chunked(a, b)
    assert [t.shape[0] for t in parts] == [5, 5, 5]
    assert torch.equal(parts[0], whole[0]) and torch.equal(parts[1], whole[1])
    torch.testing.assert_close(parts[2], whole[2], atol=P_ATOL, rtol=0)
    ext = models.build_batched(NAME + "_extraction", chunk=2, device="cpu", max_matches=8,
                               **SMALL)(a, b)
    want = models.build(NAME + "_extraction", device="cpu", max_matches=8, **SMALL)(a, b)
    assert [t.shape for t in ext] == [t.shape for t in want]
    assert torch.equal(ext[3], want[3]) and torch.equal(ext[0], want[0])


@pytest.mark.parametrize("name,match", [
    (NAME + "_essential_matrix", "k_inv"),
    ("shi_tomasi", "two-image"),
    ("voxel_downsampling", "two-image"),
])
def test_build_batched_rejects_what_it_cannot_serve(name, match):
    with pytest.raises(ValueError, match=match):
        models.build_batched(name, device="cpu")


def test_build_batched_rejects_chunk_below_one():
    with pytest.raises(ValueError, match="chunk"):
        models.build_batched(NAME, chunk=0, device="cpu", **SMALL)


def _common_index(a, b):
    inv_a = {tuple(v): i for i, v in enumerate(a.tolist())}
    inv_b = {tuple(v): i for i, v in enumerate(b.tolist())}
    shared = sorted(set(inv_a) & set(inv_b))
    return ([inv_a[v] for v in shared] + [len(a)], [inv_b[v] for v in shared] + [len(b)],
            len(set(inv_a) ^ set(inv_b)))


def test_stream_map_chunked_matches_jax(pairs):
    fb = models.build_batched(NAME, device="cpu", **SMALL)
    got = list(stream_map_chunked(fb, pairs, chunk=3, depth=2))
    jfb = jax_models.build_batched(NAME, use_pallas=False, **SMALL)
    want = [jax.tree_util.tree_map(np.asarray, o)
            for o in j_stream_map_chunked(jfb, pairs, chunk=3, depth=2)]
    assert len(got) == len(want) == len(pairs)
    for (k1, k2, p), (k1j, k2j, pj) in zip(got, want):
        assert p.shape == pj.shape == (17, 17)
        ia1, ib1, s1 = _common_index(k1, k1j)
        ia2, ib2, s2 = _common_index(k2, k2j)
        assert max(s1, s2) <= 2
        np.testing.assert_allclose(p[np.ix_(ia1, ia2)], pj[np.ix_(ib1, ib2)],
                                   atol=JAX_P_ATOL, rtol=0)
    assert sum(np.array_equal(g[0], w[0]) for g, w in zip(got, want)) >= len(pairs) - 1
    assert got[0][2].dtype == want[0][2].dtype == np.float32


def _compose_pair(seed, b, h=96, w=128):
    """``tests/test_parallel.py``'s inputs: B uniform images and their 5-px roll."""
    img = np.random.default_rng(seed).uniform(0, 255, (b, 1, h, w)).astype(np.float32)
    return img, np.roll(img, 5, axis=3).copy()


COMPOSE = dict(max_keypoints=32, num_pairs=256)


@pytest.mark.parametrize("chunk", [None, 2])
def test_vmap_pairs_matches_stacked_and_jax(chunk):
    """``vmap_pairs`` of the single-pair flagship over B = 3 pairs (with
    chunk 2, a remainder of 1) gives the stacked-batch call's shapes,
    keypoints and P (the JAX test's atol), and JAX's ``vmap_pairs``
    result under the flagship tolerances."""
    from onnx_image_processing_tpu.parallel import vmap_pairs as j_vmap_pairs
    from onnx_image_processing_tpu_torch.parallel import vmap_pairs

    img1, img2 = _compose_pair(7, 3)
    fn = models.build(NAME, device="cpu", **COMPOSE)
    stacked = fn(torch.from_numpy(img1), torch.from_numpy(img2))
    got = vmap_pairs(fn, chunk=chunk)(torch.from_numpy(img1), torch.from_numpy(img2))
    assert [t.shape for t in got] == [t.shape for t in stacked]
    assert torch.equal(got[0], stacked[0]) and torch.equal(got[1], stacked[1])
    torch.testing.assert_close(got[2], stacked[2], atol=P_ATOL, rtol=0)
    j_fn = jax_models.build(NAME, use_pallas=False, **COMPOSE)
    want = j_vmap_pairs(j_fn, chunk=chunk)(jax.numpy.asarray(img1), jax.numpy.asarray(img2))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=JAX_P_ATOL, rtol=0)


def test_chunk_batch_matches_unchunked_and_jax():
    """``chunk_batch`` of the streaming split's extract and match at B = 5,
    chunk 2 (a remainder sub-batch of 1) equals the unchunked calls bit for
    bit; B <= chunk passes straight through; the chunked match gives JAX's
    ``chunk_batch`` result under the flagship tolerances."""
    from onnx_image_processing_tpu.parallel import chunk_batch as j_chunk_batch
    from onnx_image_processing_tpu_torch.parallel import chunk_batch

    imgs, prev = _compose_pair(9, 5)
    extract, match = models.build_streaming(NAME, device="cpu", **COMPOSE)
    f_prev, f_new = extract(torch.from_numpy(prev)), extract(torch.from_numpy(imgs))
    ref = match(f_prev, f_new)
    ex_c, ma_c = chunk_batch(extract, chunk=2), chunk_batch(match, chunk=2)
    fc_prev, fc_new = ex_c(torch.from_numpy(prev)), ex_c(torch.from_numpy(imgs))
    for a, b in zip(fc_prev, f_prev):
        assert torch.equal(a, b)
    out = ma_c(fc_prev, fc_new)
    assert len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(out, ref))
    small = chunk_batch(match, chunk=8)(f_prev, f_new)
    assert all(torch.equal(a, b) for a, b in zip(small, ref))

    j_extract, j_match = jax_models.build_streaming(NAME, use_pallas=False, **COMPOSE)
    j_ex, j_ma = j_chunk_batch(j_extract, chunk=2), j_chunk_batch(j_match, chunk=2)
    want = j_ma(j_ex(jax.numpy.asarray(prev)), j_ex(jax.numpy.asarray(imgs)))
    assert len(want) == len(out)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(want[2]), atol=JAX_P_ATOL, rtol=0)


def test_chunk_batch_rejects_chunk_below_one():
    from onnx_image_processing_tpu_torch.parallel import chunk_batch

    with pytest.raises(ValueError, match="chunk"):
        chunk_batch(lambda x: x, chunk=0)
