"""PyTorch port vs JAX: log-domain Sinkhorn.

Band: atol 1e-6 plus 1e-5 relative. The two libraries' float32 logsumexp
differ in exp/log rounding and summation order by a few ulps; one ulp of a
potential u or v (|u| up to ~20 here) moves log P by ~2e-6, i.e. P by ~2e-6
of itself, so an absolute band alone would fail on the larger entries
(the dustbin row sums to M). Inputs follow the JAX kernel tests: normal
(0, 0.5) descriptors, D = 64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu.kernels.sinkhorn_kernel import sinkhorn_core
from onnx_image_processing_tpu.ops.sinkhorn import sinkhorn_match as j_sinkhorn_match
from onnx_image_processing_tpu_torch.kernels.sinkhorn_kernel import sinkhorn_core_plain
from onnx_image_processing_tpu_torch.ops import sinkhorn_inputs, sinkhorn_match

BAND = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _descriptors(n, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (2, n, 64)).astype(np.float32),
            rng.normal(0, 0.5, (2, m, 64)).astype(np.float32))


CASES = [(64, 96, 0.05), (64, 80, 1.0), (128, 100, 0.05), (128, 96, 1.0)]


@pytest.mark.parametrize("n,m,eps", CASES)
def test_sinkhorn_match_matches_jax(n, m, eps):
    d1, d2 = _descriptors(n, m, seed=n + m)
    p_t = sinkhorn_match(torch.from_numpy(d1), torch.from_numpy(d2), epsilon=eps)
    p_j = j_sinkhorn_match(jnp.asarray(d1), jnp.asarray(d2), epsilon=eps,
                           use_pallas=False)
    assert p_t.shape == (2, n + 1, m + 1)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **BAND)


@pytest.mark.parametrize("n,m,eps", CASES)
def test_sinkhorn_sweeps_match_pallas_interpret(n, m, eps):
    """The plain sweeps (the CPU side of the CUDA kernel) against the JAX
    Pallas kernel in interpret mode, on the same assembled inputs."""
    d1, d2 = _descriptors(n, m, seed=3 * n + m)
    ls, lmu, lnu = sinkhorn_inputs(torch.from_numpy(d1), torch.from_numpy(d2), eps)
    assert ls.shape == (2, n + 1, m + 1)
    np.testing.assert_allclose(lmu[:, n].numpy(), np.log(m), rtol=1e-6)
    np.testing.assert_allclose(lnu[:, m].numpy(), np.log(n), rtol=1e-6)
    p_t = sinkhorn_core_plain(ls, lmu, lnu, 20)
    p_j = sinkhorn_core(jnp.asarray(ls.numpy()), jnp.asarray(lmu.numpy()),
                        jnp.asarray(lnu.numpy()), iters=20, interpret=True)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **BAND)
    # The final sweep sets the column marginals.
    np.testing.assert_allclose(p_t[:, :, :m].sum(1).numpy(), 1.0, atol=1e-4)


def test_sinkhorn_rejects_bad_arguments():
    d = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError):
        sinkhorn_match(d, d, iterations=0)
    with pytest.raises(ValueError):
        sinkhorn_match(d, d, epsilon=0.0)
    with pytest.raises(NotImplementedError):
        sinkhorn_match(d, d, distance_type="l1")
