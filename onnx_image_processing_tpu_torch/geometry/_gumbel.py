"""The RANSAC Gumbel table of the JAX package, made in numpy.

``essential_ransac_from_candidates`` in the JAX package draws
``jax.random.gumbel(jax.random.PRNGKey(seed), (hypotheses, n), float32)`` as
a constant of its graph, and samples its minimal sets from it. This module
makes the same table without JAX, so the port samples the same hypotheses:

* the key of ``PRNGKey(seed)`` for a 32-bit seed is ``(0, seed)``;
* the bits are JAX's default threefry2x32 stream with
  ``jax_threefry_partitionable=True`` (the default since JAX 0.5; checked
  against JAX 0.9.0): element ``i`` of the row-major table is
  ``x0 ^ x1`` of ``threefry2x32(key, (i >> 32, i & 0xffffffff))``;
* the bits become a uniform in [1, 2) minus 1 (the top 23 bits as the
  mantissa), floored at the smallest normal float32, and the Gumbel value
  is ``-log(-log(u))`` (``mode="low"``, JAX's default).

The uint32 bits are exact. Each log is taken in float64 and rounded to
float32, so each step is correctly rounded; XLA's float32 log may differ from
that by an ulp, so the floats agree within a few ulps.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(PRNGKey(seed), shape, uint32)`` (partitionable)."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be a 32-bit unsigned value, got {seed}")
    count = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32((0, seed), hi, lo)
    return (b0 ^ b1).reshape(shape)


def gumbel_table(seed: int, hypotheses: int, n: int) -> np.ndarray:
    """``jax.random.gumbel(PRNGKey(seed), (hypotheses, n), float32)``."""
    bits = random_bits(seed, (hypotheses, n))
    one = np.array(1.0, np.float32).view(np.uint32)
    u = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    u = np.maximum(u, np.finfo(np.float32).tiny)
    inner = np.log(u.astype(np.float64)).astype(np.float32)
    return (-np.log((-inner).astype(np.float64))).astype(np.float32)
