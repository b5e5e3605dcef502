"""Host-side (NumPy) outlier filters for post-inference match filtering.

Parity with `pytorch_model/matching/outlier_filters.py:11-116` — these operate on
already-fetched probability matrices outside the graph; the in-graph
equivalents live in :mod:`.sinkhorn` (probability_ratio_mask / dustbin_margin_mask).
A copy of ``onnx_image_processing_tpu/ops/outlier_filters.py``.
"""

from __future__ import annotations

import numpy as np


def probability_ratio_filter(P: np.ndarray, ratio_threshold: float = 2.0) -> np.ndarray:
    """Keep rows whose best probability beats the second-best by ``ratio_threshold``.

    Args:
        P: (K, K) core probability matrix (no dustbin).

    Returns:
        (K,) bool mask.
    """
    k = P.shape[0]
    if k < 2:
        return np.ones(k, dtype=bool)
    part = np.partition(P, -2, axis=1)
    best = part[:, -1]
    second = part[:, -2]
    return (best / (second + 1e-8)) >= ratio_threshold


def dustbin_margin_filter(P: np.ndarray, margin: float = 0.3) -> np.ndarray:
    """Keep rows whose best match exceeds the dustbin probability by ``margin``.

    Args:
        P: (K+1, K+1) full probability matrix including dustbin.

    Returns:
        (K,) bool mask.
    """
    k = P.shape[0] - 1
    dustbin = P[:k, k]
    best = P[:k, :k].max(axis=1)
    return (best - dustbin) >= margin
