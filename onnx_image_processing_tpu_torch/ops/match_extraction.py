"""Mutual-nearest-neighbour match extraction (port of
``onnx_image_processing_tpu/ops/match_extraction.py``)."""

from __future__ import annotations

import torch

from .keypoints import _top_k


def extract_mutual_matches(p: torch.Tensor, keypoints1: torch.Tensor,
                           keypoints2: torch.Tensor, max_matches: int = 100,
                           threshold: float = 0.1):
    """Mutual-NN matches sorted by probability, padded to ``max_matches``.

    Args:
        p: (B, N+1, M+1) probability matrix with dustbin.
        keypoints1: (B, N, 2), keypoints2: (B, M, 2) (y, x) keypoints.

    Returns:
        matched_kpts1 (B, K', 2), matched_kpts2 (B, K', 2), scores (B, K'),
        valid (B, K') bool. Ties go lowest index first (``torch.argmax``
        returns the first maximum; top-k is a stable sort).
    """
    n = keypoints1.shape[1]
    m = keypoints2.shape[1]
    core = p[:, :n, :m]

    best_j = torch.argmax(core, dim=2)                       # (B, N)
    best_p = torch.amax(core, dim=2)                         # (B, N)
    best_i = torch.argmax(core, dim=1)                       # (B, M)
    roundtrip = torch.gather(best_i, 1, best_j)              # (B, N)
    is_mutual = roundtrip == torch.arange(n, device=p.device)[None, :]
    valid = is_mutual & (best_p >= threshold)

    sort_scores = torch.where(valid, best_p, -1.0)
    top_scores, top_idx = _top_k(sort_scores, min(max_matches, n))
    if n < max_matches:
        pad = max_matches - n
        top_scores = torch.nn.functional.pad(top_scores, (0, pad))
        top_idx = torch.nn.functional.pad(top_idx, (0, pad))

    idx1 = top_idx.clamp(0, n - 1)
    mk1 = torch.gather(keypoints1, 1, idx1[..., None].expand(-1, -1, 2))
    j_idx = torch.gather(best_j, 1, idx1).clamp(0, m - 1)
    mk2 = torch.gather(keypoints2, 1, j_idx[..., None].expand(-1, -1, 2))
    return mk1, mk2, top_scores, top_scores > 0.0
