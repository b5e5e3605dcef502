"""Log-domain Sinkhorn matching with dustbin (port of
``onnx_image_processing_tpu/ops/sinkhorn.py``): the L2 and L1 costs,
``sinkhorn_match``, ``sinkhorn_match_with_scores`` and the in-graph outlier
filters of ``sinkhorn_match_with_filters``.

The sweeps run in ``kernels/sinkhorn_kernel.py``. Everything stays float32:
fp16 Sinkhorn gives NaNs, and a TF32 cost matrix would shift the logits.
"""

from __future__ import annotations

import torch

from ..core import full_fp32
from ..kernels import sinkhorn_kernel

# Stream the L1 cost when the (B, N, M, D) difference tensor would exceed this
# many elements (~64 MB f32); at K=1024, D=512 the direct form is ~2 GB.
_L1_DIRECT_ELEMS = 1 << 24


def _l1_cost(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """Pairwise L1 cost without materializing (B, N, M, D): desc2 is taken
    in column chunks, so the peak is one (B, N, chunk, D) slab."""
    b, n, d = desc1.shape
    m = desc2.shape[1]
    if b * n * m * d <= _L1_DIRECT_ELEMS:
        return (desc1[:, :, None, :] - desc2[:, None, :, :]).abs().sum(-1)
    chunk = max(1, min(m, _L1_DIRECT_ELEMS // max(1, b * n * d)))
    return torch.cat([(desc1[:, :, None, :] - desc2[:, None, j:j + chunk, :])
                      .abs().sum(-1) for j in range(0, m, chunk)], dim=2)


def _cost_matrix(desc1: torch.Tensor, desc2: torch.Tensor,
                 distance_type: str) -> torch.Tensor:
    """Pairwise cost: squared L2 via norms and one full-f32 matrix product,
    or L1."""
    if distance_type == "l2":
        n1 = torch.sum(desc1 * desc1, dim=-1, keepdim=True)   # (B, N, 1)
        n2 = torch.sum(desc2 * desc2, dim=-1, keepdim=True)   # (B, M, 1)
        with full_fp32():
            dots = torch.matmul(desc1, desc2.transpose(-2, -1))
        return torch.clamp_min(n1 + n2.transpose(-2, -1) - 2.0 * dots, 0.0)
    if distance_type == "l1":
        return _l1_cost(desc1, desc2)
    raise ValueError(f"distance_type must be 'l1' or 'l2', got {distance_type}")


def sinkhorn_inputs(desc1: torch.Tensor, desc2: torch.Tensor,
                    epsilon: float = 1.0, unused_score: float = 1.0,
                    distance_type: str = "l2"):
    """Assembled sweep inputs: log-scores (B, N+1, M+1) with the dustbin row
    and column at ``-unused_score / epsilon``, and the log-marginals
    ``log_mu`` (B, N+1) = [0..0, log M], ``log_nu`` (B, M+1) = [0..0, log N]."""
    if epsilon <= 0:
        raise ValueError(f"epsilon must be positive, got {epsilon}")
    desc1 = desc1.to(torch.float32)
    desc2 = desc2.to(torch.float32)
    b, n, _ = desc1.shape
    m = desc2.shape[1]
    cost = _cost_matrix(desc1, desc2, distance_type.lower())
    log_scores = torch.nn.functional.pad(-cost / epsilon, (0, 1, 0, 1),
                                         value=-unused_score / epsilon)
    dev = desc1.device
    # float32 log of the counts, taken on the host: a scalar made on the card
    # would be a blocking copy.
    log_m = torch.log(torch.tensor(float(m), dtype=torch.float32)).item()
    log_n = torch.log(torch.tensor(float(n), dtype=torch.float32)).item()
    log_mu = torch.zeros((b, n + 1), dtype=torch.float32, device=dev)
    log_mu[:, n] = log_m
    log_nu = torch.zeros((b, m + 1), dtype=torch.float32, device=dev)
    log_nu[:, m] = log_n
    return log_scores.contiguous(), log_mu, log_nu


def sinkhorn_match(desc1: torch.Tensor, desc2: torch.Tensor,
                   iterations: int = 20, epsilon: float = 1.0,
                   unused_score: float = 1.0,
                   distance_type: str = "l2") -> torch.Tensor:
    """Soft assignment between (B, N, D) and (B, M, D) descriptor sets.

    Returns:
        (B, N+1, M+1) probability matrix; the last row/column is the dustbin.
    """
    log_scores, log_mu, log_nu = sinkhorn_inputs(desc1, desc2, epsilon,
                                                 unused_score, distance_type)
    return sinkhorn_kernel.sinkhorn_core(log_scores, log_mu, log_nu,
                                         iters=iterations)


def sinkhorn_match_with_scores(desc1: torch.Tensor, desc2: torch.Tensor,
                               **kwargs):
    """As :func:`sinkhorn_match`, plus per-point best-match confidences.

    Returns:
        (P, scores0 (B, N), scores1 (B, M)): the max core probability per
        row and per column.
    """
    n, m = desc1.shape[1], desc2.shape[1]
    p = sinkhorn_match(desc1, desc2, **kwargs)
    core = p[:, :n, :m]
    return p, core.amax(dim=-1), core.amax(dim=-2)


def probability_ratio_mask(p_core: torch.Tensor, threshold: float) -> torch.Tensor:
    """Best / second-best probability ratio test per row. Only the two top
    values are used, so their tie order does not matter."""
    if p_core.shape[-1] >= 2:
        top2 = torch.topk(p_core, 2, dim=-1).values
        best, second = top2[..., 0], top2[..., 1]
    else:
        best = p_core[..., 0]
        second = torch.zeros_like(best)
    return (best / (second + 1e-8)) >= threshold


def dustbin_margin_mask(p: torch.Tensor, margin: float) -> torch.Tensor:
    """Best-match probability minus the row's dustbin probability >= margin."""
    n = p.shape[1] - 1
    m = p.shape[2] - 1
    return (p[:, :n, :m].amax(dim=-1) - p[:, :n, m]) >= margin


def sinkhorn_match_with_filters(desc1: torch.Tensor, desc2: torch.Tensor,
                                iterations: int = 20, epsilon: float = 1.0,
                                unused_score: float = 1.0,
                                distance_type: str = "l2",
                                ratio_threshold: float | None = None,
                                dustbin_margin: float | None = None):
    """Sinkhorn matching with in-graph outlier filters.

    The ratio filter is active iff ``ratio_threshold > 0``, the dustbin
    filter iff ``dustbin_margin >= 0`` (None disables either). A filtered
    row has its core probabilities zeroed and its dustbin set to 1.0.

    Returns:
        (P_filtered (B, N+1, M+1), valid_mask (B, N) bool).
    """
    ratio_threshold = -1.0 if ratio_threshold is None else ratio_threshold
    dustbin_margin = -1.0 if dustbin_margin is None else dustbin_margin
    n, m = desc1.shape[1], desc2.shape[1]
    p = sinkhorn_match(desc1, desc2, iterations=iterations, epsilon=epsilon,
                       unused_score=unused_score, distance_type=distance_type)
    valid = torch.ones((p.shape[0], n), dtype=torch.bool, device=p.device)
    core = p[:, :n, :m]
    if ratio_threshold > 0:
        valid = valid & probability_ratio_mask(core, ratio_threshold)
    if dustbin_margin >= 0:
        valid = valid & dustbin_margin_mask(p, dustbin_margin)

    vf = valid.to(p.dtype)[..., None]                         # (B, N, 1)
    dust_col = (1.0 - vf) + vf * p[:, :n, m:m + 1]            # (B, N, 1)
    rows = torch.cat([core * vf, dust_col], dim=-1)           # (B, N, M+1)
    return torch.cat([rows, p[:, n:n + 1, :]], dim=1), valid
