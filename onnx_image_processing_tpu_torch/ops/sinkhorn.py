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

# Stream the L1 cost when the (..., N, M, D) difference tensor would exceed this
# many elements (~64 MB f32); at K=1024, D=512 the direct form is ~2 GB.
_L1_DIRECT_ELEMS = 1 << 24


def _l1_cost(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """Pairwise L1 cost of (..., N, D) and (..., M, D) without materializing
    (..., N, M, D): desc2 is taken in column chunks, so the peak is one
    (..., N, chunk, D) slab."""
    n, d = desc1.shape[-2:]
    m = desc2.shape[-2]
    lead = desc1[..., 0, 0].numel()
    if lead * n * m * d <= _L1_DIRECT_ELEMS:
        return (desc1[..., :, None, :] - desc2[..., None, :, :]).abs().sum(-1)
    chunk = max(1, min(m, _L1_DIRECT_ELEMS // max(1, lead * n * d)))
    return torch.cat([(desc1[..., :, None, :] - desc2[..., None, j:j + chunk, :])
                      .abs().sum(-1) for j in range(0, m, chunk)], dim=-1)


def _l2_cost(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """Squared L2 of (N, D) and (M, D) via norms and one product (full
    float32 under :func:`_cost_matrix`'s ``full_fp32``)."""
    n1 = torch.sum(desc1 * desc1, dim=-1, keepdim=True)   # (N, 1)
    n2 = torch.sum(desc2 * desc2, dim=-1, keepdim=True)   # (M, 1)
    dots = desc1 @ desc2.T
    return torch.clamp_min(n1 + n2.T - 2.0 * dots, 0.0)


def _cost_matrix(desc1: torch.Tensor, desc2: torch.Tensor,
                 distance_type: str) -> torch.Tensor:
    """Pairwise (B, N, M) cost, squared L2 or L1, one batch entry at a
    time: the card's batched product and reductions pick other summation
    orders at other batch sizes, and at eps 0.05 twenty sweeps carry such
    an ulp to ~2e-5 in P, so a pair's P would depend on how many pairs
    share the call (``models.build_batched``)."""
    if distance_type == "l2":
        cost = _l2_cost
    elif distance_type == "l1":
        cost = _l1_cost
    else:
        raise ValueError(f"distance_type must be 'l1' or 'l2', got {distance_type}")
    b = desc1.shape[0]
    with full_fp32():
        if isinstance(b, torch.SymInt):
            # A trace with a symbolic batch: the same per-entry cost, as a
            # loop that runs when the traced program does (its body may not
            # touch global state, hence full_fp32 out here).
            from torch._higher_order_ops.map import map as map_entries

            return map_entries(lambda pair: cost(*pair), (desc1, desc2))
        if b == 1:
            return cost(desc1[0], desc2[0])[None]
        return torch.stack([cost(d1, d2) for d1, d2 in zip(desc1, desc2)])


def _log_count(count, b: int, device: torch.device) -> torch.Tensor:
    """(b, 1) float32 log of a size: the float64 log rounded to float32 (the
    correctly rounded value), computed on the device from a size that may be
    symbolic, so no host copy and no specialization."""
    return torch.full((b, 1), count, dtype=torch.float64, device=device).log().float()


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
    f32 = dict(dtype=torch.float32, device=dev)
    log_mu = torch.cat([torch.zeros((b, n), **f32), _log_count(m, b, dev)], dim=1)
    log_nu = torch.cat([torch.zeros((b, m), **f32), _log_count(n, b, dev)], dim=1)
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
