"""Log-domain Sinkhorn matching with dustbin (port of
``onnx_image_processing_tpu/ops/sinkhorn.py``, the L2 ``sinkhorn_match``).

The sweeps run in ``kernels/sinkhorn_kernel.py``. Everything stays float32:
fp16 Sinkhorn gives NaNs, and a TF32 cost matrix would shift the logits.
"""

from __future__ import annotations

import torch

from ..core import full_fp32
from ..kernels import sinkhorn_kernel


def _cost_matrix(desc1: torch.Tensor, desc2: torch.Tensor,
                 distance_type: str) -> torch.Tensor:
    """Pairwise squared-L2 cost via norms and one full-f32 matrix product."""
    if distance_type != "l2":
        raise NotImplementedError(
            f"distance_type {distance_type!r} is not ported (use 'l2')")
    n1 = torch.sum(desc1 * desc1, dim=-1, keepdim=True)   # (B, N, 1)
    n2 = torch.sum(desc2 * desc2, dim=-1, keepdim=True)   # (B, M, 1)
    with full_fp32():
        dots = torch.matmul(desc1, desc2.transpose(-2, -1))
    return torch.clamp_min(n1 + n2.transpose(-2, -1) - 2.0 * dots, 0.0)


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
    log_m = torch.log(torch.tensor(float(m), dtype=torch.float32, device=dev))
    log_n = torch.log(torch.tensor(float(n), dtype=torch.float32, device=dev))
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
