"""Log-domain Sinkhorn sweeps on assembled log-scores.

Port of ``onnx_image_processing_tpu/kernels/sinkhorn_kernel.py``
(``sinkhorn_core``). On a CUDA tensor :func:`sinkhorn_core` launches
``csrc/sinkhorn.cu``; on a CPU tensor it runs :func:`sinkhorn_core_plain`,
the port of the ``fori_loop`` body of ``ops/sinkhorn.py``. Nothing is
padded, so the TPU kernel's -1e30 sentinel masking is not needed.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, _build, use_kernel

LAUNCHES = LaunchCounter("sinkhorn")


def sinkhorn_core_plain(log_scores: torch.Tensor, log_mu: torch.Tensor,
                        log_nu: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same contract."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(log_scores + v[:, None, :], dim=-1)
        v = log_nu - torch.logsumexp(log_scores + u[:, :, None], dim=-2)
    return torch.exp(log_scores + u[:, :, None] + v[:, None, :])


def sinkhorn_core(log_scores: torch.Tensor, log_mu: torch.Tensor,
                  log_nu: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Run ``iters`` sweeps ``u = log_mu - LSE_row(S + v)``,
    ``v = log_nu - LSE_col(S + u)`` from zeros; return P = exp(S + u + v).

    Args:
        log_scores: (B, N1, M1) float32, dustbin row/column included.
        log_mu: (B, N1), log_nu: (B, M1) float32 log-marginals.
    """
    if iters <= 0:
        raise ValueError(f"iters must be positive, got {iters}")
    if not use_kernel(log_scores):
        return sinkhorn_core_plain(log_scores, log_mu, log_nu, iters)
    b, n1, m1 = log_scores.shape
    expect = {"log_scores": (log_scores, (b, n1, m1)),
              "log_mu": (log_mu, (b, n1)), "log_nu": (log_nu, (b, m1))}
    for name, (t, shape) in expect.items():
        if t.device != log_scores.device:
            raise ValueError(f"{name} is on {t.device}, log_scores on {log_scores.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = log_scores.device
    u = torch.empty((b, n1), dtype=torch.float32, device=dev)
    v = torch.zeros((b, m1), dtype=torch.float32, device=dev)
    p = torch.empty((b, n1, m1), dtype=torch.float32, device=dev)
    fn = _build.entry("oip_sinkhorn", [ctypes.c_void_p] * 6
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(_build.ptr(log_scores), _build.ptr(log_mu), _build.ptr(log_nu),
             _build.ptr(u), _build.ptr(v), _build.ptr(p), b, n1, m1,
             int(iters), _build.stream(log_scores))
    _build.check(err, "sinkhorn launch")
    LAUNCHES.count += 1
    return p
