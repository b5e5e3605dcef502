"""Log-domain Sinkhorn sweeps on assembled log-scores.

Port of ``onnx_image_processing_tpu/kernels/sinkhorn_kernel.py``
(``sinkhorn_core``). On a CUDA tensor :func:`sinkhorn_core` launches
``csrc/sinkhorn.cu`` once: one cooperative launch over the card, batch
entries side by side on bands of CTAs, laid out by :func:`sinkhorn_plan`; on a CPU tensor it runs :func:`sinkhorn_core_plain`,
the port of the ``fori_loop`` body of ``ops/sinkhorn.py``. Nothing is
padded, so the TPU kernel's -1e30 sentinel masking is not needed.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import LaunchCounter, _build, use_kernel

LAUNCHES = LaunchCounter("sinkhorn")

SMEM_LIMIT = 232_448     # shared memory one CTA can use on Hopper (bytes)
H100_SMS = 132           # SMs of an H100 SXM, the plan's default
_WARPS = 16              # warps per CTA of the kernel (kWarps)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_resident: dict[tuple, tuple] = {}   # (n1, m1, batch, device) -> (plan, CTAs the card holds)


@dataclass(frozen=True)
class SinkhornPlan:
    """Launch layout: ``groups`` bands of ``ctas`` CTAs, band g taking
    batch entries g, g + groups, ...; CTA k of a band owns rows and columns
    [k * lines, (k + 1) * lines) of the matrix (clipped to its size), of
    which the first ``res_rows`` rows and ``res_cols`` columns stay in its
    shared memory; ``smem_bytes`` of dynamic shared memory per CTA."""

    ctas: int
    groups: int
    lines: int
    res_rows: int
    res_cols: int
    smem_bytes: int

    def bands(self, size: int) -> list[range]:
        """The rows (``size`` = n1) or columns (``size`` = m1) each CTA owns."""
        return [range(min(k * self.lines, size), min((k + 1) * self.lines, size))
                for k in range(self.ctas)]


def _smem_floats(n1: int, m1: int, lines: int, res_rows: int, res_cols: int) -> int:
    # csrc/sinkhorn.cu smem_floats: resident rows, resident columns, the
    # sweep's vector, the warps' partial max and sum, u of the CTA's rows.
    return res_rows * m1 + res_cols * n1 + max(n1, m1) + 2 * _WARPS + lines


def sinkhorn_plan(n1: int, m1: int, sms: int = H100_SMS, batch: int = 1) -> SinkhornPlan:
    """The kernel's layout for ``batch`` (n1, m1) matrices on a card with
    ``sms`` SMs; needs no card.

    ``groups`` entries run at once, each on its own band of sms // groups
    SMs, and the rest in turn: as many as min(batch, sms) while every line
    of a band stays in shared memory and the 16 warps of a CTA take all its
    lines in one pass (``lines`` <= 16), else one. Each CTA owns ``lines`` =
    ceil(max(n1, m1) / (sms // groups)) rows and as many columns, so the
    bands together need at most ``sms`` CTAs, and keeps as many of them in
    shared memory as fit under :data:`SMEM_LIMIT`, rows first.
    """
    if n1 <= 0 or m1 <= 0:
        raise ValueError(f"empty matrix {n1}x{m1}")
    if batch <= 0:
        raise ValueError(f"batch must be positive, got {batch}")
    for groups in range(min(batch, sms), 0, -1):
        plan = _band_plan(n1, m1, sms // groups, groups)
        if plan is not None and (groups == 1 or (plan.res_cols == plan.lines
                                                 and plan.lines <= _WARPS)):
            return plan
    raise ValueError(f"a {n1}x{m1} matrix leaves no room for its vectors in "
                     f"{SMEM_LIMIT} B of shared memory")


def _band_plan(n1: int, m1: int, band_sms: int, groups: int) -> SinkhornPlan | None:
    """The layout of ``groups`` bands of ``band_sms`` SMs each, or None if
    the vectors alone do not fit in shared memory."""
    size = max(n1, m1)
    lines = -(-size // band_sms)
    ctas = -(-size // lines)
    budget = SMEM_LIMIT // 4 - _smem_floats(n1, m1, lines, 0, 0)
    if budget < 0:
        return None
    res_rows = min(lines, budget // m1)
    res_cols = min(lines, (budget - res_rows * m1) // n1)
    return SinkhornPlan(ctas, groups, lines, res_rows, res_cols,
                        4 * _smem_floats(n1, m1, lines, res_rows, res_cols))


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
    plan = device_plan(n1, m1, dev, b)
    # u and v as the kernel publishes them: a value and its sweep, 64 bits.
    u = torch.empty((b, n1), dtype=torch.int64, device=dev)
    v = torch.empty((b, m1), dtype=torch.int64, device=dev)
    p = torch.empty((b, n1, m1), dtype=torch.float32, device=dev)
    fn = _build.entry("oip_sinkhorn", _ARGTYPES)
    err = fn(log_scores.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(), u.data_ptr(),
             v.data_ptr(), p.data_ptr(), b, n1, m1, int(iters), plan.ctas, plan.groups,
             plan.lines, plan.res_rows, plan.res_cols, plan.smem_bytes,
             _build.stream(log_scores))
    _build.check(err, "sinkhorn launch")
    LAUNCHES.count += 1
    return p


def device_plan(n1: int, m1: int, device: torch.device, batch: int = 1) -> SinkhornPlan:
    """:func:`sinkhorn_plan` for ``device``'s SM count; raises if the card
    cannot hold all of its CTAs at once, as the cooperative launch needs
    (asked once per shape, batch and device)."""
    key = (n1, m1, batch, str(device))
    if key not in _resident:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = sinkhorn_plan(n1, m1, sms, batch)
        fn = _build.entry("oip_sinkhorn_resident_ctas", [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
        resident = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(fn(plan.smem_bytes, ctypes.byref(resident)), "sinkhorn occupancy")
        _resident[key] = (plan, resident.value)
    plan, resident = _resident[key]
    if resident < plan.ctas * plan.groups:
        raise RuntimeError(f"the card holds {resident} CTAs of the Sinkhorn kernel at once; "
                           f"its cooperative launch at {batch}x{n1}x{m1} needs "
                           f"{plan.ctas * plan.groups}")
    return plan
