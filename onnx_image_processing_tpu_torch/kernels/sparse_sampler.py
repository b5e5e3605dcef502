"""Sparse BAD box sampler: S box means per keypoint.

Port of ``onnx_image_processing_tpu/kernels/sparse_sampler.py``
(``sparse_box_sample``). On a CUDA tensor :func:`box_sample` launches
``csrc/sparse_sampler.cu``; on a CPU tensor it runs :func:`box_sample_plain`,
the port of ``reference_box_sample``. The TPU kernel's DMA alignment, MXU
interval-mask contraction and bf16x3 operand split are not carried over.

:func:`box_sample_ablated` is the port of ``benchmarks/ablate_sampler.py``:
the same kernel with some of its own stages skipped (:data:`STAGES`), so
that the time each variant saves attributes the kernel's cost.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LaunchCounter, _build, use_kernel

LAUNCHES = LaunchCounter("sparse_sampler")
ABLATE_LAUNCHES = LaunchCounter("sparse_sampler_ablate")

# Stages of the CUDA kernel that the ablation can skip, and their bits in
# the kernel's skip mask (csrc/sparse_sampler.cu).
STAGES = {"load": 1, "boxsum": 2, "store": 4}
WARPS = 8   # warps per CTA of the kernel (kWarps); sampler_plan deals to them
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_ABLATE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
_plans: dict[tuple, torch.Tensor] = {}


def box_sample_plain(image_padded: torch.Tensor, start_y: torch.Tensor,
                     start_x: torch.Tensor, ly: torch.Tensor, lx: torch.Tensor,
                     radius: torch.Tensor, groups: tuple, ps: int, r_max: int,
                     bilinear: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same contract as :func:`box_sample`.

    Cuts each keypoint's psi x psi window, builds the radius-r box-mean bank
    of every group by shift-and-add (x, then y), and reads the bank at the
    sample coordinates: one tap in nearest mode, two per axis in bilinear.
    The box sum is divided by its area held as a tensor on the window's
    device: PyTorch's CUDA division by a Python number multiplies by the
    reciprocal, which may differ from the kernel's true division in the last
    bit.
    """
    b, k, s = ly.shape
    psi = ps + 2 * r_max
    hp, wp = image_padded.shape[-2:]
    dev = image_padded.device
    # Origins clamped so the window fits, as jax.lax.dynamic_slice does.
    y0 = start_y.long().clamp(0, hp - psi)
    x0 = start_x.long().clamp(0, wp - psi)
    span = torch.arange(psi, device=dev)
    rows = (y0[..., None] + span)[..., :, None]             # (B, K, psi, 1)
    cols = (x0[..., None] + span)[..., None, :]             # (B, K, 1, psi)
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    patches = image_padded[bidx, rows, cols]                # (B, K, psi, psi)

    last = float(ps - 1)
    out = torch.empty((b, k, s), dtype=torch.float32, device=dev)
    for (r, lo, hi) in groups:
        m = r_max - r
        side = ps + 2 * r
        sub = patches[:, :, m:m + side, m:m + side]
        acc = sub[..., :, 0:ps]
        for dx in range(1, 2 * r + 1):
            acc = acc + sub[..., :, dx:dx + ps]
        bank = acc[..., 0:ps, :]
        for dy in range(1, 2 * r + 1):
            bank = bank + acc[..., dy:dy + ps, :]
        if r > 0:
            bank = bank / torch.full((), float((2 * r + 1) ** 2), device=dev)
        flat = bank.reshape(b, k, ps * ps)

        def tap(iy, ix):
            return torch.gather(flat, 2, iy * ps + ix)

        gy, gx = ly[:, :, lo:hi], lx[:, :, lo:hi]
        if not bilinear:
            iy = torch.round(gy.clamp(0.0, last)).long()
            ix = torch.round(gx.clamp(0.0, last)).long()
            out[:, :, lo:hi] = tap(iy, ix)
            continue
        fy, fx = torch.floor(gy), torch.floor(gx)
        wy, wx = gy - fy, gx - fx
        y_lo = fy.clamp(0.0, last).long()
        y_hi = (fy + 1.0).clamp(0.0, last).long()
        x_lo = fx.clamp(0.0, last).long()
        x_hi = (fx + 1.0).clamp(0.0, last).long()
        col_lo = (1.0 - wy) * tap(y_lo, x_lo) + wy * tap(y_hi, x_lo)
        col_hi = (1.0 - wy) * tap(y_lo, x_hi) + wy * tap(y_hi, x_hi)
        out[:, :, lo:hi] = (1.0 - wx) * col_lo + wx * col_hi
    return out


def box_sample(image_padded: torch.Tensor, start_y: torch.Tensor,
               start_x: torch.Tensor, ly: torch.Tensor, lx: torch.Tensor,
               radius: torch.Tensor, groups: tuple, ps: int, r_max: int,
               bilinear: bool = False) -> torch.Tensor:
    """Per-keypoint box means; returns (B, K, S) float32.

    Args:
        image_padded: (B, H + 2 r_max, W + 2 r_max) float32, replicate-padded.
        start_y, start_x: (B, K) int32 window origins (padded coordinates).
        ly, lx: (B, K, S) float32 in-window sample coordinates in [0, ps-1].
        radius: (S,) int32 box radius of each sample, constant on each
            ``groups`` slice.
        groups: ((radius, lo, hi), ...) contiguous slices of the sample axis.
        ps: sample window size; r_max: largest radius (the padding).
        bilinear: two taps per axis instead of the nearest cell.
    """
    if not use_kernel(image_padded):
        return box_sample_plain(image_padded, start_y, start_x, ly, lx, radius,
                                groups, ps, r_max, bilinear)
    out = _checked_output(image_padded, start_y, start_x, ly, lx, radius, ps, r_max)
    plan = _device_plan(groups, ly.shape[2], image_padded.device)
    fn = _build.entry("oip_sparse_sampler", _ARGTYPES)
    err = fn(*_pointers(image_padded, start_y, start_x, ly, lx, plan, out),
             *_dims(image_padded, ly), ps, r_max, int(bilinear), _build.stream(image_padded))
    _build.check(err, "sparse_sampler launch")
    LAUNCHES.count += 1
    return out


def box_sample_ablated(image_padded: torch.Tensor, start_y: torch.Tensor,
                       start_x: torch.Tensor, ly: torch.Tensor, lx: torch.Tensor,
                       radius: torch.Tensor, groups: tuple, ps: int, r_max: int,
                       bilinear: bool = False, skip=(),
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`box_sample` with the kernel stages in ``skip`` left out (a
    subset of :data:`STAGES`); ``skip=()`` is the production kernel.

    'load' fills each window from the thread index instead of the image,
    'boxsum' reads each box at its centre cell instead of summing it,
    'store' computes every sample and stores none. ``out`` (B, K, S) float32
    receives the samples (a new buffer if None), so a caller can see that
    'store' left it untouched.

    On a CPU tensor only the variants with a plain definition run:
    ``skip=()`` is :func:`box_sample_plain`, ``skip=("boxsum",)`` is
    :func:`box_sample_plain` with every group's radius set to 0 (the
    centre cell).
    """
    unknown = set(skip) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}; stages are {list(STAGES)}")
    if not use_kernel(image_padded):
        if set(skip) - {"boxsum"}:
            raise ValueError(f"skip={tuple(skip)} has no plain version; only () and "
                             "('boxsum',) run on the CPU")
        if "boxsum" in skip:
            groups = tuple((0, lo, hi) for (_, lo, hi) in groups)
        result = box_sample_plain(image_padded, start_y, start_x, ly, lx, radius,
                                  groups, ps, r_max, bilinear)
        if out is None:
            return result
        return out.copy_(result)
    checked = _checked_output(image_padded, start_y, start_x, ly, lx, radius, ps, r_max)
    if out is None:
        out = checked
    elif (out.device != image_padded.device or out.dtype != torch.float32
          or out.shape != checked.shape or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {tuple(checked.shape)} float32 "
                         f"tensor on {image_padded.device}")
    mask = sum(STAGES[name] for name in set(skip))
    plan = _device_plan(groups, ly.shape[2], image_padded.device)
    fn = _build.entry("oip_sparse_sampler_ablate", _ABLATE_ARGTYPES)
    err = fn(*_pointers(image_padded, start_y, start_x, ly, lx, plan, out),
             *_dims(image_padded, ly), ps, r_max, int(bilinear), mask, float("nan"),
             _build.stream(image_padded))
    _build.check(err, "sparse_sampler_ablate launch")
    ABLATE_LAUNCHES.count += 1
    return out


def sampler_plan(groups: tuple) -> np.ndarray:
    """The kernel's work plan: how the samples of one keypoint are dealt to
    the :data:`WARPS` warps of its CTA. Needs no card.

    A task is up to 32 consecutive samples of one radius group, one a lane,
    so no warp straddles two radii. Tasks go largest box first, each to the
    warp with the least work so far (the lowest such warp on a tie); a
    task's work is its box's (2r+1)^2 loads. Returns int32: the
    ``WARPS + 1`` offsets of each
    warp's tasks, then the tasks as (radius, first sample, count) triples.
    """
    tasks = [(r, a, min(32, hi - a)) for (r, lo, hi) in groups for a in range(lo, hi, 32)]
    load = [0] * WARPS
    dealt: list[list] = [[] for _ in range(WARPS)]
    for task in sorted(tasks, key=lambda t: -t[0]):   # stable: ties keep their order
        w = load.index(min(load))
        dealt[w].append(task)
        load[w] += (2 * task[0] + 1) ** 2
    offsets = np.cumsum([0] + [len(d) for d in dealt])
    flat = [v for d in dealt for task in d for v in task]
    return np.concatenate([offsets, flat]).astype(np.int32)


def _device_plan(groups: tuple, s: int, device: torch.device) -> torch.Tensor:
    """:func:`sampler_plan` on ``device``, made and copied there once;
    ``groups`` must tile the sample axis 0..s."""
    key = (groups, s, str(device))
    plan = _plans.get(key)
    if plan is None:
        bounds = [0] + [v for (_, lo, hi) in groups for v in (lo, hi)] + [s]
        if bounds[0::2] != bounds[1::2]:
            raise ValueError(f"groups {groups} do not tile the {s} samples")
        plan = _plans[key] = torch.from_numpy(sampler_plan(groups)).to(device)
    return plan


def _pointers(*tensors: torch.Tensor) -> list:
    return [t.data_ptr() for t in tensors]


def _dims(image_padded: torch.Tensor, ly: torch.Tensor) -> tuple:
    """(b, k, s, hp, wp) of a launch."""
    b, hp, wp = image_padded.shape
    return b, ly.shape[1], ly.shape[2], hp, wp


def _checked_output(image_padded: torch.Tensor, start_y: torch.Tensor,
                    start_x: torch.Tensor, ly: torch.Tensor, lx: torch.Tensor,
                    radius: torch.Tensor, ps: int, r_max: int) -> torch.Tensor:
    """Check the kernel's inputs (device, type, shape, contiguity, window
    size) and return a new (B, K, S) float32 output buffer."""
    b, hp, wp = image_padded.shape
    k, s = ly.shape[1], ly.shape[2]
    psi = ps + 2 * r_max
    expect = {
        "image_padded": (image_padded, torch.float32, (b, hp, wp)),
        "start_y": (start_y, torch.int32, (b, k)),
        "start_x": (start_x, torch.int32, (b, k)),
        "ly": (ly, torch.float32, (b, k, s)),
        "lx": (lx, torch.float32, (b, k, s)),
        "radius": (radius, torch.int32, (s,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != image_padded.device:
            raise ValueError(f"{name} is on {t.device}, image on {image_padded.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hp < psi or wp < psi:
        raise ValueError(f"padded image {hp}x{wp} is smaller than the "
                         f"{psi}x{psi} sample window")
    if psi * psi * 4 > 48 * 1024:
        raise ValueError(f"a {psi}x{psi} window exceeds 48 KB of shared memory")
    return torch.empty((b, k, s), dtype=torch.float32, device=image_padded.device)
