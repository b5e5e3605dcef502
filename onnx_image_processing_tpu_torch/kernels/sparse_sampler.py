"""Sparse BAD box sampler: S box means per keypoint.

Port of ``onnx_image_processing_tpu/kernels/sparse_sampler.py``
(``sparse_box_sample``). On a CUDA tensor :func:`box_sample` launches
``csrc/sparse_sampler.cu``; on a CPU tensor it runs :func:`box_sample_plain`,
the port of ``reference_box_sample``. The TPU kernel's DMA alignment, MXU
interval-mask contraction and bf16x3 operand split are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, _build, use_kernel

LAUNCHES = LaunchCounter("sparse_sampler")


def box_sample_plain(image_padded: torch.Tensor, start_y: torch.Tensor,
                     start_x: torch.Tensor, ly: torch.Tensor, lx: torch.Tensor,
                     radius: torch.Tensor, groups: tuple, ps: int, r_max: int,
                     bilinear: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same contract as :func:`box_sample`.

    Cuts each keypoint's psi x psi window, builds the radius-r box-mean bank
    of every group by shift-and-add (x, then y), and reads the bank at the
    sample coordinates: one tap in nearest mode, two per axis in bilinear.
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
            bank = bank / float((2 * r + 1) ** 2)
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
    out = torch.empty((b, k, s), dtype=torch.float32, device=image_padded.device)
    fn = _build.entry("oip_sparse_sampler", [ctypes.c_void_p] * 7
                      + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    err = fn(_build.ptr(image_padded), _build.ptr(start_y), _build.ptr(start_x),
             _build.ptr(ly), _build.ptr(lx), _build.ptr(radius), _build.ptr(out),
             b, k, s, hp, wp, ps, r_max, int(bilinear),
             _build.stream(image_padded))
    _build.check(err, "sparse_sampler launch")
    LAUNCHES.count += 1
    return out
