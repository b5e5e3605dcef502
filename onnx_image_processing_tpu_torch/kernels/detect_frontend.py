"""Detect frontend: Shi-Tomasi score, NMS keep mask and orientation moments
in one pass, the same pass without the NMS (the raw score and the moments),
and the pass followed by the premasked block top-k.

Port of ``onnx_image_processing_tpu/kernels/detect_frontend.py``
(``detect_frontend``). On a CUDA tensor :func:`detect_frontend` launches
``csrc/detect_frontend.cu``; on a CPU tensor it runs
:func:`detect_frontend_plain`, the port of ``detect_frontend_reference``.
The TPU kernel's fallback to the XLA composition past its VMEM budget is not
carried over: the CUDA kernel tiles any H x W, in tiles that
:func:`detect_plan` picks on the host.

:func:`detect_select` goes on, in the same launch, to the border-margin and
threshold masks, the block maxima and the K best blocks as keypoints: the
premasked select that ``models/shi_tomasi_family.py`` runs after the detect
frontend. Its plain version is :func:`detect_select_plain`.

:func:`score_moments` is the kernel at NMS radius 0, whose NMS stages are
compiled out: the unmasked Shi-Tomasi score and the moments, bit for bit
``shi_tomasi_score`` and ``angle_moments`` (its plain version,
:func:`score_moments_plain`, calls those two). The unfused Shi-Tomasi
pipelines take their maps from it on a CUDA tensor, in one launch in place
of the stencils' ~200. It counts its launches in ``SCORE_LAUNCHES``
(``score_moments``), the other two in ``LAUNCHES``.

The three functions go through custom ops (``oip::detect_frontend``,
``oip::score_moments``, ``oip::detect_select``), which ``torch.export``
keeps as nodes of its graph. Its ticket
counters are the select kernel's (``_build.ticket_counters``: one set per
device, shared by both kernels, left at 0 by every launch).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import LaunchCounter, _build, use_kernel
from ..ops.filters import moment_taps
from ..ops.keypoints import nms_maxpool, select_topk_keypoints
from ..ops.orientation import angle_moments
from ..ops.shi_tomasi import shi_tomasi_score

LAUNCHES = LaunchCounter("detect_frontend")
SCORE_LAUNCHES = LaunchCounter("score_moments")
MAX_RADIUS = 15  # box radius, NMS radius and moment half-width the kernel takes
SMEM_LIMIT = 232_448      # shared memory one CTA can use on Hopper (bytes)
SMEM_TWO_CTAS = 115_712   # per CTA, so that two share an SM's 228 KB (1 KB each reserved)
H100_SMS = 132            # SMs of an H100 SXM, the plan's default
SMEM_KEYS = 4096          # survivors the select sorts in shared memory (kSmemKeys)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_SELECT_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_plans: dict[tuple, "DetectPlan"] = {}
_host_taps: dict[tuple, np.ndarray] = {}


@dataclass(frozen=True)
class DetectPlan:
    """The kernel's tiles: ny x nx tiles of th x tw output pixels per image
    (whole (rn+1)^2 NMS blocks), one CTA each, each holding its image with
    a ``halo`` pixels deep in ``smem_bytes`` of shared memory."""

    th: int
    tw: int
    ny: int
    nx: int
    halo: int
    smem_bytes: int


def _smem_floats(rb: int, rn: int, half: int, th: int, tw: int) -> int:
    # csrc/detect_frontend.cu smem_floats: the image with its halo, the
    # box's three column-sum maps, the moments' two vertical-pass maps.
    ph = rb + rn
    hi = max(ph + 1, half)
    return ((th + 2 * hi) * (tw + 2 * hi) + 3 * (th + 2 * rn) * (tw + 2 * ph)
            + 2 * th * (tw + 2 * half))


def _tile_cost(th: int, tw: int, rb: int, rn: int, half: int) -> float:
    """Relative cost of one CTA's tile: separately rounded operations and
    shared-memory accesses of each pass over its region, every row's
    columns rounded up to warps of 32 lanes, plus a fixed cost per CTA. At
    NMS radius 0 the kernel has no NMS passes."""
    ph, nt, bw = rb + rn, 2 * half + 1, 2 * rb + 1
    hi = max(ph + 1, half)
    sr = th + 2 * rn

    def lanes(n):
        return -(-n // 32) * 32

    nms = 0 if rn == 0 else (th * lanes(tw + 2 * rn) * (2 * rn + 2)      # NMS column max
                             + th * lanes(tw) * (2 * (2 * rn + 1) + 5))  # row max, keep, store
    return (2 * (th + 2 * hi) * lanes(tw + 2 * hi)              # image load
            + sr * lanes(tw + 2 * ph) * (1.5 * 24 + 3 * bw)     # Sobel products, column sums
            + sr * lanes(tw + 2 * rn) * (4 * bw + 10)           # row sums, lambda_min
            + nms
            + th * lanes(tw + 2 * half) * (4 * nt + 3)          # moments, vertical
            + th * lanes(tw) * 6 * nt                           # moments, horizontal
            + 10_000)


def detect_plan(b: int, h: int, w: int, rb: int, rn: int, half: int,
                sms: int = H100_SMS) -> DetectPlan:
    """The tiles of ``b`` images of ``h`` x ``w`` at box radius ``rb``, NMS
    radius ``rn`` and moment half-width ``half``, on a card with ``sms``
    SMs; needs no card.

    Tiles hold whole (rn+1)^2 blocks, at most 96 x 256 pixels and no more
    blocks than the image has, and fit two CTAs per SM. Of those, the one
    whose busiest SM does the least work: the tiles per SM
    (ceil(CTAs / sms)) times :func:`_tile_cost`; then the most CTAs.
    """
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"empty detect input {b}x{h}x{w}")
    if not all(0 <= r <= MAX_RADIUS for r in (rb, rn, half)):
        raise ValueError(f"box radius, NMS radius and moment half-width must be in "
                         f"0..{MAX_RADIUS}, got {rb}, {rn}, {half}")
    bs = rn + 1
    best, best_key = None, None
    for th in range(bs, min(-(-h // bs) * bs, 96) + 1, bs):
        for tw in range(bs, min(-(-w // bs) * bs, 256) + 1, bs):
            smem = 4 * _smem_floats(rb, rn, half, th, tw)
            if smem > SMEM_TWO_CTAS:
                break
            ny, nx = -(-h // th), -(-w // tw)
            ctas = b * ny * nx
            key = (-(-ctas // sms) * _tile_cost(th, tw, rb, rn, half), -ctas)
            if best_key is None or key < best_key:
                best, best_key = DetectPlan(th, tw, ny, nx, max(rb + rn + 1, half), smem), key
    if best is None:
        raise ValueError(f"no tile of whole {bs}x{bs} blocks fits shared memory at radii "
                         f"{rb}, {rn}, {half}")
    return best


def device_plan(b: int, h: int, w: int, rb: int, rn: int, half: int,
                device: torch.device) -> DetectPlan:
    """:func:`detect_plan` for ``device``'s SM count (asked once per shape
    and device)."""
    key = (b, h, w, rb, rn, half, str(device))
    plan = _plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = _plans[key] = detect_plan(b, h, w, rb, rn, half, sms)
    return plan


def detect_frontend_plain(image: torch.Tensor, block_size: int = 3,
                          patch_size: int = 15, sigma: float = 2.5,
                          nms_radius: int = 5, with_angle: bool = True):
    """Plain PyTorch version of the kernel: same contract."""
    scores = shi_tomasi_score(image, block_size=block_size)[:, 0]
    masked = (scores * nms_maxpool(scores, nms_radius))[:, None]
    if not with_angle:
        return masked, None, None
    m10, m01 = angle_moments(image, patch_size=patch_size, sigma=sigma)
    return masked, m10, m01


def score_moments_plain(image: torch.Tensor, block_size: int = 3, patch_size: int = 15,
                        sigma: float = 2.5, with_angle: bool = True):
    """Plain PyTorch version of :func:`score_moments`: the Shi-Tomasi and
    moment stencils it replaces."""
    scores = shi_tomasi_score(image, block_size=block_size)
    if not with_angle:
        return scores, None, None
    m10, m01 = angle_moments(image, patch_size=patch_size, sigma=sigma)
    return scores, m10, m01


def detect_select_plain(image: torch.Tensor, block_size: int = 3, patch_size: int = 15,
                        sigma: float = 2.5, nms_radius: int = 5, max_keypoints: int = 512,
                        score_threshold: float = 0.0, border_margin: int = 0,
                        with_angle: bool = True):
    """Plain PyTorch version of :func:`detect_select`: the plain detect
    frontend, then the premasked block select (``select_topk_keypoints``
    with an all-ones NMS mask, as ``_select_premasked`` runs it)."""
    masked, m10, m01 = detect_frontend_plain(image, block_size, patch_size, sigma,
                                             nms_radius, with_angle)
    m = masked[:, 0]
    kpts, kscores = select_topk_keypoints(m, torch.ones_like(m), max_keypoints,
                                          score_threshold, border_margin,
                                          nms_radius=nms_radius)
    return kpts, kscores, masked, m10, m01


def _check(image: torch.Tensor, block_size: int, patch_size: int, sigma: float,
           nms_radius: int) -> tuple[int, int]:
    """Raise on what the kernel does not take; return (rb, half)."""
    if image.dtype != torch.float32 or image.dim() != 4 or image.shape[1] != 1:
        raise ValueError(f"image must be (B, 1, H, W) float32, got "
                         f"{tuple(image.shape)} {image.dtype}")
    if not image.is_contiguous():
        raise ValueError("image must be contiguous")
    if block_size <= 0 or block_size % 2 == 0 or patch_size % 2 == 0 or sigma <= 0:
        raise ValueError("block_size and patch_size must be odd and positive, "
                         "sigma positive")
    rb, half = block_size // 2, patch_size // 2
    if max(rb, nms_radius, half) > MAX_RADIUS or nms_radius < 0:
        raise ValueError(f"block_size // 2, nms_radius and patch_size // 2 must "
                         f"be in 0..{MAX_RADIUS}, got {rb}, {nms_radius}, {half}")
    return rb, half


def _taps(sigma: float, patch_size: int) -> np.ndarray:
    """The moment taps g, then t*g, in host memory: the kernel takes them by
    value in its launch parameters."""
    key = (float(sigma), int(patch_size))
    taps = _host_taps.get(key)
    if taps is None:
        taps = _host_taps[key] = np.ascontiguousarray(
            np.concatenate(moment_taps(sigma, patch_size)), dtype=np.float32)
    return taps


def _maps(image: torch.Tensor, with_angle: bool):
    """The three output maps; without the angle the moments are empty
    (B, 1, 0, 0): an op returns tensors only."""
    b, _, h, w = image.shape
    score = image.new_empty((b, 1, h, w))
    mh, mw = (h, w) if with_angle else (0, 0)
    return score, image.new_empty((b, 1, mh, mw)), image.new_empty((b, 1, mh, mw))


def _no_angle(image: torch.Tensor, with_angle: bool, m10, m01):
    """The plain version's moments as the op returns them."""
    if with_angle:
        return m10, m01
    b = image.shape[0]
    return image.new_empty((b, 1, 0, 0)), image.new_empty((b, 1, 0, 0))


def detect_frontend(image: torch.Tensor, block_size: int = 3,
                    patch_size: int = 15, sigma: float = 2.5,
                    nms_radius: int = 5, with_angle: bool = True):
    """Shi-Tomasi score times its NMS keep mask, and the orientation moments.

    Args:
        image: (B, 1, H, W) float32.

    Returns:
        ``(masked_score, m10, m01)``, each (B, 1, H, W): ``masked_score`` is
        ``shi_tomasi_score * nms_mask`` (replicate padding for the score, -inf
        outside the image for the NMS window); m10/m01 are the zero-padded
        Gaussian moments whose atan2 at a keypoint is its orientation. m10
        and m01 are None when ``with_angle`` is False.
    """
    score, m10, m01 = detect_frontend_op(image, int(block_size), int(patch_size),
                                         float(sigma), int(nms_radius), bool(with_angle))
    return (score, m10, m01) if with_angle else (score, None, None)


@torch.library.custom_op("oip::detect_frontend", mutates_args=())
def detect_frontend_op(image: torch.Tensor, block_size: int, patch_size: int, sigma: float,
                       nms_radius: int,
                       with_angle: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op behind :func:`detect_frontend` (the moments (B, 1, 0, 0)
    without the angle): the plain version on a CPU tensor, one launch of
    the kernel on a CUDA tensor."""
    if not use_kernel(image):
        score, m10, m01 = detect_frontend_plain(image, block_size, patch_size, sigma,
                                                nms_radius, with_angle)
        return (score, *_no_angle(image, with_angle, m10, m01))
    maps = _launch_detect(image, block_size, patch_size, sigma, nms_radius, with_angle,
                          "detect_frontend launch")
    LAUNCHES.count += 1
    return maps


def _launch_detect(image: torch.Tensor, block_size: int, patch_size: int, sigma: float,
                   nms_radius: int, with_angle: bool, what: str):
    """One launch of ``oip_detect_frontend``: the three maps."""
    rb, half = _check(image, block_size, patch_size, sigma, nms_radius)
    b, _, h, w = image.shape
    rn = nms_radius
    plan = device_plan(b, h, w, rb, rn, half, image.device)
    score, m10, m01 = _maps(image, with_angle)
    taps = _taps(sigma, patch_size)
    fn = _build.entry("oip_detect_frontend", _ARGTYPES)
    # Without the angle the kernel reads no taps and writes no moments (NULL).
    moments = (_build.ptr(m10), _build.ptr(m01)) if with_angle else (None, None)
    with torch.cuda.device(image.device):
        err = fn(_build.ptr(image), taps.ctypes.data_as(ctypes.c_void_p) if with_angle else None,
                 _build.ptr(score), *moments, b, h, w, rb, rn, half, int(with_angle),
                 plan.th, plan.tw, _build.stream(image))
    _build.check(err, what)
    return score, m10, m01


@detect_frontend_op.register_fake
def _(image, block_size, patch_size, sigma, nms_radius, with_angle):
    return _maps(image, with_angle)


def score_moments(image: torch.Tensor, block_size: int = 3, patch_size: int = 15,
                  sigma: float = 2.5, with_angle: bool = True):
    """The unmasked Shi-Tomasi score and the orientation moments.

    Args:
        image: (B, 1, H, W) float32.

    Returns:
        ``(score, m10, m01)``, each (B, 1, H, W): ``shi_tomasi_score(image,
        block_size)`` and ``angle_moments(image, patch_size, sigma)`` bit for
        bit. m10 and m01 are None when ``with_angle`` is False.
    """
    score, m10, m01 = score_moments_op(image, int(block_size), int(patch_size), float(sigma),
                                       bool(with_angle))
    return (score, m10, m01) if with_angle else (score, None, None)


@torch.library.custom_op("oip::score_moments", mutates_args=())
def score_moments_op(image: torch.Tensor, block_size: int, patch_size: int, sigma: float,
                     with_angle: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op behind :func:`score_moments` (the moments (B, 1, 0, 0)
    without the angle): the plain stencils on a CPU tensor, one launch of
    the detect kernel at NMS radius 0 on a CUDA tensor."""
    if not use_kernel(image):
        score, m10, m01 = score_moments_plain(image, block_size, patch_size, sigma, with_angle)
        return (score, *_no_angle(image, with_angle, m10, m01))
    if not with_angle:   # no moments: a halo for the box alone, patch and sigma unread
        patch_size, sigma = 1, 1.0
    maps = _launch_detect(image, block_size, patch_size, sigma, 0, with_angle,
                          "score_moments launch")
    SCORE_LAUNCHES.count += 1
    return maps


@score_moments_op.register_fake
def _(image, block_size, patch_size, sigma, with_angle):
    return _maps(image, with_angle)


def detect_select(image: torch.Tensor, block_size: int = 3, patch_size: int = 15,
                  sigma: float = 2.5, nms_radius: int = 5, max_keypoints: int = 512,
                  score_threshold: float = 0.0, border_margin: int = 0,
                  with_angle: bool = True):
    """:func:`detect_frontend`, then in the same launch the premasked block
    select: the border-margin and threshold masks on the masked score, each
    (r+1)^2 block's max and the minimum raster index of it, and the
    ``max_keypoints`` largest block maxima of each image (equal values
    lowest block index first), decoded to keypoints.

    Args:
        image: (B, 1, H, W) float32.
        nms_radius: r >= 1.
        max_keypoints: K, 1 <= K <= Hb * Wb (the block grid).

    Returns:
        ``(keypoints (B, K, 2) f32 (y, x), scores (B, K), masked_score, m10,
        m01)``: a slot whose block max is <= 0 is (-1, -1) with score 0; the
        maps are :func:`detect_frontend`'s.
    """
    kpts, kscores, score, m10, m01 = detect_select_op(
        image, int(block_size), int(patch_size), float(sigma), int(nms_radius),
        int(max_keypoints), float(score_threshold), int(border_margin), bool(with_angle))
    return (kpts, kscores, score, m10, m01) if with_angle else (kpts, kscores, score, None, None)


@torch.library.custom_op("oip::detect_select", mutates_args=())
def detect_select_op(image: torch.Tensor, block_size: int, patch_size: int, sigma: float,
                     nms_radius: int, max_keypoints: int, score_threshold: float,
                     border_margin: int, with_angle: bool
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The op behind :func:`detect_select` (the moments (B, 1, 0, 0)
    without the angle): the plain version on a CPU tensor, one launch of
    the kernel on a CUDA tensor. The ticket counters are internal state
    that every launch leaves at 0, not an argument."""
    if not use_kernel(image):
        kpts, kscores, score, m10, m01 = detect_select_plain(
            image, block_size, patch_size, sigma, nms_radius, max_keypoints,
            score_threshold, border_margin, with_angle)
        return (kpts, kscores, score, *_no_angle(image, with_angle, m10, m01))
    rb, half = _check(image, block_size, patch_size, sigma, nms_radius)
    rn, k = nms_radius, max_keypoints
    if rn < 1:
        raise ValueError(f"detect_select needs nms_radius >= 1, got {rn}")
    b, _, h, w = image.shape
    bs = rn + 1
    hb, wb = -(-h // bs), -(-w // bs)
    if not 1 <= k <= hb * wb:
        raise ValueError(f"max_keypoints must be in 1..{hb * wb} (the block grid), got {k}")
    if (hb * bs) * w + wb * bs >= 2 ** 31:
        raise ValueError(f"a {h}x{w} map overflows int32 raster indices")
    dev = image.device
    plan = device_plan(b, h, w, rb, rn, half, dev)
    score, m10, m01 = _maps(image, with_angle)
    block_max = torch.empty((b, hb, wb), dtype=torch.float32, device=dev)
    block_idx = torch.empty((b, hb, wb), dtype=torch.int32, device=dev)
    kpts = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    kscores = torch.empty((b, k), dtype=torch.float32, device=dev)
    p2 = 1 << (k - 1).bit_length()
    keys = (torch.empty((b, p2), dtype=torch.int64, device=dev) if p2 > SMEM_KEYS
            else None)
    counters = _build.ticket_counters(dev, b, "detect_select")
    taps = _taps(sigma, patch_size)
    fn = _build.entry("oip_detect_select", _SELECT_ARGTYPES)
    moments = (_build.ptr(m10), _build.ptr(m01)) if with_angle else (None, None)
    with torch.cuda.device(image.device):
        err = fn(_build.ptr(image), taps.ctypes.data_as(ctypes.c_void_p) if with_angle else None,
                 _build.ptr(score), *moments, _build.ptr(block_max), _build.ptr(block_idx),
                 _build.ptr(counters), None if keys is None else _build.ptr(keys),
                 _build.ptr(kpts), _build.ptr(kscores), b, h, w, rb, rn, half, int(with_angle),
                 plan.th, plan.tw, border_margin, score_threshold, k,
                 0 if keys is None else p2, _build.stream(image))
    _build.check(err, "detect_select launch")
    LAUNCHES.count += 1
    return kpts, kscores, score, m10, m01


@detect_select_op.register_fake
def _(image, block_size, patch_size, sigma, nms_radius, max_keypoints, score_threshold,
      border_margin, with_angle):
    b = image.shape[0]
    return (image.new_empty((b, max_keypoints, 2)), image.new_empty((b, max_keypoints)),
            *_maps(image, with_angle))
