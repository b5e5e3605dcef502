"""AKAZE scale ladder: FED diffusion, Hessian NMS score and orientation
moments of every scale.

Port of ``onnx_image_processing_tpu/kernels/akaze_ladder.py``
(``akaze_ladder``). On a CUDA tensor :func:`akaze_ladder` launches
``csrc/akaze_ladder.cu``; on a CPU tensor it runs :func:`akaze_ladder_plain`,
the port of ``akaze_ladder_reference``, built from ``ops/akaze.py``. The
kernel rounds every multiply and add on its own, in the plain version's
order, so on the card the two agree bit for bit. Both go through the custom
op ``oip::akaze_ladder``, which ``torch.export`` keeps as one node of its
graph.

The kernel has two routes, picked by :func:`ladder_plan` from the shape:
one cooperative launch whose CTAs each keep a tile of the diffusion state
in shared memory for the whole ladder (where the tiles fit the card's
shared memory), or one launch per FED step and per scale with the state
in device memory.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import LaunchCounter, _build, use_kernel
from ..ops.akaze import hessian_score, nonlinear_diffusion
from ..ops.filters import moment_taps
from ..ops.orientation import angle_moments

LAUNCHES = LaunchCounter("akaze_ladder")
MAX_RADIUS = 15  # the kernel's tiles fit an NMS radius and moment half-width up to 15
SMEM_LIMIT = 232_448     # shared memory one CTA can use on Hopper (bytes)
H100_SMS = 132           # SMs of an H100 SXM, the plan's default
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_RESIDENT_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 6
                      + [ctypes.c_void_p])
_resident: dict[tuple, tuple] = {}   # (b, h, w, nr, half, device) -> (plan, CTAs the card holds)


@dataclass(frozen=True)
class LadderPlan:
    """The kernel's route. ``"resident"``: one cooperative launch of
    b x ny x nx CTAs, CTA (ty, tx) of an image keeping tile (ty, tx) of its
    state, with a ``halo`` pixels deep, in ``smem_bytes`` of shared memory,
    and computing each scale's outputs in chunks of ``out_rows`` rows.
    ``"global"``: one launch per FED step and per scale (ny = nx = 0)."""

    route: str
    ny: int
    nx: int
    halo: int
    out_rows: int
    smem_bytes: int

    def tiles(self, h: int, w: int) -> list[tuple[int, int, int, int]]:
        """``(y0, y1, x0, x1)`` of every tile of one image (balanced spans)."""
        return [(ty * h // self.ny, (ty + 1) * h // self.ny,
                 tx * w // self.nx, (tx + 1) * w // self.nx)
                for ty in range(self.ny) for tx in range(self.nx)]


def ladder_halo(nms_radius: int, half: int) -> int:
    """Halo of L a tile keeps: the FED step's 2, the Hessian response's
    nms_radius + 1 and the moments' half-width."""
    return max(2, nms_radius + 1, half)


def _resident_floats(th: int, tw: int, nms_radius: int, half: int, oc: int) -> int:
    # csrc/akaze_ladder.cu resident_floats: L with its halo; the fluxes of a
    # FED step or one chunk of oc rows of the scale outputs, in turn; the taps.
    hh, nr = ladder_halo(nms_radius, half), nms_radius
    out = (oc + 2 * nr) * (tw + 2 * nr) + (oc + 2 * nr) * tw + 2 * oc * (tw + 2 * half)
    return ((th + 2 * hh) * (tw + 2 * hh) + max(2 * (th + 2) * (tw + 2), out)
            + 2 * (2 * half + 1))


def ladder_plan(b: int, h: int, w: int, sms: int = H100_SMS,
                smem_per_cta: int = SMEM_LIMIT, nms_radius: int = 2,
                half: int = 7) -> LadderPlan:
    """The kernel's route for ``b`` images of ``h`` x ``w`` on a card with
    ``sms`` SMs and ``smem_per_cta`` bytes of shared memory a CTA; needs no
    card.

    Resident when some grid of ny x nx tiles per image fits: at most ``sms``
    CTAs in all (one per SM, all resident at once), every tile but a sole
    one along its axis at least the halo deep (a tile's halo then lies in
    its 8 neighbours), and each tile's shared memory within
    ``smem_per_cta`` with its scale outputs in chunks of at least
    ``min(tile rows, 16)`` rows. Of those, the one whose CTAs hold the fewest
    floats of L with its halo (the per-CTA work), then the most CTAs; its
    chunks as tall as shared memory allows (a chunk of 4-row groups keeps
    more threads busy). Else global.
    """
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"empty ladder input {b}x{h}x{w}")
    if not (0 <= nms_radius <= MAX_RADIUS and 0 <= half <= MAX_RADIUS):
        raise ValueError(f"nms radius and moment half-width must be in 0..{MAX_RADIUS}, "
                         f"got {nms_radius}, {half}")
    hh = ladder_halo(nms_radius, half)
    best, best_key = None, None
    for ny in range(1, min(h, sms // b) + 1):
        if ny > 1 and h // ny < hh:
            break
        for nx in range(1, min(w, sms // (b * ny)) + 1):
            if nx > 1 and w // nx < hh:
                break
            th, tw = -(-h // ny), -(-w // nx)
            fits = [oc for oc in range(th, min(th, 16) - 1, -1)
                    if 4 * _resident_floats(th, tw, nms_radius, half, oc) <= smem_per_cta]
            if not fits:
                continue
            key = ((th + 2 * hh) * (tw + 2 * hh), -ny * nx)
            if best_key is None or key < best_key:
                smem = 4 * _resident_floats(th, tw, nms_radius, half, fits[0])
                best, best_key = LadderPlan("resident", ny, nx, hh, fits[0], smem), key
    return best if best is not None else LadderPlan("global", 0, 0, hh, 0, 0)


def device_plan(b: int, h: int, w: int, nms_radius: int, half: int,
                device: torch.device) -> LadderPlan:
    """:func:`ladder_plan` for ``device``'s SM count; for the resident route,
    raises if the card cannot hold all of its CTAs at once, as the
    cooperative launch needs (asked once per shape and device)."""
    key = (b, h, w, nms_radius, half, str(device))
    if key not in _resident:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = ladder_plan(b, h, w, sms, SMEM_LIMIT, nms_radius, half)
        resident = 0
        if plan.route == "resident":
            fn = _build.entry("oip_akaze_ladder_resident_ctas",
                              [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
            count = ctypes.c_int(0)
            with torch.cuda.device(device):
                _build.check(fn(half, plan.smem_bytes, ctypes.byref(count)),
                             "akaze_ladder occupancy")
            resident = count.value
        _resident[key] = (plan, resident)
    plan, resident = _resident[key]
    if plan.route == "resident" and resident < b * plan.ny * plan.nx:
        raise RuntimeError(f"the card holds {resident} CTAs of the AKAZE ladder kernel at "
                           f"once; its cooperative launch at {b}x{h}x{w} needs "
                           f"{b * plan.ny * plan.nx}")
    return plan


def akaze_ladder_plain(image: torch.Tensor, num_scales: int = 3,
                       diffusion_iterations: int = 3, kappa: float = 0.05,
                       threshold: float = 0.001, nms_size: int = 5,
                       orientation_patch_size: int = 15,
                       orientation_sigma: float = 2.5):
    """Plain PyTorch version of the kernel: same contract."""
    current = image.to(torch.float32)[:, None]
    scores, m10s, m01s = [], [], []
    for _ in range(num_scales):
        current = nonlinear_diffusion(current, num_iterations=diffusion_iterations,
                                      kappa=kappa)
        scores.append(hessian_score(current, threshold=threshold,
                                    nms_size=nms_size)[:, 0])
        m10, m01 = angle_moments(current, orientation_patch_size, orientation_sigma)
        m10s.append(m10[:, 0])
        m01s.append(m01[:, 0])
    return (torch.stack(scores, 1), torch.stack(m10s, 1), torch.stack(m01s, 1))


def akaze_ladder(image: torch.Tensor, num_scales: int = 3,
                 diffusion_iterations: int = 3, kappa: float = 0.05,
                 threshold: float = 0.001, nms_size: int = 5,
                 orientation_patch_size: int = 15,
                 orientation_sigma: float = 2.5):
    """Per-scale AKAZE maps. The diffusion state carries from one scale to
    the next: scale s is ``diffusion_iterations`` FED steps after scale s-1.

    Args:
        image: (B, H, W) float32.

    Returns:
        ``(scores, m10, m01)``, each (B, num_scales, H, W): the thresholded
        Hessian NMS score and the Gaussian orientation moments of every
        scale; the angle is atan2(m01, m10), taken by the caller.
    """
    return akaze_ladder_op(image, int(num_scales), int(diffusion_iterations), float(kappa),
                           float(threshold), int(nms_size), int(orientation_patch_size),
                           float(orientation_sigma))


@torch.library.custom_op("oip::akaze_ladder", mutates_args=())
def akaze_ladder_op(image: torch.Tensor, num_scales: int, diffusion_iterations: int,
                    kappa: float, threshold: float, nms_size: int,
                    orientation_patch_size: int, orientation_sigma: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op behind :func:`akaze_ladder`: the plain version on a CPU
    tensor, one launch of the kernel on a CUDA tensor (either route)."""
    if not use_kernel(image):
        return akaze_ladder_plain(image, num_scales, diffusion_iterations, kappa,
                                  threshold, nms_size, orientation_patch_size,
                                  orientation_sigma)
    if image.dtype != torch.float32 or image.dim() != 3:
        raise ValueError(f"image must be (B, H, W) float32, got "
                         f"{tuple(image.shape)} {image.dtype}")
    if not image.is_contiguous():
        raise ValueError("image must be contiguous")
    if num_scales < 1 or diffusion_iterations < 0:
        raise ValueError(f"need num_scales >= 1 and diffusion_iterations >= 0, "
                         f"got {num_scales}, {diffusion_iterations}")
    if orientation_patch_size % 2 == 0 or orientation_sigma <= 0:
        raise ValueError("orientation_patch_size must be odd and sigma positive")
    nms_radius, half = nms_size // 2, orientation_patch_size // 2
    if nms_radius > MAX_RADIUS or half > MAX_RADIUS:
        raise ValueError(f"nms_size // 2 and orientation_patch_size // 2 must be "
                         f"<= {MAX_RADIUS}, got {nms_radius}, {half}")
    b, h, w = image.shape
    dev = image.device
    plan = device_plan(b, h, w, nms_radius, half, dev)
    scores, m10, m01 = (torch.empty((b, num_scales, h, w), dtype=torch.float32,
                                    device=dev) for _ in range(3))
    # The resident route's mirror of the state, or the global route's two
    # state buffers: (2, B, H, W) either way.
    state = torch.empty((2, b, h, w), dtype=torch.float32, device=dev)
    host_taps = np.concatenate(moment_taps(orientation_sigma, orientation_patch_size))
    args = (b, h, w, num_scales, diffusion_iterations,
            float(np.float32(1.0 / (kappa * kappa))), threshold, nms_radius, half)
    if plan.route == "resident":
        tags = torch.empty((b, plan.ny, plan.nx), dtype=torch.int32, device=dev)
        fn = _build.entry("oip_akaze_ladder_resident", _RESIDENT_ARGTYPES)
        # The taps go by value into the launch's parameters.
        with torch.cuda.device(image.device):
            err = fn(_build.ptr(image), host_taps.ctypes.data_as(ctypes.c_void_p),
                     _build.ptr(state), _build.ptr(tags),
                     _build.ptr(scores), _build.ptr(m10), _build.ptr(m01), *args, plan.ny,
                     plan.nx, plan.out_rows, plan.smem_bytes, _build.stream(image))
    else:
        fn = _build.entry("oip_akaze_ladder", _ARGTYPES)
        taps = _build.constant(host_taps, dev)
        with torch.cuda.device(image.device):
            err = fn(_build.ptr(image), _build.ptr(taps), _build.ptr(state[0]),
                     _build.ptr(state[1]), _build.ptr(scores), _build.ptr(m10),
                     _build.ptr(m01), *args, _build.stream(image))
    _build.check(err, "akaze_ladder launch")
    LAUNCHES.count += 1
    return scores, m10, m01


@akaze_ladder_op.register_fake
def _(image, num_scales, diffusion_iterations, kappa, threshold, nms_size,
      orientation_patch_size, orientation_sigma):
    b, h, w = image.shape
    return tuple(image.new_empty((b, num_scales, h, w), dtype=torch.float32)
                 for _ in range(3))
