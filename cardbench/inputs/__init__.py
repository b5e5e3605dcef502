"""Seeded inputs of the benchmark, made in a few large calls on the run's
device with a ``torch.Generator`` and handed to the traffic as host arrays.

Textures are rewritten from the smoke run's ``texture_pair``: blurred
uniform noise, so matches can pin a shift. Camera sequences are rendered
from a 3D scene of textured planes at depths of a few metres to a wall
behind them, seen by a camera that moves and turns between frames, so the
8-point system of two frames has one well-separated E. Every seed gets the
same sizes, shifts, steps and turns; the seed changes the content, the
scene's layout, the directions of motion and the order of the shifts. A
seed gives the same inputs on one device every time (the card's and the
CPU's draws differ)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["generator", "texture_pairs", "scene_sequence", "scene_walks", "sweep",
           "frame_pairs"]


def _state(seed: int, stream: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from any non-negative ``seed``
    and a stream id, so the inputs of two purposes never share draws."""
    return int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_state(seed, stream))


def _blur(a: torch.Tensor, r: int) -> torch.Tensor:
    """Box blur of radius ``r`` along the last two axes of (N, H, W), edges
    replicated (running sums)."""
    k = 2 * r + 1
    for dim in (1, 2):
        n = a.shape[dim]
        idx = torch.arange(-(r + 1), n + r, device=a.device).clamp(0, n - 1)
        c = a.index_select(dim, idx).cumsum(dim)
        a = (c.narrow(dim, k, n) - c.narrow(dim, 0, n)) / k
    return a


def _textures(g: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, h, w) non-periodic textures: uniform noise blurred three times,
    each scaled to [0, 255]."""
    tex = _blur(_blur(_blur(torch.rand((n, h, w), generator=g, device=device,
                                       dtype=torch.float64), 2), 2), 2)
    lo = tex.amin(dim=(1, 2), keepdim=True)
    hi = tex.amax(dim=(1, 2), keepdim=True)
    return 255 * (tex - lo) / (hi - lo)


def _images(a: torch.Tensor) -> np.ndarray:
    """(N, H, W) -> host float32 (N, 1, 1, H, W), clipped to [0, 255]."""
    return a.clamp(0, 255).to(torch.float32).cpu().numpy()[:, None, None]


def texture_pairs(seed: int, n: int, h: int, w: int, shift_min: int, shift_max: int,
                  device="cpu", noise: float = 3.0) -> list[tuple[np.ndarray, np.ndarray]]:
    """``n`` pairs of (1, 1, h, w) float32 host images: a texture of its own
    and the texture rolled in x by its pair's shift, each with its own noise.
    The shifts run ``shift_min``..``shift_max`` px in turn and the seed
    permutes them, so every seed serves the same set of shifts."""
    span = shift_max - shift_min + 1
    order = torch.randperm(n, generator=generator(seed, 0, "cpu"))
    shifts = [shift_min + int(i) % span for i in order]
    g = generator(seed, 1, device)
    tex = _textures(g, n, h, w, device)
    rolled = torch.stack([torch.roll(t, s, dims=1) for t, s in zip(tex, shifts)])
    noisy = torch.randn((2, n, h, w), generator=g, device=device, dtype=torch.float64) * noise
    first, second = _images(tex + noisy[0]), _images(rolled + noisy[1])
    return [(first[i], second[i]) for i in range(n)]


def _rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues: the rotation by ``angle`` about ``axis``."""
    a = axis / np.linalg.norm(axis)
    k = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def scene_sequence(seed: int, walk: int, n_frames: int, h: int, w: int, camera: dict,
                   scene: dict, motion: dict, device="cpu",
                   chunk: int = 8) -> tuple[list[np.ndarray], list, list]:
    """Frames of one camera walk through a 3D scene of its own: a textured
    back wall at ``wall_m`` and ``panels`` textured rectangles at depths
    between ``near_m`` and ``far_m`` (uniform in inverse depth), each tilted
    up to ``tilt_deg``, rendered by casting every pixel's ray through the
    pinhole ``camera`` (fx, fy, cx, cy) and sampling the nearest surface
    bilinearly; each frame with its own noise. Between frames the camera
    steps ``step_m`` along ``motion["direction"]`` and turns ``turn_deg``
    about ``motion["turn_axis"]``. ``seed`` and ``walk`` set the layout, the
    textures and the noise; texels are one pixel at their surface's depth.

    Returns (frames, centres, rotations): (1, 1, h, w) float32 host arrays,
    and each frame's camera centre and camera-to-world rotation (camera x
    right, y down, z forward)."""
    rng = np.random.default_rng([int(seed), 4, int(walk)])
    fx, fy, cx, cy = camera["fx"], camera["fy"], camera["cx"], camera["cy"]
    direction = np.asarray(motion["direction"], np.float64)
    direction /= np.linalg.norm(direction)
    axis = np.asarray(motion["turn_axis"], np.float64)
    turn = np.radians(scene["turn_deg"])
    centres = [i * scene["step_m"] * direction for i in range(n_frames)]
    rotations = [_rotation(axis, i * turn) for i in range(n_frames)]

    # (point, normal, in-plane axes u and v, half-extents along them, depth)
    mid = centres[n_frames // 2]
    tan_x, tan_y = (w / 2) / fx, (h / 2) / fy
    travel = (n_frames - 1) * scene["step_m"]
    span = (n_frames - 1) * abs(turn)
    wall = scene["wall_m"]
    eye = np.eye(3)
    planes = [(mid + wall * eye[2], -eye[2], eye[0], eye[1],
               wall * (tan_x + span + 0.5) + travel, wall * (tan_y + span + 0.3) + travel,
               wall)]
    tilt = np.radians(scene["tilt_deg"])
    for _ in range(scene["panels"]):
        z = 1 / rng.uniform(1 / scene["far_m"], 1 / scene["near_m"])
        x = rng.uniform(-1, 1) * (z * tan_x + travel / 2)
        y = rng.uniform(-1, 1) * z * tan_y
        r = _rotation(eye[1], rng.uniform(-tilt, tilt)) @ _rotation(eye[0],
                                                                     rng.uniform(-tilt, tilt))
        hu, hv = scene["panel_frac"] * z * tan_x * rng.uniform(0.6, 1.4, size=2)
        planes.append((mid + np.array([x, y, z]), -r[:, 2], r[:, 0], r[:, 1], hu, hv, z))

    f32 = dict(dtype=torch.float32, device=device)
    g = generator(seed, 16 + 2 * walk, device)
    textures = []
    for *_, hu, hv, z in planes:
        texel = z / fx
        tex = _textures(g, 1, int(np.ceil(2 * hv / texel)) + 2, int(np.ceil(2 * hu / texel)) + 2,
                        device)[0]
        textures.append((tex.to(torch.float32).reshape(-1), tex.shape[1], tex.shape[0], texel))
    yy, xx = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32), indexing="ij")
    rays = torch.stack([(xx - cx) / fx, (yy - cy) / fy, torch.ones_like(xx)], -1).reshape(-1, 3)
    noise = generator(seed, 17 + 2 * walk, device)
    out = []
    for lo in range(0, n_frames, chunk):
        hi = min(lo + chunk, n_frames)
        c = torch.as_tensor(np.stack(centres[lo:hi]), **f32)[:, None, :]             # (F, 1, 3)
        rw = torch.as_tensor(np.stack(rotations[lo:hi]), **f32)
        d = rays[None] @ rw.transpose(1, 2)                                         # (F, P, 3)
        nearest = torch.full(d.shape[:2], float("inf"), **f32)
        img = torch.zeros(d.shape[:2], **f32)
        for (p0, n, u, v, hu, hv, _), (tex, tw, th, texel) in zip(planes, textures):
            p0, n = torch.as_tensor(p0, **f32), torch.as_tensor(n, **f32)
            t = ((p0 - c) @ n) / (d @ n)
            x = c + t[..., None] * d - p0
            a = x @ torch.as_tensor(u, **f32) / texel + hu / texel
            b = x @ torch.as_tensor(v, **f32) / texel + hv / texel
            hit = (t > 0) & (t < nearest) & (a >= 0) & (a < tw - 1) & (b >= 0) & (b < th - 1)
            a, b = torch.where(hit, a, 0.0), torch.where(hit, b, 0.0)    # no NaN indices
            a0, b0 = a.clamp(0, tw - 2).floor(), b.clamp(0, th - 2).floor()
            fa, fb = a - a0, b - b0
            i = b0.long() * tw + a0.long()
            val = ((1 - fb) * ((1 - fa) * tex[i] + fa * tex[i + 1])
                   + fb * ((1 - fa) * tex[i + tw] + fa * tex[i + tw + 1]))
            img = torch.where(hit, val, img)
            nearest = torch.where(hit, t, nearest)
        img = img.reshape(hi - lo, h, w) + torch.randn((hi - lo, h, w), generator=noise, **f32) \
            * scene["noise"]
        out.extend(_images(img))
    return out, centres, rotations


def scene_walks(seed: int, n_walks: int, n_frames: int, h: int, w: int, camera: dict,
                scene: dict, device="cpu") -> list[list[np.ndarray]]:
    """``n_walks`` walks of ``scene_sequence``, each through a scene of its
    own, their motions the first ``n_walks`` of ``scene["motions"]`` in an
    order the seed draws: every seed walks the same set of motions."""
    order = torch.randperm(len(scene["motions"]), generator=generator(seed, 5, "cpu"))
    return [scene_sequence(seed, k, n_frames, h, w, camera, scene,
                           scene["motions"][int(order[k])], device)[0] for k in range(n_walks)]




def sweep(n_frames: int) -> list[int]:
    """Frame indices 0, 1, ..., n-1, n-2, ..., 1: the camera walks forward
    and back, so the motion never jumps."""
    return list(range(n_frames)) + list(range(n_frames - 2, 0, -1))


def frame_pairs(n_frames: int, gap: int) -> list[tuple[int, int]]:
    """(i, i + gap) for every frame i that has a partner ``gap`` steps on."""
    return [(i, i + gap) for i in range(n_frames - gap)]
