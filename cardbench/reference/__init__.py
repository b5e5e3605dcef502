"""The benchmark's plain reference: what each request should answer.

``pair_answers`` answers two-image requests (matches, and E where the
configuration solves one); ``vo_answers`` answers VO frames (the matches
and E of a reference frame against the current one, then the pose step and
the loop's verdict). Both yield ``(key, Want)`` one key at a time, so only
one key's assignment matrix is held at once. An answer is a dict of host
arrays: ``mk1``, ``mk2`` (L, 2) (y, x) and ``scores`` (L,) of the valid
matches, ``e`` (3, 3), and for a frame ``r`` (3, 3) and ``t`` (3, 1) or
None and ``accepted``. ``precision="tf32"`` gives the control
(``plain.round_tf32``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import plain, pose

__all__ = ["Want", "pair_answers", "vo_answers", "intrinsics"]


@dataclass
class Want:
    """The reference's answer to one key and what judging an answer needs:
    its assignment matrix ``p`` (N+1, M+1) on the device, its keypoints
    (N, 2), (M, 2) and their validity (host), the settings, and for E the
    relative eigengap (lambda2 - lambda1) / lambda_max of its 8-point normal
    matrix; for a frame, the camera and the loop's gates."""
    answer: dict
    p: torch.Tensor
    k1: np.ndarray
    v1: np.ndarray
    k2: np.ndarray
    v2: np.ndarray
    settings: dict
    e_gap_scale: float | None = None
    k: np.ndarray | None = None
    gates: dict | None = None

    def pose_of(self, ans: dict):
        """(R, t, accepted) of the loop's pose step and gates on ``ans``'s
        own matches and E."""
        r, t, ok, _ = pose.gate(ans["mk1"], ans["mk2"], ans["e"], self.k, self.gates)
        return r, t, ok


def intrinsics(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """(K float64, K^-1 float32) of a configuration's camera."""
    c = cfg["camera"]
    k = np.array([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]], [0.0, 0.0, 1.0]])
    return k, np.linalg.inv(k).astype(np.float32)


def _check(cfg: dict) -> None:
    s = cfg["settings"]
    unsupported = {k: s.get(k) for k, want in (
        ("sampling_mode", "nearest"), ("topk_mode", "block"), ("fused_detect", False),
        ("ratio_threshold", None), ("dustbin_margin", None),
        ("essential_ransac_hypotheses", 0), ("essential_irls_iters", 0))
        if s.get(k, want) != want}
    if unsupported:
        raise ValueError(f"the reference does not carry {unsupported}")


def _want(p, f1, f2, s: dict, k_inv, precision: str) -> Want:
    (k1, ks1, _), (k2, ks2, _) = f1, f2
    mk1, mk2, sc = plain.mutual_matches(p, k1, k2, s)
    ans = {"mk1": mk1.cpu().numpy(), "mk2": mk2.cpu().numpy(), "scores": sc.cpu().numpy()}
    scale = None
    if k_inv is not None:
        e, eig = plain.essential(p, k1, ks1, k2, ks2, k_inv, precision)
        ans["e"] = e.numpy()
        scale = float((eig[1] - eig[0]) / eig[-1])
    return Want(ans, p, k1.cpu().numpy(), (ks1 > 0).cpu().numpy(), k2.cpu().numpy(),
                (ks2 > 0).cpu().numpy(), s, scale)


def _one(feats, i: int):
    return tuple(t[i] for t in feats)


@torch.no_grad()
def pair_answers(cfg: dict, pairs: dict, device, precision: str = "fp32",
                 essential: bool = False):
    """``(key, Want)`` for ``{key: (img1, img2)}`` host (1, 1, H, W) pairs,
    in key order."""
    _check(cfg)
    table = plain.load_table(device, cfg["settings"]["num_pairs"])
    k_inv = torch.from_numpy(intrinsics(cfg)[1]).to(device) if essential else None
    with plain.fp32_products():
        for key in sorted(pairs):
            a, b = pairs[key]
            both = torch.from_numpy(np.concatenate([a, b])).to(device)
            feats = plain.features(both, cfg, table)
            f1, f2 = _one(feats, 0), _one(feats, 1)
            p = plain.sinkhorn(f1[2], f2[2], cfg["settings"], precision)
            yield key, _want(p, f1, f2, cfg["settings"], k_inv, precision)


@torch.no_grad()
def vo_answers(cfg: dict, frames: list, keys, device, precision: str = "fp32"):
    """``(key, Want)`` for keys ``(ref, cur)``: frame ``cur`` matched against
    frame ``ref`` (host (1, 1, H, W) arrays), then the pose step and the
    loop's verdict; in key order."""
    _check(cfg)
    table = plain.load_table(device, cfg["settings"]["num_pairs"])
    k, k_inv = intrinsics(cfg)
    k_inv_t = torch.from_numpy(k_inv).to(device)
    keys = sorted(set(keys))
    with plain.fp32_products():
        cache = {i: _one(plain.features(torch.from_numpy(frames[i]).to(device), cfg, table), 0)
                 for i in sorted({i for key in keys for i in key})}
        for ref, cur in keys:
            f1, f2 = cache[ref], cache[cur]
            p = plain.sinkhorn(f1[2], f2[2], cfg["settings"], precision)
            w = _want(p, f1, f2, cfg["settings"], k_inv_t, precision)
            w.k, w.gates = k, cfg["vo"]
            w.answer["r"], w.answer["t"], w.answer["accepted"] = w.pose_of(w.answer)
            yield (ref, cur), w
