"""Randomized soak of the port's kernel paths: the card against the CPU.

Each draw is one configuration of one family, run on the card (the hand
kernels) and on the CPU (their plain versions) on the same seeded inputs;
the two are compared, and each side is held to the invariants of the JAX
package's soak (``tools/soak.py`` ``_run_draw``: invalid keypoint slots
(-1, -1), keypoints inside the image, finite P, Sinkhorn rows summing to
~1 at its epsilon), plus columns summing to 1 and unit descriptor norms.
The families and their ranges are the JAX soak's draw functions:

- ``flagship``: the oriented or unoriented sparse matcher at ``_one_draw``'s
  odd small shapes (NMS 3/5/7) or ``_one_tpu_draw``'s 480-1080 shapes with
  odd jitter (K 128-1024), nearest or bilinear sampling, hard or soft
  binarize, block or sort top-k, and here also the fused detect frontend;
- ``akaze``: ``_one_akaze_draw``'s detector space, or a hi-res shape of its
  lattice (1083x1923 takes the ladder's global route);
- ``essential``: the flagship essential pipeline, LS or 128 RANSAC
  hypotheses;
- ``ties``: ``_one_ties_draw``'s tiled, quantized images; both devices
  break ties raster-first, so their keypoints must be equal;
- ``sinkhorn``: ``ops.sinkhorn_match`` on ragged n x m (each 2-1100) at
  B 1-8 (the JAX soak has no such family), held to the plain version at
  1e-5, the dustbin corner at 2e-6 relative or, past that, within 4
  float32 ulps of its log-domain scale from float64.

A third of the matcher draws also run the streaming split on the card
against the two-image call. Each draw reads ``kernels.launch_counts()``
after its card run and fails if a kernel its path should launch did not,
so no draw passes on the plain versions. Draws run one after another (the
select kernels' ticket counters serve one stream at a time). A failing
draw prints its whole draw dict, to be pinned as a test.

    python -m onnx_image_processing_tpu_torch.tools.soak --iters 25 --seed 0
    python -m onnx_image_processing_tpu_torch.tools.soak --iters 8 --family sinkhorn ties

Draw i is of family ``families[i % len(families)]``; a family named twice
gets twice the draws. Needs a CUDA device; :func:`run_draw` takes its two
devices as arguments, so the CPU tests drive it on the CPU twice.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

FAMILIES = ("flagship", "akaze", "essential", "ties", "sinkhorn")
FLAGSHIP = "shi_tomasi_angle_sparse_bad_sinkhorn"
UNORIENTED = "shi_tomasi_sparse_bad_sinkhorn"
AKAZE = "akaze_sparse_bad_sinkhorn"
ESSENTIAL = FLAGSHIP + "_essential_matrix"
# The JAX soak's fixed AKAZE hi-res lattice (tools/soak.py).
AKAZE_HIRES_SHAPES = ((727, 1287), (911, 1607), (1083, 1923))
SINKHORN_ATOL = 1e-5          # P, kernel vs plain version (PERF.md §2)
SINKHORN_CORNER_RTOL = 2e-6   # the dustbin corner, relative
CORNER_ULPS = 4.0             # past that, from float64 (see corner_ulps)
STREAMING_P_ATOL = 1e-4       # streaming vs two-image P (the JAX soak's bound)
ROW_ATOL = 0.15               # Sinkhorn row marginals after 20 sweeps (the JAX soak's)
COL_ATOL = 1e-3               # column marginals, exact after the last (column) sweep
NORM_ATOL = 1e-4              # unit descriptor norms


# ---- draws ----------------------------------------------------------------

def _hires_shape(rng) -> tuple[int, int]:
    """``_one_tpu_draw``'s production-and-above shapes, odd jitter."""
    return (int(rng.choice([480, 560, 720, 904, 1080])) + int(rng.integers(0, 9)),
            int(rng.choice([640, 960, 1280, 1609, 1920])) + int(rng.integers(0, 9)))


def _descriptor_fields(rng) -> dict:
    return {"num_pairs": int(rng.choice([256, 512])),
            "sampling_mode": str(rng.choice(["nearest", "bilinear"])),
            "binarize": bool(rng.integers(0, 2)),
            "soft_binarize": bool(rng.integers(0, 2))}


def flagship_draw(rng: np.random.Generator, idx: int) -> dict:
    """``_one_draw`` (small odd shapes, K 16-96, NMS 3/5/7) or
    ``_one_tpu_draw``'s flagship (480-1080, K 128-1024, NMS 3/5); either
    with or without the angle, block or sort top-k, the streaming split on
    a third, the fused detect frontend on half."""
    hires = bool(rng.integers(0, 2))
    if hires:
        h, w = _hires_shape(rng)
        k = int(rng.choice([128, 256, 512, 1024]))
        nms = int(rng.choice([3, 5]))
    else:
        h, w = int(rng.integers(70, 300)), int(rng.integers(90, 400))
        k = int(rng.choice([16, 24, 40, 64, 96]))
        nms = int(rng.choice([3, 5, 7]))
    return {"idx": idx, "family": "flagship", "hires": hires, "h": h, "w": w,
            "max_keypoints": k, **_descriptor_fields(rng),
            "with_angle": bool(rng.integers(0, 2)), "nms_radius": nms,
            "topk_mode": str(rng.choice(["block", "block", "sort"])),
            "fused_detect": bool(rng.integers(0, 2)),
            "streaming": bool(rng.integers(0, 3) == 0),
            "seed": int(rng.integers(0, 2**31))}


def akaze_draw(rng: np.random.Generator, idx: int) -> dict:
    """``_one_akaze_draw``'s detector space at its small shapes, or (a third
    of the draws) a shape of the hi-res lattice at the default detector with
    K 512/1024, hard bits, NMS 5, block top-k and the streaming split, as
    ``_one_tpu_draw`` has it."""
    if rng.integers(0, 3) == 0:
        h, w = AKAZE_HIRES_SHAPES[int(rng.integers(0, len(AKAZE_HIRES_SHAPES)))]
        return {"idx": idx, "family": "akaze", "hires": True, "h": h, "w": w,
                "max_keypoints": int(rng.choice([512, 1024])), "num_pairs": 512,
                "sampling_mode": "nearest", "binarize": True, "soft_binarize": False,
                "nms_radius": 5, "topk_mode": "block", "streaming": True,
                "seed": int(rng.integers(0, 2**31))}
    return {"idx": idx, "family": "akaze", "hires": False,
            "h": int(rng.integers(90, 260)), "w": int(rng.integers(120, 340)),
            "max_keypoints": int(rng.choice([16, 24, 40, 64])), **_descriptor_fields(rng),
            "nms_radius": int(rng.choice([3, 5])),
            "topk_mode": str(rng.choice(["block", "block", "sort"])),
            "akaze_num_scales": int(rng.choice([2, 3, 4])),
            "akaze_diffusion_iterations": int(rng.choice([2, 3, 5])),
            "akaze_kappa": float(rng.choice([0.02, 0.05, 0.1])),
            "akaze_threshold": float(rng.choice([0.0005, 0.001, 0.002])),
            "akaze_nms_size": int(rng.choice([3, 5])),
            "streaming": bool(rng.integers(0, 3) == 0),
            "seed": int(rng.integers(0, 2**31))}


def essential_draw(rng: np.random.Generator, idx: int) -> dict:
    """``_one_tpu_draw``'s essential family: the flagship essential
    pipeline at 480-1080, the LS solve or 128 RANSAC hypotheses (+2 polish
    steps)."""
    h, w = _hires_shape(rng)
    return {"idx": idx, "family": "essential", "hires": True, "h": h, "w": w,
            "max_keypoints": int(rng.choice([128, 256, 512, 1024])),
            **_descriptor_fields(rng), "nms_radius": int(rng.choice([3, 5])),
            "topk_mode": str(rng.choice(["block", "block", "sort"])),
            "essential_ransac": int(rng.choice([0, 128])),
            "streaming": bool(rng.integers(0, 3) == 0),
            "seed": int(rng.integers(0, 2**31))}


def ties_draw(rng: np.random.Generator, idx: int) -> dict:
    """``_one_ties_draw``: tiled, quantized textures whose scores tie
    exactly, half of them with tiles no wider than the NMS radius (ties
    inside one block); the top-k mode drawn."""
    nms = int(rng.choice([3, 5]))
    micro = bool(rng.integers(0, 2))
    lo, hi = (2, nms + 2) if micro else (24, 60)
    return {"idx": idx, "family": "ties",
            "tile_h": int(rng.integers(lo, hi)), "tile_w": int(rng.integers(lo, hi)),
            "reps_y": int(rng.integers(2, 5)) * (12 if micro else 1),
            "reps_x": int(rng.integers(2, 6)) * (12 if micro else 1),
            "quant_levels": int(rng.choice([4, 8, 16, 256])),
            "max_keypoints": int(rng.choice([32, 64, 128])), "nms_radius": nms,
            "topk_mode": str(rng.choice(["block", "sort"])),
            "seed": int(rng.integers(0, 2**31))}


def sinkhorn_draw(rng: np.random.Generator, idx: int) -> dict:
    """Ragged Sinkhorn: n and m each 2-1100, B 1-8, epsilon log-uniform over
    the registry's 0.05-1.0, unit descriptors of 256 or 512 bits or
    Gaussian entries."""
    return {"idx": idx, "family": "sinkhorn", "b": int(rng.integers(1, 9)),
            "n": int(rng.integers(2, 1101)), "m": int(rng.integers(2, 1101)),
            "dim": int(rng.choice([256, 512])),
            "epsilon": float(np.exp(rng.uniform(np.log(0.05), 0.0))),
            "bits": bool(rng.integers(0, 2)), "seed": int(rng.integers(0, 2**31))}


DRAWS = {"flagship": flagship_draw, "akaze": akaze_draw, "essential": essential_draw,
         "ties": ties_draw, "sinkhorn": sinkhorn_draw}


def draws(seed: int, iters: int, families=FAMILIES) -> list[dict]:
    """``iters`` draws from one generator seeded ``seed``; draw i is of
    family ``families[i % len(families)]``."""
    for f in families:
        if f not in DRAWS:
            raise ValueError(f"unknown family {f!r}; families: {FAMILIES}")
    rng = np.random.default_rng(seed)
    return [DRAWS[families[i % len(families)]](rng, i) for i in range(iters)]


# ---- inputs and configurations ---------------------------------------------

def _images(draw: dict) -> tuple[np.ndarray, np.ndarray]:
    """The draw's pair, (1, 1, H, W) float32 each: the JAX soak's inputs
    (uniform noise rolled 5 px, or 4 px for AKAZE, at small shapes; a
    textured base with noise rolled 7 px at hi-res; a tiled, quantized
    texture rolled 3 px for ties)."""
    rng = np.random.default_rng(draw["seed"])
    if draw["family"] == "ties":
        tile = rng.uniform(0, 255, (draw["tile_h"], draw["tile_w"]))
        img = np.tile(tile, (draw["reps_y"], draw["reps_x"]))
        q = 256 // draw["quant_levels"]
        img = (img // q * q).astype(np.float32)
        return img[None, None], np.roll(img, 3, axis=1)[None, None].astype(np.float32)
    h, w = draw["h"], draw["w"]
    if draw["hires"]:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = 127 + 80 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
        img1 = np.clip(base + rng.normal(0, 3, (h, w)), 0, 255)
        img2 = np.clip(np.roll(base, 7, 1) + rng.normal(0, 3, (h, w)), 0, 255)
        return img1.astype(np.float32)[None, None], img2.astype(np.float32)[None, None]
    img1 = rng.uniform(0, 255, (1, 1, h, w)).astype(np.float32)
    return img1, np.roll(img1, 4 if draw["family"] == "akaze" else 5, axis=3)


_CFG_FIELDS = ("max_keypoints", "num_pairs", "sampling_mode", "binarize", "soft_binarize",
               "nms_radius", "topk_mode", "fused_detect", "akaze_num_scales",
               "akaze_diffusion_iterations", "akaze_kappa", "akaze_threshold", "akaze_nms_size")


def matcher_config(draw: dict):
    """(registry name, MatcherConfig) of a matcher draw. As in the JAX soak,
    the config is the module defaults with the drawn fields; ties draws
    take the export defaults (hard bits, epsilon 0.05) so P is peaked."""
    from ..core import MatcherConfig

    fields = {k: draw[k] for k in _CFG_FIELDS if k in draw}
    family = draw["family"]
    if family == "ties":
        fields.update(num_pairs=256, binarize=True, soft_binarize=False, epsilon=0.05)
    if family == "essential":
        r = draw["essential_ransac"]
        fields.update(essential_ransac_hypotheses=r, essential_irls_iters=2 if r else 0)
    name = {"akaze": AKAZE, "essential": ESSENTIAL}.get(
        family, FLAGSHIP if draw.get("with_angle", True) else UNORIENTED)
    return name, MatcherConfig().with_(**fields)


def expected_kernels(draw: dict) -> set[str]:
    """The kernels a draw's card run must launch."""
    from ..ops.keypoints import block_route

    if draw["family"] == "sinkhorn":
        return {"sinkhorn"}
    _, cfg = matcher_config(draw)
    h, w = _images(draw)[0].shape[-2:] if draw["family"] == "ties" else (draw["h"], draw["w"])
    expect = {"sparse_sampler", "sinkhorn"}
    if draw["family"] == "akaze":
        expect.add("akaze_ladder")
    elif not cfg.fused_detect:
        expect.add("score_moments")
    if cfg.fused_detect and draw["family"] != "akaze":
        expect.add("detect_frontend")
    elif block_route(cfg.topk_mode, cfg.nms_radius, h, w, cfg.max_keypoints):
        expect.add("select_frontend")
    if draw["family"] == "essential":
        expect |= {"min_eigvec9", "project_essential"}
        if cfg.essential_ransac_hypotheses:
            expect.add("essential_hypotheses")
    return expect


def _k_inv(h: int, w: int) -> np.ndarray:
    fx = 0.9 * w
    return np.linalg.inv(np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])).astype(np.float32)


# ---- one draw on one device --------------------------------------------------

def _run_matcher(draw: dict, device: torch.device) -> dict:
    """The draw's matcher on ``device``: its features of the stacked pair
    (the frontend of ``forward``) and its tail, as numpy; with
    ``streaming``, also the streaming split on the same images."""
    from ..models import build, build_streaming

    name, cfg = matcher_config(draw)
    img1, img2 = (torch.from_numpy(a).to(device) for a in _images(draw))
    extra = ()
    if draw["family"] == "essential":
        extra = (torch.from_numpy(_k_inv(*img1.shape[-2:])).to(device),)
    matcher = build(name, cfg, device=device)
    kpts, kscores, desc = matcher.features(torch.cat([img1, img2]))
    f1, f2 = ((kpts[i:i + 1], kscores[i:i + 1], desc[i:i + 1]) for i in (0, 1))
    out = {"outputs": [t.cpu().numpy() for t in matcher.tail(f1, f2, *extra)],
           "kpts": kpts.cpu().numpy(), "desc": desc.cpu().numpy()}
    if draw.get("streaming"):
        ex, ma = build_streaming(name, cfg, device=device)
        out["streaming"] = [t.cpu().numpy() for t in ma(ex(img1), ex(img2), *extra)]
    return out


def sinkhorn_inputs(draw: dict) -> tuple[np.ndarray, np.ndarray]:
    """Unit descriptor sets (B, n, dim) and (B, m, dim)."""
    rng = np.random.default_rng(draw["seed"])
    sets = []
    for size in (draw["n"], draw["m"]):
        shape = (draw["b"], size, draw["dim"])
        d = (rng.random(shape) < 0.5).astype(np.float32) if draw["bits"] else \
            rng.normal(size=shape).astype(np.float32)
        sets.append(d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12))
    return sets[0], sets[1]


def _run_sinkhorn(draw: dict, device: torch.device) -> dict:
    from ..ops import sinkhorn_match

    d1, d2 = (torch.from_numpy(a).to(device) for a in sinkhorn_inputs(draw))
    return {"outputs": [sinkhorn_match(d1, d2, epsilon=draw["epsilon"]).cpu().numpy()]}


def run_on(draw: dict, device) -> dict:
    """The draw's outputs on ``device``, as numpy arrays."""
    device = torch.device(device)
    with torch.no_grad():
        if draw["family"] == "sinkhorn":
            return _run_sinkhorn(draw, device)
        return _run_matcher(draw, device)


# ---- comparison and invariants -------------------------------------------------

def _p_common_diff(out_a, out_b, k: int, hard: bool, label: str,
                   errors: list[str], max_swaps: int = 4) -> bool:
    """Permutation-aware P comparison over the COMMON keypoint subset (a
    copy of the JAX soak's ``tools/soak.py`` ``_p_common_diff``, same
    thresholds and swap allowance).

    Two devices may swap a few rank-boundary keypoints (float reduction
    order); those rows/cols (and only those) are excluded from the P
    comparison. ``out_*`` are (k1, k2, P[, ...]) output lists; appends to
    ``errors`` and returns True iff both keypoint sets were close enough to
    compare P at all.
    """
    idx = {}
    for nm, a, b in (("k1", out_a[0], out_b[0]), ("k2", out_a[1], out_b[1])):
        s_a = {tuple(v) for v in a[0].tolist()}
        s_b = {tuple(v) for v in b[0].tolist()}
        if len(s_a ^ s_b) > max_swaps:
            errors.append(f"{label} {nm}: keypoint sets differ "
                          f"({len(s_a ^ s_b)} symmetric difference)")
            continue
        inv_a = {tuple(v): i for i, v in enumerate(a[0].tolist())}
        inv_b = {tuple(v): i for i, v in enumerate(b[0].tolist())}
        shared = sorted(s_a & s_b)
        # Dustbin row/col (index k) always compares.
        idx[nm] = (np.array([inv_a[v] for v in shared] + [k]),
                   np.array([inv_b[v] for v in shared] + [k]))
    if len(idx) < 2:
        return False
    ia1, ib1 = idx["k1"]
    ia2, ib2 = idx["k2"]
    n_swapped = 2 * (k + 1) - len(ia1) - len(ia2)
    diff = np.abs(out_a[2][0][np.ix_(ia1, ia2)]
                  - out_b[2][0][np.ix_(ib1, ib2)])
    # Hard-binarized bits may flip at threshold ties -> rare O(1) P moves.
    tol, max_frac = (0.5, 2e-3) if hard else (2e-2, 1e-3)
    # Swapped keypoints change a few cost rows/cols, and Sinkhorn's
    # normalization spreads that over every entry — allow proportionally
    # more outliers when the sets differ (rows themselves are excluded).
    max_frac += 2e-3 * n_swapped
    frac = (diff > tol).mean()
    if frac > max_frac:
        errors.append(f"{label} P mismatch: max={diff.max():.3f} "
                      f"frac>{tol}={frac:.2e} (allowed {max_frac:.2e}, "
                      f"{n_swapped} rank-boundary swaps excluded)")
    return True


def _invariants(draw: dict, out: dict, side: str, errors: list[str]) -> None:
    """The JAX soak's invariants on one side's outputs, plus descriptor norms."""
    p = out["outputs"][0] if draw["family"] == "sinkhorn" else out["outputs"][2]
    if not np.all(np.isfinite(p)):
        errors.append(f"{side}: P contains non-finite values")
    cols = p.sum(axis=1)[:, :-1]
    if np.abs(cols - 1.0).max() > COL_ATOL:
        errors.append(f"{side}: Sinkhorn column marginals off: {np.abs(cols - 1).max():.2e}")
    if draw["family"] in ("sinkhorn", "ties"):
        # Rows converge within ROW_ATOL at the module default epsilon (1.0)
        # that the JAX soak checks them at, not at every epsilon.
        return
    rows = p.sum(axis=2)[:, :-1]
    if np.abs(rows - 1.0).max() > ROW_ATOL:
        errors.append(f"{side}: Sinkhorn row marginals off: {np.abs(rows - 1).max():.3f}")
    h, w = _images(draw)[0].shape[-2:]
    kpts = out["kpts"]
    invalid = kpts[..., 0] < 0
    if not (kpts[invalid] == -1.0).all():
        errors.append(f"{side}: invalid slots not (-1, -1)")
    valid = kpts[~invalid]
    if valid.size and ((valid < 0).any() or (valid[:, 0] > h - 1).any()
                       or (valid[:, 1] > w - 1).any()):
        errors.append(f"{side}: keypoints out of bounds")
    norms = np.linalg.norm(out["desc"], axis=-1)
    if np.abs(norms[invalid]).max(initial=0.0) != 0.0:
        errors.append(f"{side}: an invalid slot has a non-zero descriptor")
    off = np.abs(norms[~invalid] - 1.0) > NORM_ATOL
    if (off & (norms[~invalid] != 0.0)).any():
        errors.append(f"{side}: descriptor norms off 1 by up to "
                      f"{np.abs(norms[~invalid] - 1).max():.2e}")


def _sampson_mean(e, mk1, mk2, k_inv) -> float:
    x1 = np.concatenate([mk1[:, [1, 0]], np.ones((len(mk1), 1))], axis=1) @ k_inv.T
    x2 = np.concatenate([mk2[:, [1, 0]], np.ones((len(mk2), 1))], axis=1) @ k_inv.T
    e = e / max(np.linalg.norm(e), 1e-12)
    l2, l1 = x1 @ e.T, x2 @ e
    num = np.einsum("ij,ij->i", x2, l2) ** 2
    den = l2[:, 0] ** 2 + l2[:, 1] ** 2 + l1[:, 0] ** 2 + l1[:, 1] ** 2
    return float(np.mean(num / (den + 1e-12)))


def corner_ulps(draw: dict, p: np.ndarray) -> np.ndarray:
    """Per batch entry, how far a Sinkhorn draw's dustbin corner in ``p``
    lies from a float64 run of the plain version on the CPU's float32
    inputs, in float32 ulps (2^-23) of the log-domain scale: the largest
    |S| plus the largest log-marginal.

    The corner is exp(S + u + v), so its relative error is the absolute
    error of the float32 log-domain values: a few e-6 at small epsilon,
    where |S| reaches 2 / epsilon, and two float32 sum orders part there
    by more than SINKHORN_CORNER_RTOL (draw 53 of seed 0: the plain
    version alone 3.5e-6 from float64). So a corner past that tolerance is
    arbitrated by float64, as the JAX soak arbitrates its essential draws:
    the plain float32 version stays within half of CORNER_ULPS
    (``tests/test_torch_soak.py``), the device under test must stay
    within CORNER_ULPS."""
    from ..kernels.sinkhorn_kernel import sinkhorn_core_plain
    from ..ops.sinkhorn import sinkhorn_inputs as assemble

    d1, d2 = (torch.from_numpy(x) for x in sinkhorn_inputs(draw))
    log_scores, log_mu, log_nu = assemble(d1, d2, draw["epsilon"])
    t = sinkhorn_core_plain(log_scores.double(), log_mu.double(), log_nu.double(),
                            20)[:, -1, -1].numpy()
    scale = (log_scores.abs().amax(dim=(1, 2))
             + torch.maximum(log_mu.abs().amax(1), log_nu.abs().amax(1))).numpy()
    return np.abs(p[:, -1, -1] - t) / t / (2.0 ** -23 * scale)


def compare(draw: dict, a: dict, b: dict) -> list[str]:
    """Errors of the draw: ``a`` (the device under test) against ``b``
    (the reference device), and each side's invariants."""
    errors: list[str] = []
    for side, out in (("a", a), ("b", b)):
        _invariants(draw, out, side, errors)
    if draw["family"] == "sinkhorn":
        pa, pb = a["outputs"][0], b["outputs"][0]
        diff = np.abs(pa - pb)
        corner = diff[:, -1, -1] / np.abs(pb[:, -1, -1])
        diff[:, -1, -1] = 0.0
        if diff.max() > SINKHORN_ATOL:
            errors.append(f"P differs: max abs {diff.max():.3e} (max {SINKHORN_ATOL})")
        if corner.max() > SINKHORN_CORNER_RTOL:
            ulps = corner_ulps(draw, pa).max()
            if ulps > CORNER_ULPS:
                errors.append(f"dustbin corner {corner.max():.3e} relative from b's and "
                              f"{ulps:.2f} float32 ulps of its log-domain scale from "
                              f"float64 (max {CORNER_ULPS})")
        return errors
    oa, ob = a["outputs"], b["outputs"]
    if draw["family"] == "ties":
        for nm, i in (("k1", 0), ("k2", 1)):
            if not np.array_equal(oa[i], ob[i]):
                errors.append(f"ties {nm}: keypoints differ between the devices "
                              f"({int((oa[i] != ob[i]).any(-1).sum())} slots)")
    hard = bool(draw.get("binarize", True) and not draw.get("soft_binarize", False))
    comparable = _p_common_diff(oa, ob, draw["max_keypoints"], hard, "a/b", errors)
    if comparable and draw["family"] == "essential":
        # E is held by its fit: the RANSAC E is not reproducible across
        # devices, and a rolled pair's LS problem is near-degenerate. a's E
        # must fit b's matches no worse than 3x b's own (the JAX soak's rule).
        from ..utils import extract_matches

        mk1, mk2, _ = extract_matches(ob[2], ob[0], ob[1], threshold=0.1, max_matches=256)
        if len(mk1) >= 8:
            k_inv = _k_inv(draw["h"], draw["w"]).astype(np.float64)
            s_a, s_b = (_sampson_mean(o[3], mk1, mk2, k_inv) for o in (oa, ob))
            if s_a > 3.0 * s_b + 1e-8:
                errors.append(f"a's essential matrix fits b's matches worse: Sampson "
                              f"{s_a:.2e} vs {s_b:.2e}")
    if "streaming" in a:
        s = a["streaming"]
        if not (np.array_equal(s[0], oa[0]) and np.array_equal(s[1], oa[1])):
            errors.append("streaming keypoints differ from the two-image call's")
        elif np.abs(s[2] - oa[2]).max() > STREAMING_P_ATOL:
            errors.append(f"streaming P differs from the two-image call's by "
                          f"{np.abs(s[2] - oa[2]).max():.2e}")
    return errors


def run_draw(draw: dict, device_a, device_b) -> tuple[list[str], dict]:
    """Run ``draw`` on ``device_a`` (under test) and ``device_b``
    (reference), compare them; returns the errors and ``device_a``'s launch
    counts. On a CUDA ``device_a`` every kernel of
    :func:`expected_kernels` must have launched."""
    from ..kernels import launch_counts, reset_launch_counts

    device_a = torch.device(device_a)
    reset_launch_counts()
    try:
        a = run_on(draw, device_a)
        if device_a.type == "cuda":
            torch.cuda.synchronize(device_a)
    except (RuntimeError, ValueError) as exc:
        return [f"device a raised {type(exc).__name__}: {exc}"], launch_counts()
    counts = launch_counts()
    errors = compare(draw, a, run_on(draw, device_b))
    if device_a.type == "cuda":
        missing = sorted(k for k in expected_kernels(draw) if counts.get(k, 0) == 0)
        if missing:
            errors.append(f"kernels not launched on the card: {missing} (counts {counts})")
    return errors, counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", nargs="+", default=list(FAMILIES), choices=FAMILIES,
                    help="families in turn (a family named twice gets twice the draws)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("soak: no CUDA device; the soak runs the card against the CPU")
    t0 = time.perf_counter()
    failures, per_family = 0, {}
    for draw in draws(args.seed, args.iters, tuple(args.family)):
        t = time.perf_counter()
        errs, _ = run_draw(draw, "cuda", "cpu")
        per_family[draw["family"]] = per_family.get(draw["family"], 0) + 1
        print(f"[{'ok' if not errs else 'FAIL'}] draw {draw['idx']} "
              f"({time.perf_counter() - t:.2f} s): {draw}", flush=True)
        for e in errs:
            print(f"       {e}")
        failures += bool(errs)
    print(f"draws per family {per_family}; {args.iters - failures}/{args.iters} passed "
          f"in {time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
