#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: the quickest proof that
the port still builds, agrees with its plain versions and runs end to end.

    python3 chip_smoke.py

Phases (any failed check raises; nothing falls back to the CPU):

0. Refuse to run without CUDA; print the card (nvidia-smi name, power limit)
   and the torch / CUDA versions.
1. Build the CUDA kernels from ``csrc/`` with nvcc (one process per source,
   all started together); print the seconds and each kernel's registers /
   shared memory from ptxas.
2. Each kernel against its plain PyTorch version on the card, on the
   paths' own inputs (480x640 pair; select, block grid and fused top-k,
   bit for bit on the flagship's, AKAZE's and the dense matcher's score
   maps and two tie maps; the sampler at the flagship's 512 keypoints with moment
   orientation and AKAZE's 1024 with its dense orientation, S=805 samples;
   Sinkhorn at 513x513 and 1025x1025; the detect frontend at block 5 /
   NMS 5 with and without moments, and ``detect_select`` (the same launch
   with the fused flagship's premasked block top-k, K 512, margin 16), bit
   for bit; the AKAZE ladder at its defaults on the
   pair and on one VO frame, bit for bit): max
   error and median ms of both; each kernel's device ms (a CUDA graph of 20
   calls replayed, per call) and device launches per call (a trace), the
   Sinkhorn kernel at 513 and 1025, the sampler
   also in the dense matcher's bilinear mode, the select kernel also as the
   flagship's whole ``ops.nms_select_topk``, the detect frontend also as
   ``detect_select``, the ladder also at B=1. The sampler's stage ablation at the
   flagship's inputs (full = the sampler kernel = its plain version, bit for
   bit; no box sums = its plain definition, bit for bit; no load finite; no
   store leaves the buffer untouched), and the sampler in bilinear mode at
   the dense matcher's inputs (1024 keypoints, margin 0).
3. The flagship slice through ``models.build(..., device="cuda")``: launch
   counts of one run, agreement with the same slice on CPU copies, a
   self-match and a known-shift check, and the median ms per pair.
4. The flagship with ``fused_detect=True`` (one detect-frontend launch,
   ``detect_select``, for detection and selection; no select-frontend
   kernel): the checks of phase 3, plus fused vs unfused keypoints and
   descriptors on the card.
5. The AKAZE matcher at its registry defaults (1024 keypoints, 512 pairs):
   the checks of phase 3, then where its GPU and CPU runs part, stage by
   stage (printed, not checked).
6. The flagship with its ratio / dustbin filters and the unoriented
   matcher, as phase 3 (512 keypoints); the filters also fill >= 90% of the
   slots on a self-match and give the same masks on the card and the CPU.
7. The VO device path: 16 frames of a camera translating over a non-planar
   texture (``vo_sequence``) through the streaming split of the AKAZE
   essential pipeline (registry defaults, BASELINE config #5) and of the
   flagship essential pipeline with the in-graph RANSAC (256 hypotheses, 2
   polish steps), 100 matches at threshold 0.1, as the VO loop runs them:
   launch counts per frame, streaming vs two-image on the card, E on the
   card vs the CPU, E finite and rank 2, the median Sampson error of the
   valid matches; ms per frame for extract and match, host syncs per frame.
   Then (R, t) of every frame by the port's NumPy ``recover_pose`` (no
   OpenCV) from the card's E and matches and from the CPU's, against the
   truth (R = I, t along +-x): per-frame rotation and t-direction errors,
   medians and failures side by side; the card's median rotation error at
   most the CPU's + 0.3 deg, its failures at most the CPU's + 1, the RANSAC
   flagship's inside absolute bars.
8. The dense family at 480x640: the dense matcher
   ``shi_tomasi_bad_sinkhorn`` at its registry defaults (1024 keypoints, 512
   pairs sampled bilinearly, a 1025x1025 Sinkhorn) as phase 3, and its
   streaming split against the two-image call; the ``bad`` and
   ``shi_tomasi_bad`` heads (static shifts) card vs CPU; the oriented dense
   map (P=256, every pixel a keypoint) by the sampler kernel against the
   gather route, both on the card, with its ms and peak memory; the
   ``shi_tomasi_angle_sparse_bad`` head with and without ``fused_detect``,
   card vs CPU.
9. The device functions of the three image CLIs on the card (counts,
   shapes, the 7-px shift), then the sampler's stage ablation
   (``tools.ablate_sampler``), its JSON lines printed.
10. The rest of the op library and the serving layer, card vs CPU at the
   sizes users run: FAST (defaults, and NMS radius 3) and DoG (5 scales, 39
   taps; launches and ms per call) on the 480x640 pair; voxel downsampling
   of 38,400 and 8,192 points (leaf 0.05) against a float64 oracle; Otsu
   and 3-class multi-Otsu on a 480x640 uint8 image; point cloud, normals
   and depth alignment of a 480x640 depth map (some projections in
   [W - 0.5, W)); ``refine_keypoints_subpixel`` at the flagship's 512
   keypoints; the feature-detection CLI's ``detect`` with ``fast`` and
   ``dog_with_score``; then ``stream_map_chunked(models.build_batched(...))``
   of the flagship over 22 pairs at chunk 1, 4, 8 and depth 1, 2, and
   ``stream_map`` of its streaming extract at depth 1, 2, each held to the
   per-pair sequential loop on the card, with pairs/s on the host clock
   and the device launches per chunk.
11. Export on the card (``torch.export``): the flagship, the flagship with
   ``fused_detect=True`` and the AKAZE matcher (``_extraction`` forms,
   480x640, 512 keypoints, 256 matches) exported on CUDA, saved to a
   temporary directory and loaded back: the graph holds the kernels' op
   nodes, the loaded module's outputs equal the eager module's bit for bit
   on the pair, and one loaded call launches each kernel as often as one
   eager call (> 0); export and load seconds, ms per pair eager vs loaded.
   The flagship's dynamic artifact equals eager at 480x640 and 240x320, and
   its streaming pair (extract, match) matches the two-image matcher
   (keypoints equal, P within 1e-5).
12. The mesh and the soak: ``parallel.shard_batch(models.build_batched(
   flagship), parallel.make_mesh())`` over 4 texture pairs against the
   unsharded call (bit for bit, the same launches); then
   ``tools.soak``: 120 seeded draws of the flagship, AKAZE, essential, ties
   and ragged Sinkhorn families, each on the card and on the CPU, compared,
   held to the soak's invariants and to the launches of its path; the
   draws per family, failures and seconds.
13. The CLIs' chain protocol on the card (``cli.common``): the flagship, the
   fused flagship, AKAZE, the dense, unoriented and with-filters matchers
   (``_extraction`` forms, 256 matches) on the pair, and the heads
   ``shi_tomasi``, ``fast``, ``dog_with_score``, ``akaze`` on its first
   image and ``voxel_downsampling`` on 8,192 points: a CUDA graph of one
   call, replayed 5 times on the path's inputs and a second input in turn
   (the texture pair; the points' axes mirrored), equals the eager call on
   the same inputs bit for bit; then
   ``chain_times`` at n = 30 (two graphs of 30 and 90 chained calls) and
   the host loop of ``run_benchmark``, with the graph's nodes, the capture
   seconds and the peak memory, one JSON line per path. The essential
   matcher must refuse the chain (``ValueError``) before any capture.

The last two lines are a JSON object of per-kernel results (each with its
launches on the paths, launches per call of its path, error against its
plain version, ms, plain ms, device ms and device launches per call, the
card's bound for the same work and what bounds it, and ``library_ms``:
null, no single PyTorch call computes any of them) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

H, W = 480, 640
MAX_KEYPOINTS, MAX_MATCHES = 512, 256
SHIFT_X = 7
VO_FRAMES, VO_STEP = 16, 3.0   # phase 7: frames and px of x-motion per frame (at d = 1)
FLAGSHIP = "shi_tomasi_angle_sparse_bad_sinkhorn"
FILTERS = FLAGSHIP + "_with_filters"
UNORIENTED = "shi_tomasi_sparse_bad_sinkhorn"
AKAZE = "akaze_sparse_bad_sinkhorn"
DENSE = "shi_tomasi_bad_sinkhorn"
HEAD = "shi_tomasi_angle_sparse_bad"
ABLATE = "sparse_sampler_ablate"   # counted only by the ablation's own run

# Tolerances on the card, kernel vs plain version.
SAMPLER_ATOL = 1e-3     # box means of [0, 255] pixels
SINKHORN_ATOL = 1e-5    # transport probabilities
# The dustbin corner of P (the unmatched mass, ~N) on the served pairs:
# float32 puts it ~5e-7 relative from float64, and two float32 sum orders
# part there by up to ~1e-6 (phase 10 prints both); a factor 2 on that.
SINKHORN_CORNER_RTOL = 2e-6
MARGINAL_ATOL = 1e-3    # column sums after the final column sweep
# The detect frontend (alone and as detect_select), the AKAZE ladder and the
# select kernel are held to bit-identity.
# GPU slice vs CPU slice.
KPT_SWAPS = 2           # symmetric set difference of keypoints, per image
P_ATOL = 5e-3           # P on the keypoints both runs selected
VALID_RTOL = 0.02       # count of valid matches
SELF_MIN_VALID = MAX_MATCHES  # self-match fills every slot on the card and the CPU
DESC_ATOL = 2e-3        # fused vs unfused descriptors on common keypoints
FILTERS_SELF_MIN = int(0.9 * MAX_MATCHES)  # with-filters self-match: >= 90% of slots
# Phase 7, the VO device path (the VO CLI's settings).
VO_MAX_MATCHES, VO_MATCH_THRESHOLD = 100, 0.1
RANK2_MAX = 1e-3        # sigma3 / sigma1 of every E
E_ATOL = 1e-2           # LS solve's E, card vs CPU, unit norm, up to sign
SAMPSON_PX = 2.0        # median Sampson error bound (SAMPSON_PX / fx)^2
# AKAZE's soft LS solve does not meet that bound on these frames in JAX
# either: JAX 0.9.0 on the CPU gives a pooled median Sampson error of
# 4364.585 x (2 / fx)^2 (the port on the CPU 4351.251 x). The AKAZE path is
# held to 1.5x JAX's value; the RANSAC flagship to the bound itself.
JAX_AKAZE_SAMPSON_RATIO = 4364.585
# Poses from each frame's E (the port's NumPy recover_pose, 2-px Sampson
# votes), card vs CPU on the same frames: the card's median rotation error
# at most the CPU's + 0.3 deg, its failures at most the CPU's + 1. The
# RANSAC flagship's poses on the CPU (the port, torch 2.13.0+cpu):
# median rotation error 0.0160 deg (max 0.039), median t-direction error
# 5.62 deg, 0 failures of 15; its absolute bars leave 0.084 deg, 9.38 deg
# and 1 failure of headroom. The AKAZE path's soft LS E misses the 2-px
# vote on 14 of 15 frames on the CPU too (its Sampson error, above): no
# absolute bar.
POSE_ROT_GAP_DEG, POSE_FAIL_SLACK = 0.3, 1
POSE_BARS_RANSAC = (0.1, 15.0, 1)   # median rotation deg, median t-direction deg, failures
# Phase 8, the dense family.
DENSE_ATOL = 1e-4       # static-shift dense maps, card vs CPU
ORIENTED_ATOL = 2e-3    # oriented map, sampler kernel vs gather (tests/test_bad_parity.py:183)
HEAD_DESC_FRAC = 0.01   # head: share of common keypoints whose descriptors differ past DESC_ATOL
SCORE_RTOL = 1e-5       # Shi-Tomasi score maps, card vs CPU, relative to the map's max
CLI_COUNT_RTOL = 0.02   # CLI keypoint counts, card vs CPU
# Phase 10, the rest of the op library and the serving layer (card vs CPU).
DOG_ATOL = 1e-4         # DoG bands and score on [0, 255] images
VOXEL_LEAF = 0.05
VOXEL_ORACLE_ATOL = 2e-4  # centroids vs a float64 oracle (tests/test_aux_ops.py:212)
OTSU_VAR_RTOL = 1e-6    # thresholds that part must be a near-tie of the between-class variance
PCD_ATOL, NORMAL_ATOL = 1e-5, 1e-4
REFINE_ATOL = 1e-5      # refined keypoints and scores
SERVE_P_ATOL = 1e-5     # batched vs per-pair P (tests/test_parallel.py:246-248)
SERVE_PAIRS, SERVE_CHUNKS, SERVE_DEPTHS = 22, (1, 4, 8), (1, 2)
SERVE_REPS = 5          # timed streams per (chunk, depth)
# Phase 12: the mesh at B = 4, then the soak: its draws from one seed, the
# families in turn with Sinkhorn twice (seed 0's first 30 draws already
# hold every family at least twice, 4 ragged Sinkhorn draws at B >= 4, a
# hi-res AKAZE draw on the ladder's global route, ties draws in both top-k
# modes; 120 draws took 54-56 s on an H100).
MESH_B = 4
SOAK_SEED, SOAK_ITERS = 0, 120
SOAK_FAMILIES = ("flagship", "akaze", "essential", "ties", "sinkhorn", "sinkhorn")
# Peak rates of one H100 SXM: HBM3 bandwidth and dense FP32 throughput.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def bench_pair(seed: int = 0):
    """bench.py's synthetic pair: a periodic pattern, the second image rolled
    7 px in x, each with its own noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 127 + 80 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    img1 = np.clip(base + rng.normal(0, 3, (H, W)), 0, 255)
    img2 = np.clip(np.roll(base, SHIFT_X, 1) + rng.normal(0, 3, (H, W)), 0, 255)
    return (img1.astype(np.float32)[None, None], img2.astype(np.float32)[None, None])


def _blur(a, r):
    """Box blur of radius r along both axes, edges replicated."""
    k = 2 * r + 1
    for ax in (0, 1):
        pad = [(r + 1, r) if i == ax else (0, 0) for i in range(2)]
        c = np.cumsum(np.pad(a, pad, mode="edge"), axis=ax)
        n = c.shape[ax]
        a = (np.take(c, range(k, n), axis=ax) - np.take(c, range(0, n - k), axis=ax)) / k
    return a


def _texture(rng, h, w):
    """Non-periodic texture: blurred uniform noise scaled to [0, 255]."""
    tex = _blur(_blur(_blur(rng.uniform(0, 1, (h, w)), 2), 2), 2)
    return 255 * (tex - tex.min()) / (tex.max() - tex.min())


def texture_pair(seed: int = 1):
    """A non-periodic texture (blurred uniform noise) and its 7-px x-roll.
    bench.py's lattice repeats every ~56 px, so its matches cannot pin the
    shift; this texture's can."""
    rng = np.random.default_rng(seed)
    tex = _texture(rng, H, W)
    img1 = np.clip(tex + rng.normal(0, 3, (H, W)), 0, 255)
    img2 = np.clip(np.roll(tex, SHIFT_X, 1) + rng.normal(0, 3, (H, W)), 0, 255)
    return (img1.astype(np.float32)[None, None], img2.astype(np.float32)[None, None])


def vo_sequence(n_frames: int = VO_FRAMES, step: float = VO_STEP, seed: int = 2):
    """Frames of a camera translating in x over a textured, non-planar
    scene: frame i samples one larger texture at x + i * step * d(x, y),
    with d, the inverse depth, a smooth non-affine bump field in [0.6, 1.4].
    A pure pan (one shift for every pixel) would make the 8-point system
    degenerate (a 3-dim null space); the parallax keeps E unique
    (the camera's x-translation, epipolar lines horizontal). Each frame
    gets its own noise; (1, 1, H, W) float32 each."""
    rng = np.random.default_rng(seed)
    amp = 0.4
    tex = _texture(rng, H, W + int(np.ceil((n_frames - 1) * step * (1 + amp))) + 2)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    d = 1 + amp * np.sin(2 * np.pi * xx / W * 1.3 + 0.7) * np.cos(2 * np.pi * yy / H * 0.9)
    frames = []
    for i in range(n_frames):
        xs = xx + i * step * d
        x0 = np.floor(xs).astype(int)
        f = xs - x0
        img = ((1 - f) * np.take_along_axis(tex, x0, 1) + f * np.take_along_axis(tex, x0 + 1, 1)
               + rng.normal(0, 2, (H, W)))
        frames.append(np.clip(img, 0, 255).astype(np.float32)[None, None])
    return frames


def common_rows(a, b):
    """Rows of the keypoint sets ``a`` and ``b`` ((K, 2) each) with equal
    coordinates, as index arrays into each, and the symmetric set difference."""
    inv_a = {tuple(v): i for i, v in enumerate(a.tolist())}
    inv_b = {tuple(v): i for i, v in enumerate(b.tolist())}
    shared = sorted(set(inv_a) & set(inv_b))
    return ([inv_a[v] for v in shared], [inv_b[v] for v in shared],
            len(set(inv_a) ^ set(inv_b)))


def p_common_diff(k1a, k2a, pa, k1b, k2b, pb) -> tuple[float, int]:
    """Max |P_a - P_b| over the keypoints both runs selected (plus the
    dustbin), matched by coordinates; returns it and the swap count."""
    ia1, ib1, s1 = common_rows(k1a, k1b)
    ia2, ib2, s2 = common_rows(k2a, k2b)
    # The dustbin row and column pair up too.
    ia1, ib1, ia2, ib2 = ia1 + [len(k1a)], ib1 + [len(k1b)], ia2 + [len(k2a)], ib2 + [len(k2b)]
    swaps = max(s1, s2)
    diff = np.abs(pa[np.ix_(ia1, ia2)] - pb[np.ix_(ib1, ib2)])
    return float(diff.max()), swaps


def run_path(label, name, overrides, g_pair, c_pair, expect_zero=(), self_min=0):
    """Drive one path end to end on the card: launch counts of one run (each
    kernel of the path > 0, those in ``expect_zero`` = 0), agreement with the
    same path on CPU copies, a self-match (identical coordinates in at least
    as many slots as the CPU run and ``self_min``) and the texture shift;
    prints the ms per pair. Outputs past the fourth (the filters' valid
    mask) pass through. Returns the launch counts, the CUDA matcher and the
    matcher's outputs on the card and on the CPU, as numpy arrays."""
    import torch
    from onnx_image_processing_tpu_torch import models
    from onnx_image_processing_tpu_torch.kernels import launch_counts, reset_launch_counts

    dev = g_pair[0].device
    kw = dict(max_matches=MAX_MATCHES, **overrides)
    extraction = models.build(name + "_extraction", device=dev, **kw)
    reset_launch_counts()
    out = extraction(*g_pair)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_counts(label, counts, set(counts) - {*expect_zero, ABLATE})
    mk1, mk2, ms, mv, *_ = (t.cpu().numpy() for t in out)
    check(mk1.shape == (1, MAX_MATCHES, 2) and ms.shape == (1, MAX_MATCHES),
          f"[{label}] extraction output shapes {mk1.shape} {ms.shape}")
    check(bool(np.isfinite(ms).all() and np.isfinite(mk1).all()), f"[{label}] non-finite outputs")

    matcher = models.build(name, device=dev, **kw)
    cpu_matcher = models.build(name, device="cpu", **kw)
    cpu_extraction = models.build(name + "_extraction", device="cpu", **kw)
    k = matcher.cfg.max_keypoints
    gout = [t.cpu().numpy() for t in matcher(*g_pair)]
    cout = [t.numpy() for t in cpu_matcher(*c_pair)]
    (k1g, k2g, pg), (k1c, k2c, pc) = gout[:3], cout[:3]
    check(bool(np.isfinite(pg).all()) and pg.shape == (1, k + 1, k + 1),
          f"[{label}] P shape {pg.shape} or non-finite")
    p_diff, swaps = p_common_diff(k1g[0], k2g[0], pg[0], k1c[0], k2c[0], pc[0])
    print(f"[{label}] GPU vs CPU: keypoint set difference {swaps} (max {KPT_SWAPS}), "
          f"P max abs diff on common keypoints {p_diff:.3e} (max {P_ATOL})")
    check(swaps <= KPT_SWAPS, f"[{label}] keypoint sets differ by {swaps}")
    check(p_diff <= P_ATOL, f"[{label}] P differs by {p_diff}")
    nv_g = int(mv.sum())
    nv_c = int(cpu_extraction(*c_pair)[3].sum())
    print(f"[{label}] valid matches: GPU {nv_g}, CPU {nv_c}")
    check(abs(nv_g - nv_c) <= VALID_RTOL * nv_c, f"[{label}] valid match counts differ by more than 2%")

    sk1, sk2, _, sv, *_ = (t.cpu().numpy() for t in extraction(g_pair[0], g_pair[0]))
    self_valid = int(sv.sum())
    self_cpu = int(cpu_extraction(c_pair[0], c_pair[0])[3].sum())
    same = bool((sk1[sv] == sk2[sv]).all())
    print(f"[{label}] self-match: {self_valid} of {MAX_MATCHES} slots valid (CPU {self_cpu}), "
          f"identical coordinates: {same}")
    check(same and self_valid >= max(self_cpu, self_min), f"[{label}] self-match")

    t1, t2 = (torch.from_numpy(a).to(dev) for a in texture_pair())
    tk1, tk2, _, tv, *_ = (t.cpu().numpy() for t in extraction(t1, t2))
    d = (tk2 - tk1)[tv]
    dx, dy = float(np.median(d[:, 1])), float(np.median(d[:, 0]))
    print(f"[{label}] shift: texture rolled {SHIFT_X} px in x -> {int(tv.sum())} valid "
          f"matches, median dx {dx}, dy {dy}")
    check(abs(dx - SHIFT_X) <= 1 and abs(dy) <= 1, f"[{label}] shift not recovered")

    print(f"[{label}] {median_ms(extraction, g_pair):.3f} ms per pair (median of 20 calls, "
          f"host clock around synchronized calls)")
    return counts, matcher, (gout, cout)


def check_counts(label, counts, expect_positive) -> None:
    """Every kernel in ``expect_positive`` launched, every other one not."""
    print(f"[{label}] launches:", json.dumps(counts, sort_keys=True))
    for k, c in counts.items():
        if k in expect_positive:
            check(c > 0, f"[{label}] kernel {k} was not launched")
        else:
            check(c == 0, f"[{label}] kernel {k} launched {c} times, expected none")


def median_ms(fn, args, warmup: int = 5, reps: int = 20) -> float:
    """Median host-clock ms of ``fn(*args)`` between synchronizes."""
    import torch

    times = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def synced_ms(fn) -> tuple[float, object]:
    """Host-clock ms of one call between two synchronizes, and its result."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def run_dense(g_pair, c_pair, paths: dict) -> None:
    """Phase 8: the dense matcher as a path, its streaming split, the dense
    heads (static shifts) card vs CPU, the oriented dense map (sampler
    kernel vs gather, both on the card) and the single-image sparse head
    with and without the detect frontend. Adds each counted run to
    ``paths``."""
    import torch
    from onnx_image_processing_tpu_torch import models, ops
    from onnx_image_processing_tpu_torch.kernels import launch_counts, reset_launch_counts

    dev = g_pair[0].device
    g1, c1 = g_pair[0], c_pair[0]
    paths["dense"] = run_path("dense", DENSE, {}, g_pair, c_pair,
                              expect_zero=("detect_frontend", "akaze_ladder"))[0]

    extract, match = models.build_streaming(DENSE + "_extraction", device=dev,
                                            max_matches=MAX_MATCHES)
    s_out = match(extract(g_pair[0]), extract(g_pair[1]))
    t_out = models.build(DENSE + "_extraction", device=dev, max_matches=MAX_MATCHES)(*g_pair)
    same = all(torch.equal(a, b) for a, b in zip(s_out, t_out))
    print(f"[dense] streaming vs two-image on the card: bit-identical {same}")
    check(same, "[dense] the streaming split differs from the two-image call")

    for name in ("bad", "shi_tomasi_bad"):
        head = models.build(name, device=dev)
        reset_launch_counts()
        ms, g = synced_ms(lambda: head(g1))
        counts = launch_counts()
        c = models.build(name, device="cpu")(c1)
        # bad returns the map; shi_tomasi_bad the scores and the map.
        (gs, gm), (cs, cm) = ((None, g), (None, c)) if name == "bad" else (g, c)
        d_err = (gm.cpu() - cm).abs().max().item()
        s_err = 0.0 if cs is None else ((gs.cpu() - cs).abs().max() / cs.abs().max()).item()
        print(f"[{name}] card vs CPU, {tuple(cm.shape)}: "
              f"map max abs diff {d_err:.3e} (max {DENSE_ATOL}), score max diff relative "
              f"to the map's max {s_err:.3e} (max {SCORE_RTOL}); {ms:.3f} ms on the card "
              f"(one call); launches {json.dumps(counts, sort_keys=True)}")
        check(d_err <= DENSE_ATOL, f"[{name}] dense map differs by {d_err}")
        check(s_err <= SCORE_RTOL, f"[{name}] scores differ by {s_err} of their max")

    table = models.build("bad", device=dev).table
    theta = ops.angle_estimation(g1)
    routes = {}
    for route in ("tiled", "gather"):
        ops.dense_bad(g1, table, orientation=theta, oriented_route=route)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launch_counts()
        ms, out = synced_ms(lambda: ops.dense_bad(g1, table, orientation=theta,
                                                  oriented_route=route))
        counts = launch_counts()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        routes[route] = out
        print(f"[oriented map] {route}: {tuple(out.shape)}, {ms:.3f} ms (one synchronized "
              f"call after a warm-up), peak memory {peak:.1f} MiB above the inputs, "
              f"sampler launches {counts['sparse_sampler']}")
        if route == "tiled":
            check_counts("oriented map", counts, ("sparse_sampler",))
            paths["oriented map"] = counts
    err = (routes["tiled"] - routes["gather"]).abs().max().item()
    print(f"[oriented map] sampler kernel vs gather on the card: max abs diff {err:.3e} "
          f"(max {ORIENTED_ATOL})")
    check(err <= ORIENTED_ATOL, f"[oriented map] tiled vs gather differ by {err}")

    for fused in (False, True):
        label = f"{HEAD}{' fused' if fused else ''}"
        head = models.build(HEAD, device=dev, fused_detect=fused)
        reset_launch_counts()
        kg, sg, dg = (t.cpu().numpy() for t in head(g1))
        torch.cuda.synchronize()
        counts = launch_counts()
        check_counts(label, counts, ("sparse_sampler",
                                     "detect_frontend" if fused else "select_frontend"))
        paths[label] = counts
        kc, sc, dc = (t.numpy() for t in models.build(HEAD, device="cpu",
                                                       fused_detect=fused)(c1))
        ig, ic, swaps = common_rows(kg[0], kc[0])
        off = (np.abs(dg[0][ig] - dc[0][ic]).max(-1) > DESC_ATOL).mean()
        d_err = float(np.abs(dg[0][ig] - dc[0][ic]).max())
        print(f"[{label}] card vs CPU: keypoint set difference {swaps} (max {KPT_SWAPS}); "
              f"descriptors on {len(ig)} common keypoints: max abs diff {d_err:.3e}, share "
              f"past {DESC_ATOL} {off:.4f} (max {HEAD_DESC_FRAC})")
        check(kg.shape == (1, head.cfg.max_keypoints, 2) and bool(np.isfinite(dg).all()),
              f"[{label}] output shapes or values")
        check(swaps <= KPT_SWAPS and off <= HEAD_DESC_FRAC, f"[{label}] card vs CPU")


def run_clis(g_pair, c_pair) -> None:
    """Phase 9, first half: the device functions of the three image CLIs on
    the card (image I/O and drawing need PIL, which is not needed here),
    with the CLIs' host post-processing."""
    from onnx_image_processing_tpu_torch import models
    from onnx_image_processing_tpu_torch.cli import image_matching, image_matching_extraction
    from onnx_image_processing_tpu_torch.utils import extract_matches

    dev = g_pair[0].device
    cli_detect_counts("cli feature_detection", ("shi_tomasi", "shi_tomasi_angle"),
                      g_pair[0], c_pair[0])

    t1, t2 = texture_pair()
    k1, k2, p = image_matching.match(models.build(FLAGSHIP, device=dev,
                                                  max_keypoints=MAX_KEYPOINTS), t1, t2)
    mk1, mk2, _ = extract_matches(p, k1, k2, threshold=0.1, max_matches=100)
    check(p.shape == (1, MAX_KEYPOINTS + 1, MAX_KEYPOINTS + 1), "[cli image_matching] P shape")
    em1, em2, _ = image_matching_extraction.match(
        models.build(FLAGSHIP + "_extraction", device=dev, max_keypoints=MAX_KEYPOINTS), t1, t2)
    for label, a, b in (("image_matching", mk1, mk2),
                        ("image_matching_extraction", em1, em2)):
        d = b - a
        dx, dy = (float(np.median(d[:, 1])), float(np.median(d[:, 0]))) if len(d) else (0, 0)
        print(f"[cli {label}] {len(a)} matches on the texture rolled {SHIFT_X} px: "
              f"median dx {dx}, dy {dy}")
        check(len(a) > 0 and abs(dx - SHIFT_X) <= 1 and abs(dy) <= 1,
              f"[cli {label}] shift not recovered")


def cli_detect_counts(label, names, g_img, c_img, max_keypoints: int = 1000) -> None:
    """The feature-detection CLI's device function on the card and the CPU,
    then its host selection (the CLI's defaults, ``-k max_keypoints``):
    keypoint counts within CLI_COUNT_RTOL."""
    from onnx_image_processing_tpu_torch import models
    from onnx_image_processing_tpu_torch.cli import feature_detection
    from onnx_image_processing_tpu_torch.utils import select_keypoints

    img = c_img.numpy()
    for name in names:
        sg = feature_detection.detect(models.build(name, device=g_img.device), img)
        sc = feature_detection.detect(models.build(name, device="cpu"), img)
        kw = dict(threshold=0.01, max_keypoints=max_keypoints, nms_radius=3, subpixel=True)
        ng, nc = len(select_keypoints(sg, **kw)), len(select_keypoints(sc, **kw))
        print(f"[{label} {name}] score map {sg.shape}, keypoints: card {ng}, CPU {nc}")
        check(sg.shape == (1, 1, H, W) and bool(np.isfinite(sg).all()),
              f"[{label} {name}] score map")
        check(ng > 0 and abs(ng - nc) <= CLI_COUNT_RTOL * nc,
              f"[{label} {name}] keypoint counts {ng} vs {nc}")


def voxel_f64_oracle(pts: np.ndarray, leaf: float):
    """Centroids per voxel in sorted-key order, float64 (the JAX test's
    ``_voxel_f64_oracle``, tests/test_aux_ops.py)."""
    vox = np.floor(pts.astype(np.float64) / leaf).astype(np.int64)
    vox -= vox.min(0)
    vmax = vox.max(0)
    key = vox[:, 0]
    for a in range(1, pts.shape[1]):
        key = key * (vmax[a] + 1) + vox[:, a]
    order = np.argsort(key, kind="stable")
    sk, sp = key[order], pts.astype(np.float64)[order]
    _, start = np.unique(sk, return_index=True)
    ends = np.append(start[1:], len(sk))
    return np.stack([sp[s:e].mean(0) for s, e in zip(start, ends)])


def between_class_variance(hist: np.ndarray, thresholds) -> float:
    """sum_{i<j} n_i n_j (mu_i - mu_j)^2 (float64) of the classes that end
    at each threshold's bin (bin values 0, 1, ...)."""
    edges = [0] + [int(t) + 1 for t in thresholds] + [len(hist)]
    vals = np.arange(len(hist), dtype=np.float64)
    n = [hist[a:b].sum() for a, b in zip(edges[:-1], edges[1:])]
    mu = [(hist[a:b] * vals[a:b]).sum() / max(k, 1) for a, b, k in zip(edges[:-1], edges[1:], n)]
    return float(sum(n[i] * n[j] * (mu[i] - mu[j]) ** 2
                     for i in range(len(n)) for j in range(i + 1, len(n))))


def run_ops(g_pair, c_pair) -> None:
    """Phase 10, first half: FAST, DoG, voxel downsampling, Otsu, the depth
    ops and the in-graph sub-pixel refinement, card vs CPU on the same
    inputs; the CLI's detect with FAST and DoG. None of them launches a
    hand kernel (checked)."""
    import torch
    from onnx_image_processing_tpu_torch import models, ops
    from onnx_image_processing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from onnx_image_processing_tpu_torch.tools.kernel_times import device_launches

    dev = g_pair[0].device
    both_g, both_c = torch.cat(g_pair), torch.cat(c_pair)
    reset_launch_counts()
    for kw in ({}, dict(fast_use_nms=True, fast_nms_radius=3)):
        fg = models.build("fast", device=dev, **kw)(both_g)
        fc = models.build("fast", device="cpu", **kw)(both_c)
        same = torch.equal(fg.cpu(), fc)
        print(f"[fast {kw or 'defaults'}] {tuple(fg.shape)}: corners card "
              f"{int(fg.sum())}, CPU {int(fc.sum())}, maps equal {same}")
        check(same and fc.sum() > 0, f"[fast {kw}] card and CPU maps differ")

    for name in ("dog", "dog_with_score"):
        head = models.build(name, device=dev)
        g = head(both_g)
        c = models.build(name, device="cpu")(both_c)
        err = (g.cpu() - c).abs().max().item()
        times = [synced_ms(lambda: head(both_g))[0] for _ in range(5)]
        print(f"[{name}] {tuple(g.shape)}: card vs CPU max abs diff {err:.3e} (max {DOG_ATOL}); "
              f"{np.median(times):.3f} ms per call (median of 5, host clock around a "
              f"synchronized call), {device_launches(lambda: head(both_g))} device launches "
              f"per call")
        check(err <= DOG_ATOL, f"[{name}] card and CPU differ by {err}")

    rng = np.random.default_rng(3)
    for n in (38400, models.VOXEL_EXPORT_POINTS):
        pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        fg, fcpu = models.build("voxel_downsampling", device=dev), \
            models.build("voxel_downsampling", device="cpu")
        p_g, leaf_g = torch.from_numpy(pts).to(dev), torch.tensor(np.float32(VOXEL_LEAF), device=dev)
        out_g, mask_g = fg(p_g, leaf_g)
        out_c, mask_c = fcpu(torch.from_numpy(pts), torch.tensor(np.float32(VOXEL_LEAF)))
        oracle = voxel_f64_oracle(pts, VOXEL_LEAF)
        m = int(mask_c.sum())
        same_mask = torch.equal(mask_g.cpu(), mask_c)
        ms = np.median([synced_ms(lambda: fg(p_g, leaf_g))[0] for _ in range(5)])
        err_g = float(np.abs(out_g.cpu().numpy()[:m] - oracle[:m]).max()) if m == len(oracle) else np.inf
        err_c = float(np.abs(out_c.numpy()[:m] - oracle[:m]).max()) if m == len(oracle) else np.inf
        print(f"[voxel N={n}] M card {int(mask_g.sum())}, CPU {m}, oracle {len(oracle)}; masks "
              f"equal {same_mask}; centroids vs the float64 oracle: card {err_g:.3e}, CPU "
              f"{err_c:.3e} (max {VOXEL_ORACLE_ATOL}); {ms:.3f} ms per call on the card")
        check(same_mask and m == len(oracle) and err_g <= VOXEL_ORACLE_ATOL,
              f"[voxel N={n}] mask, M or centroids")

    gray = np.clip(np.round(c_pair[0].numpy()[0, 0]), 0, 255).astype(np.uint8)
    hist = np.bincount(gray.reshape(-1), minlength=256).astype(np.float64)
    img_g, img_c = torch.from_numpy(gray).to(dev), torch.from_numpy(gray)
    for label, fn, bins in (
            ("otsu", lambda x: (ops.otsu_threshold(x, 0, 255)[0],), 256),
            ("multi-otsu n_class=3", lambda x: ops.multi_otsu_threshold(x, 0, 255, n_class=3), 255)):
        tg = [int(t) for t in fn(img_g)]
        tc = [int(t) for t in fn(img_c)]
        vg, vc = between_class_variance(hist[:bins], tg), between_class_variance(hist[:bins], tc)
        print(f"[{label}] {gray.shape} uint8: thresholds card {tg}, CPU {tc}; between-class "
              f"variance card {vg:.10e}, CPU {vc:.10e}")
        check(tg == tc or abs(vg - vc) <= OTSU_VAR_RTOL * max(vg, vc),
              f"[{label}] thresholds part and are not a near-tie")
    _, bin_g = ops.otsu_threshold(img_g, 0, 255)
    check(torch.equal(bin_g.cpu(), ops.otsu_threshold(img_c, 0, 255)[1]), "[otsu] binarized images")

    depth = np.random.default_rng(5).uniform(0.5, 3.0, (H, W)).astype(np.float32)
    d_g, d_c = torch.from_numpy(depth).to(dev), torch.from_numpy(depth)
    intr = dict(cx=W / 2, cy=H / 2, fx=500.0, fy=500.0)
    (pg, ng), (pc, nc) = (ops.depth_to_pointcloud_with_normal(d, **intr) for d in (d_g, d_c))
    p_err, n_err = (pg.cpu() - pc).abs().max().item(), (ng.cpu() - nc).abs().max().item()
    rot, trans = torch.eye(3), torch.tensor([0.005, 0.005, 0.0])
    align = dict(width=W, height=H, depth_cx=W / 2, depth_cy=H / 2, depth_fx=500.0,
                 depth_fy=500.0, rgb_cx=W / 2, rgb_cy=H / 2, rgb_fx=500.0, rgb_fy=500.0)
    a_g = ops.depth_alignment(d_g, rot.to(dev), trans.to(dev), **align)
    a_c = ops.depth_alignment(d_c, rot, trans, **align)
    px, _ = ops.points_to_pixels(ops.transform_points(pc.reshape(-1, 3), rot, trans),
                                 W / 2, H / 2, 500.0, 500.0)
    edge = int(((px >= W - 0.5) & (px < W)).sum())
    same = torch.equal(a_g.cpu(), a_c)
    print(f"[depth] {H}x{W}: point cloud card vs CPU {p_err:.3e} (max {PCD_ATOL}), normals "
          f"{n_err:.3e} (max {NORMAL_ATOL}); alignment equal {same} ({edge} projections in "
          f"[W - 0.5, W), {int((a_c > 0).sum())} pixels filled)")
    check(p_err <= PCD_ATOL and n_err <= NORMAL_ATOL, "[depth] point cloud or normals")
    check(same and edge > 0, "[depth] alignment differs, or no projection tests the edge")

    scores = ops.shi_tomasi_score(both_c, 5)[:, 0]
    kpts, ks = ops.nms_select_topk(scores, MAX_KEYPOINTS, 0.0, 16, nms_radius=5)
    rg = [t.cpu() for t in ops.refine_keypoints_subpixel(scores.to(dev), kpts.to(dev), ks.to(dev))]
    rc = ops.refine_keypoints_subpixel(scores, kpts, ks)
    r_err = max((a - b).abs().max().item() for a, b in zip(rg, rc))
    moved = int((rc[0] != kpts).any(-1).sum())
    print(f"[refine] {tuple(kpts.shape)} keypoints ({moved} moved): card vs CPU max abs diff "
          f"{r_err:.3e} (max {REFINE_ATOL})")
    check(r_err <= REFINE_ATOL and moved > 0, f"[refine] card and CPU differ by {r_err}")

    # The texture (the pair's smooth lattice gives FAST few corners), with a
    # top-k past the count so the counts are the detectors'.
    tex = torch.from_numpy(texture_pair()[0])
    cli_detect_counts("cli feature_detection", ("fast", "dog_with_score"), tex.to(dev), tex,
                      max_keypoints=H * W)
    counts = launch_counts()
    check(not any(counts.values()), f"[phase 10 ops] a hand kernel was launched: {counts}")


def run_serving(dev, paths: dict, results: dict) -> None:
    """Phase 10, second half: the flagship served by
    ``stream_map_chunked(models.build_batched(...))`` over SERVE_PAIRS pairs
    at each (chunk, depth), and ``stream_map`` of its streaming extract,
    each against the per-pair sequential loop on the card; pairs/s on the
    host clock (host stacking and copies included), launches per chunk.
    Adds the counted serving runs to ``paths`` and each kernel's launches per
    chunk of 4 to ``results``."""
    import torch
    from onnx_image_processing_tpu_torch import models, ops
    from onnx_image_processing_tpu_torch.core import full_fp32
    from onnx_image_processing_tpu_torch.kernels import (launch_counts, reset_launch_counts,
                                                         select_frontend, sinkhorn_kernel,
                                                         sparse_sampler)
    from onnx_image_processing_tpu_torch.ops import sinkhorn as sinkhorn_ops
    from onnx_image_processing_tpu_torch.models.shi_tomasi_family import _sparse_detect_describe
    from onnx_image_processing_tpu_torch.parallel import stream_map, stream_map_chunked
    from onnx_image_processing_tpu_torch.tools.kernel_times import device_launches

    pairs = [texture_pair(100 + i) for i in range(SERVE_PAIRS)]
    fn = models.build(FLAGSHIP, max_keypoints=MAX_KEYPOINTS, device=dev)
    seq = [tuple(t.cpu().numpy()[0] for t in fn(torch.from_numpy(a).to(dev),
                                                  torch.from_numpy(b).to(dev)))
           for a, b in pairs]
    extract, _ = models.build_streaming(FLAGSHIP, max_keypoints=MAX_KEYPOINTS, device=dev)
    seq_ext = [tuple(t.cpu().numpy() for t in extract(torch.from_numpy(a).to(dev)))
               for a, _ in pairs]

    def compare(label, out, want, p_index):
        check(len(out) == len(want), f"[{label}] {len(out)} results for {len(want)} inputs")
        kpt_same = all(np.array_equal(o[0], w[0]) for o, w in zip(out, want))
        if p_index == 2:
            kpt_same = kpt_same and all(np.array_equal(o[1], w[1]) for o, w in zip(out, want))
        err = max(float(np.abs(o[i] - w[i]).max()) for o, w in zip(out, want)
                  for i in range(p_index, len(w)))
        check(kpt_same and err <= SERVE_P_ATOL,
              f"[{label}] keypoints equal {kpt_same}, max abs diff {err:.3e}")
        return err

    # The Sinkhorn kernel gives each entry the same P whatever batch shares
    # its launch (the plan changes with B): the first 8 pairs' log-scores at
    # B = 8 and one at a time.
    both = torch.cat([torch.from_numpy(np.concatenate([p[i] for p in pairs[:8]])).to(dev)
                      for i in (0, 1)])
    _, _, desc = _sparse_detect_describe(both, fn.cfg, fn.table)
    sk = ops.sinkhorn_inputs(desc[:8], desc[8:], fn.cfg.epsilon, fn.cfg.unused_score)
    iters = fn.cfg.sinkhorn_iterations
    p8 = sinkhorn_kernel.sinkhorn_core(*sk, iters)
    same = all(torch.equal(p8[i:i + 1], sinkhorn_kernel.sinkhorn_core(
        *(t[i:i + 1].contiguous() for t in sk), iters)) for i in range(8))
    print(f"[serving] sinkhorn kernel at B = 8 ({sinkhorn_kernel.device_plan(513, 513, dev, 8)}) "
          f"vs each entry alone: bit-identical {same}")
    check(same, "[serving] the Sinkhorn kernel's P depends on the batch")

    # The served path's three kernels against their plain versions at its
    # shapes: Sinkhorn at B = 4 and 8 (plans whose lines share fewer warps
    # than at B = 1), select and the sampler on the chunk-8 stack of 16.
    # P's dustbin corner holds the unmatched mass (~500 here, a float32 ulp
    # 3e-5) and is held relatively; every other entry (<= 1) absolutely.
    for b in (4, 8):
        args = (*(t[:b].contiguous() for t in sk), iters)
        p_k = sinkhorn_kernel.sinkhorn_core(*args)
        p_p = sinkhorn_kernel.sinkhorn_core_plain(*args)
        p64 = sinkhorn_kernel.sinkhorn_core_plain(*(t.double() for t in args[:3]), iters)
        diff = (p_k - p_p).abs()
        corner_rel = (diff[:, -1, -1] / p_p[:, -1, -1]).max().item()
        rest = diff.clone()
        rest[:, -1, -1] = 0
        err = rest.max().item()
        rel64 = [((p[:, -1, -1].double() - p64[:, -1, -1]).abs() / p64[:, -1, -1]).max().item()
                 for p in (p_k, p_p)]
        print(f"[serving] sinkhorn B = {b} ({sinkhorn_kernel.device_plan(513, 513, dev, b)}) vs "
              f"plain: max abs err {err:.3e} (max {SINKHORN_ATOL}) off the dustbin corner, "
              f"corner {diff[:, -1, -1].max().item():.3e}, relative {corner_rel:.3e} (max "
              f"{SINKHORN_CORNER_RTOL}); corner relative to float64: kernel {rel64[0]:.3e}, "
              f"plain {rel64[1]:.3e}")
        check(err <= SINKHORN_ATOL and corner_rel <= SINKHORN_CORNER_RTOL,
              f"[serving] sinkhorn B = {b}: error {err}, corner relative {corner_rel}")
        results["sinkhorn"]["max_abs_err"] = max(results["sinkhorn"]["max_abs_err"],
                                                 diff.max().item())
    cfg, table = fn.cfg, fn.table
    scores = ops.shi_tomasi_score(both, cfg.block_size)[:, 0].contiguous()
    sel = (cfg.nms_radius, cfg.max_keypoints, cfg.score_threshold, table.max_radius)
    kp_k, ks_k = select_frontend.nms_select_blocks(scores, *sel)
    kp_p, ks_p = select_frontend.nms_select_blocks_plain(scores, *sel)
    same_sel = torch.equal(kp_k, kp_p) and torch.equal(ks_k, ks_p)
    mm = ops.angle_moments(both, patch_size=cfg.patch_size, sigma=cfg.sigma)
    smp = (*ops.box_sample_inputs(both, kp_k, table, mm), table.sample_radius, table.groups,
           56, table.max_radius)
    s_k, s_p = sparse_sampler.box_sample(*smp), sparse_sampler.box_sample_plain(*smp)
    same_smp = torch.equal(s_k, s_p)
    print(f"[serving] select {tuple(scores.shape)}, top {cfg.max_keypoints}: bit-identical to "
          f"plain {same_sel} ({int((ks_k > 0).sum())} valid); sampler {tuple(s_k.shape)}: "
          f"bit-identical {same_smp}")
    check(same_sel, "[serving] select not bit-identical on the 16-image stack")
    check(same_smp, "[serving] sampler not bit-identical on the 16-image stack")
    results["select_frontend"]["max_abs_err"] = max(
        results["select_frontend"]["max_abs_err"], (kp_k - kp_p).abs().max().item(),
        (ks_k - ks_p).abs().max().item())
    results["sparse_sampler"]["max_abs_err"] = max(
        results["sparse_sampler"]["max_abs_err"], (s_k - s_p).abs().max().item())

    fb = models.build_batched(FLAGSHIP, max_keypoints=MAX_KEYPOINTS, device=dev)
    reset_launch_counts()
    for chunk in SERVE_CHUNKS:
        for depth in SERVE_DEPTHS:
            list(stream_map_chunked(fb, pairs[:2 * chunk], chunk, depth))   # warm-up
            rates = []
            for rep in range(SERVE_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = list(stream_map_chunked(fb, pairs, chunk, depth))
                rates.append(SERVE_PAIRS / (time.perf_counter() - t0))
                if rep == 0:
                    err = compare(f"serving chunk {chunk} depth {depth}", out, seq, 2)
            print(f"[serving] stream_map_chunked(build_batched({FLAGSHIP})) chunk {chunk}, depth "
                  f"{depth}: {np.median(rates):.2f} pairs/s (median of {SERVE_REPS} streams of "
                  f"{SERVE_PAIRS} pairs, {min(rates):.2f}..{max(rates):.2f}; host clock, host "
                  f"stacking and copies included); keypoints equal to the per-pair loop, P max "
                  f"abs diff {err:.3e} (max {SERVE_P_ATOL})")
    for depth in SERVE_DEPTHS:
        rates = []
        for rep in range(SERVE_REPS):
            frames = (a for a, _ in pairs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = list(stream_map(lambda a: extract(torch.from_numpy(a).to(dev)), frames, depth))
            rates.append(SERVE_PAIRS / (time.perf_counter() - t0))
            if rep == 0:
                err = compare(f"stream_map extract depth {depth}", out, seq_ext, 1)
        print(f"[serving] stream_map(extract) depth {depth}: {np.median(rates):.2f} images/s "
              f"(median of {SERVE_REPS}, {min(rates):.2f}..{max(rates):.2f}); keypoints equal "
              f"to the sequential loop, scores and descriptors max abs diff {err:.3e}")
    torch.cuda.synchronize()
    paths["serving"] = launch_counts()
    check_counts("serving", paths["serving"],
                 set(paths["serving"]) - {"detect_frontend", "akaze_ladder", ABLATE})

    a4, b4 = (torch.from_numpy(np.concatenate([p[i] for p in pairs[:4]])).to(dev) for i in (0, 1))
    reset_launch_counts()
    fb(a4, b4)
    torch.cuda.synchronize()
    per_chunk = launch_counts()
    print(f"[serving] one chunk of 4 pairs: launches {json.dumps(per_chunk, sort_keys=True)}, "
          f"{device_launches(lambda: fb(a4, b4))} device kernels")
    for name, c in per_chunk.items():
        if name in results:
            results[name]["launches_per_chunk_of_4_serving"] = c

    # What the per-entry cost (ops/sinkhorn.py _cost_matrix) costs the
    # served rate: the batched product it replaced, swapped in for this
    # measurement only, the two alternating stream by stream.
    per_entry = sinkhorn_ops._cost_matrix

    def batched_cost(desc1, desc2, distance_type):
        n1 = torch.sum(desc1 * desc1, dim=-1, keepdim=True)
        n2 = torch.sum(desc2 * desc2, dim=-1, keepdim=True)
        with full_fp32():
            dots = torch.matmul(desc1, desc2.transpose(-2, -1))
        return torch.clamp_min(n1 + n2.transpose(-2, -1) - 2.0 * dots, 0.0)

    for chunk in SERVE_CHUNKS[1:]:
        rates = {per_entry: [], batched_cost: []}
        try:
            for cost in (per_entry, batched_cost):   # warm-up
                sinkhorn_ops._cost_matrix = cost
                list(stream_map_chunked(fb, pairs[:chunk], chunk, 2))
            for rep in range(2 * SERVE_REPS):
                for cost in ((per_entry, batched_cost) if rep % 2 else (batched_cost, per_entry)):
                    sinkhorn_ops._cost_matrix = cost
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = list(stream_map_chunked(fb, pairs, chunk, 2))
                    rates[cost].append(SERVE_PAIRS / (time.perf_counter() - t0))
                    if cost is batched_cost:
                        out_batched = out
        finally:
            sinkhorn_ops._cost_matrix = per_entry
        diff = [np.abs(o[2] - w[2]) for o, w in zip(out_batched, seq)]
        corner = max(float(d[-1, -1] / w[2][-1, -1]) for d, w in zip(diff, seq))
        for d in diff:
            d[-1, -1] = 0
        print(f"[serving] cost per entry vs batched, chunk {chunk} depth 2: "
              f"{np.median(rates[per_entry]):.2f} vs {np.median(rates[batched_cost]):.2f} "
              f"pairs/s (median of {2 * SERVE_REPS} alternating streams each); the batched "
              f"product's P from the per-pair loop: max abs diff off the dustbin corner "
              f"{max(float(d.max()) for d in diff):.3e}, corner relative {corner:.3e}")


# Phase 11: the exported paths, each path's kernels (launch counters) and
# the op nodes its graph must hold.
EXPORT_PATHS = (
    ("flagship", {}, ("select_frontend", "sparse_sampler", "sinkhorn"),
     ("nms_select_blocks", "box_sample", "sinkhorn_core")),
    ("fused", {"fused_detect": True}, ("detect_frontend", "sparse_sampler", "sinkhorn"),
     ("detect_select", "box_sample", "sinkhorn_core")),
    ("AKAZE", {}, ("akaze_ladder", "select_frontend", "sparse_sampler", "sinkhorn"),
     ("akaze_ladder", "nms_select_blocks", "box_sample", "sinkhorn_core")),
)
SMALL_H, SMALL_W = 240, 320   # the dynamic artifact's second shape


def outputs_equal(a, b) -> bool:
    """As many outputs, each of the same type and shape, equal bit for bit."""
    import torch

    return len(a) == len(b) and all(x.dtype == y.dtype and x.shape == y.shape
                                    and torch.equal(x, y) for x, y in zip(a, b))


def run_export(g_pair, paths: dict) -> None:
    """Phase 11: the three paths exported on the card, saved, loaded and
    held to their eager modules; the flagship's dynamic artifact at two
    shapes and its streaming pair. Adds each loaded call's launch counts
    to ``paths``."""
    import tempfile

    import torch
    from onnx_image_processing_tpu_torch import models
    from onnx_image_processing_tpu_torch.kernels import launch_counts, reset_launch_counts

    dev = g_pair[0].device
    kw = dict(max_keypoints=MAX_KEYPOINTS, max_matches=MAX_MATCHES)

    def counted(fn, args):
        reset_launch_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, launch_counts()

    with tempfile.TemporaryDirectory() as tmp:
        for label, extra, kernels, op_names in EXPORT_PATHS:
            name = (AKAZE if label == "AKAZE" else FLAGSHIP) + "_extraction"
            eager = models.build(name, device=dev, **kw, **extra)
            t0 = time.perf_counter()
            exported = models.export_model(name, H, W, device=dev, **kw, **extra)
            t_export = time.perf_counter() - t0
            path = models.save_exported(exported, models.artifact_path(tmp, label, dev))
            t0 = time.perf_counter()
            loaded = models.load_exported(path)
            t_load = time.perf_counter() - t0
            in_graph = {str(n.target).split(".")[1] for n in exported.graph.nodes
                        if n.op == "call_function" and str(n.target).startswith("oip.")}
            print(f"[export {label}] export {t_export:.2f} s, save + load {t_load:.2f} s "
                  f"({path.rsplit('/', 1)[-1]}); {len(exported.graph.nodes)} nodes, op nodes "
                  f"{sorted(in_graph)}")
            check(set(op_names) <= in_graph, f"[export {label}] the graph lacks op nodes "
                                             f"{sorted(set(op_names) - in_graph)}")
            want, c_eager = counted(eager, g_pair)
            got, c_loaded = counted(loaded, g_pair)
            check_counts(f"export {label}", c_loaded, kernels)
            print(f"[export {label}] launches of one eager call {json.dumps(c_eager, sort_keys=True)}")
            check(c_loaded == c_eager, f"[export {label}] the loaded call launched {c_loaded}, "
                                       f"the eager call {c_eager}")
            same = outputs_equal(got, want)
            print(f"[export {label}] loaded vs eager on the pair: bit-identical {same}")
            check(same, f"[export {label}] the loaded artifact's outputs differ from eager")
            paths[f"export {label}"] = c_loaded
            ms_e, ms_l = median_ms(eager, g_pair), median_ms(loaded, g_pair)
            print(f"[export {label}] ms per pair: eager {ms_e:.3f}, loaded artifact {ms_l:.3f} "
                  f"(median of 20 after 5 warm-ups, host clock around synchronized calls)")

        name = FLAGSHIP + "_extraction"
        t0 = time.perf_counter()
        exported = models.export_model_polymorphic(name, device=dev, **kw)
        t_export = time.perf_counter() - t0
        loaded = models.load_exported(models.save_exported(
            exported, models.artifact_path(tmp, name, dev, polymorphic=True)))
        eager = models.build(name, device=dev, **kw)
        small = tuple(t[..., :SMALL_H, :SMALL_W].contiguous() for t in g_pair)
        for args in (g_pair, small):
            same = outputs_equal(loaded(*args), eager(*args))
            print(f"[export dynamic] flagship at {tuple(args[0].shape[2:])} (exported in "
                  f"{t_export:.2f} s): bit-identical to eager {same}")
            check(same, f"[export dynamic] differs from eager at {tuple(args[0].shape)}")

        ex, ma = models.export_streaming(FLAGSHIP, H, W, device=dev,
                                         max_keypoints=MAX_KEYPOINTS)
        extract = models.load_exported(models.save_exported(
            ex, models.artifact_path(tmp, FLAGSHIP + ".extract", dev)))
        match = models.load_exported(models.save_exported(
            ma, models.artifact_path(tmp, FLAGSHIP + ".match", dev)))
        k1, k2, p = match(extract(g_pair[0]), extract(g_pair[1]))
        w1, w2, wp = models.build(FLAGSHIP, device=dev, max_keypoints=MAX_KEYPOINTS)(*g_pair)
        kpt_same = torch.equal(k1, w1) and torch.equal(k2, w2)
        p_err = (p - wp).abs().max().item()
        print(f"[export streaming] extract + match artifacts vs the two-image matcher: "
              f"keypoints equal {kpt_same}, P max abs diff {p_err:.3e} (max {SERVE_P_ATOL})")
        check(kpt_same and p_err <= SERVE_P_ATOL, "[export streaming] differs from two-image")


def run_mesh(dev, paths: dict) -> None:
    """Phase 12, the mesh: ``shard_batch(build_batched(flagship),
    make_mesh())`` over B = 4 texture pairs on every card of the machine,
    against the unsharded call: outputs bit for bit, the same launches."""
    import torch
    from onnx_image_processing_tpu_torch import models
    from onnx_image_processing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from onnx_image_processing_tpu_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh()
    fb = models.build_batched(FLAGSHIP, max_keypoints=MAX_KEYPOINTS, device=dev)
    i1, i2 = (np.concatenate(side) for side in zip(*(texture_pair(s) for s in range(MESH_B))))
    reset_launch_counts()
    local = fb(torch.from_numpy(i1).to(dev), torch.from_numpy(i2).to(dev))
    torch.cuda.synchronize()
    counts_local = launch_counts()
    sharded_fn = shard_batch(fb, mesh)
    reset_launch_counts()
    out = sharded_fn(i1, i2)
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    counts = launch_counts()
    same = all(torch.equal(s.gather(dev), t) for s, t in zip(out, local))
    print(f"[mesh] shard_batch(build_batched(flagship), make_mesh()) over {len(mesh)} "
          f"device(s) {[str(d) for d in mesh.devices]} at B = {MESH_B}: outputs equal to the "
          f"unsharded call bit for bit {same}; launches {json.dumps(counts, sort_keys=True)} "
          f"(unsharded {json.dumps(counts_local, sort_keys=True)})")
    check(same, "[mesh] the sharded call differs from the unsharded one")
    check(counts == counts_local, "[mesh] the sharded call launched other kernels")
    check_counts("mesh", counts, {"select_frontend", "sparse_sampler", "sinkhorn"})
    paths["mesh"] = counts


def run_soak(dev) -> None:
    """Phase 12, the soak: ``tools.soak``'s draws, card against CPU, one
    after another; the draw list must hold what the phase promises."""
    from onnx_image_processing_tpu_torch.kernels import akaze_ladder
    from onnx_image_processing_tpu_torch.tools import soak

    draws = soak.draws(SOAK_SEED, SOAK_ITERS, SOAK_FAMILIES)
    per_family = {f: sum(d["family"] == f for d in draws) for f in soak.FAMILIES}
    ragged = sum(d["family"] == "sinkhorn" and d["n"] != d["m"] and d["b"] >= 4
                 for d in draws)
    a = soak.matcher_config({"family": "akaze"})[1].akaze
    global_route = [d["idx"] for d in draws if d["family"] == "akaze" and d["hires"]
                    and akaze_ladder.device_plan(2, d["h"], d["w"], a.nms_size // 2,
                                                 a.orientation_patch_size // 2,
                                                 dev).route == "global"]
    tie_modes = {d["topk_mode"] for d in draws if d["family"] == "ties"}
    print(f"[soak] seed {SOAK_SEED}, {SOAK_ITERS} draws, families in turn {SOAK_FAMILIES}: "
          f"per family {per_family}; ragged Sinkhorn at B >= 4: {ragged}; hi-res AKAZE on the "
          f"ladder's global route: draws {global_route}; ties top-k modes {sorted(tie_modes)}")
    check(min(per_family.values()) >= 2 and ragged >= 4 and global_route
          and tie_modes == {"block", "sort"}, "[soak] the draws miss a promised case")
    t0 = time.perf_counter()
    failed = []
    for d in draws:
        t = time.perf_counter()
        errs, counts = soak.run_draw(d, dev, "cpu")
        launched = sorted(k for k, c in counts.items() if c)
        print(f"[soak] {'ok' if not errs else 'FAIL'} draw {d['idx']} {d['family']} "
              f"({time.perf_counter() - t:.2f} s, kernels {launched})"
              + ("" if not errs else f": {d}"))
        for e in errs:
            print(f"[soak]     {e}")
        if errs:
            failed.append(d["idx"])
    print(f"[soak] draws per family {per_family}; failures {len(failed)} {failed}; "
          f"{time.perf_counter() - t0:.2f} s")
    check(not failed, f"[soak] draws {failed} failed")


CHAIN_N = 30          # phase 13: chain lengths n and 3n
GRAPH_REPLAYS = 5     # phase 13: replays of the graph of one call, each held to eager
# Phase 13's paths: label, registry name, overrides, kernels it launches.
CHAIN_PATHS = (
    ("flagship", FLAGSHIP + "_extraction", dict(max_keypoints=MAX_KEYPOINTS),
     ("select_frontend", "sparse_sampler", "sinkhorn")),
    ("fused", FLAGSHIP + "_extraction", dict(max_keypoints=MAX_KEYPOINTS, fused_detect=True),
     ("detect_frontend", "sparse_sampler", "sinkhorn")),
    ("AKAZE", AKAZE + "_extraction", {},
     ("akaze_ladder", "select_frontend", "sparse_sampler", "sinkhorn")),
    ("dense", DENSE + "_extraction", {}, ("select_frontend", "sparse_sampler", "sinkhorn")),
    ("unoriented", UNORIENTED + "_extraction", dict(max_keypoints=MAX_KEYPOINTS),
     ("select_frontend", "sparse_sampler", "sinkhorn")),
    ("filters", FILTERS + "_extraction", dict(max_keypoints=MAX_KEYPOINTS),
     ("select_frontend", "sparse_sampler", "sinkhorn")),
    ("shi_tomasi", "shi_tomasi", {}, ()),
    ("fast", "fast", {}, ()),
    ("dog_with_score", "dog_with_score", {}, ()),
    ("akaze head", "akaze", {}, ("akaze_ladder",)),
    ("voxel_downsampling", "voxel_downsampling", {}, ()),
)


def leaves(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def graph_nodes(graph) -> int:
    """Nodes of a kept CUDA graph (``cuGraphGetNodes`` of the driver)."""
    import ctypes

    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    check(err == 0, f"cuGraphGetNodes failed: CUresult {err}")
    return n.value


def run_chain(g1, g2, paths: dict) -> None:
    """Phase 13: each path captured in CUDA graphs, as ``--timing chain``
    runs it. A graph of one call equals eager bit for bit; the chain's ms
    per frame, the host loop's, nodes, capture seconds and peak memory."""
    import torch
    from onnx_image_processing_tpu_torch import models
    from onnx_image_processing_tpu_torch.cli import common
    from onnx_image_processing_tpu_torch.kernels import launch_counts, reset_launch_counts

    dev = g1.device
    t1, t2 = (torch.from_numpy(a).to(dev) for a in texture_pair())
    with torch.inference_mode():
        for label, name, kw, kernels in CHAIN_PATHS:
            spec = models.get(name)
            extra = dict(max_matches=MAX_MATCHES) if name.endswith("_extraction") else {}
            fn = models.build(name, device=dev, **extra, **kw)
            if spec.make_args is not None:
                args = models.arg_specs(spec, fn.cfg, H, W, device=dev)
                other = tuple(a.flip(-1) if a.dim() else a for a in args)
            else:
                args, other = (g1, g2)[:spec.n_images], (t1, t2)[:spec.n_images]
            # The graph reads its inputs from `static`. Replays alternate
            # between the path's inputs and a second input (the texture pair;
            # the points' axes mirrored), each held to eager on the same
            # inputs: a launch that escaped the graph would leave the other
            # input's outputs behind.
            inputs = (args, other)
            static = tuple(a.clone() for a in args)
            reset_launch_counts()
            eager = [leaves(fn(*x)) for x in inputs]
            one = common.capture(lambda: fn(*static), dev, keep_graph=True)
            same = 0
            for i in range(GRAPH_REPLAYS):
                for dst, src in zip(static, inputs[i % 2]):
                    dst.copy_(src)
                one.graph.replay()
                torch.cuda.synchronize()
                same += outputs_equal(leaves(one.out), eager[i % 2])
            nodes = graph_nodes(one.graph)
            del one
            chain = common.chain_times(fn, args, n=CHAIN_N)
            torch.cuda.synchronize()
            paths[f"chain {label}"] = counts = launch_counts()
            check_counts(f"chain {label}", counts, kernels)
            check(same == GRAPH_REPLAYS, f"[chain {label}] the graph of one call differs from "
                  f"eager on {GRAPH_REPLAYS - same} of {GRAPH_REPLAYS} replays")
            check(not outputs_equal(*eager), f"[chain {label}] the second input gives the "
                  "same outputs, so the replays cannot tell them apart")
            host_ms = common.run_benchmark(fn, args, "host")
            if label == "flagship":
                common.run_benchmark(fn, args, "chain")
            print(json.dumps({
                "phase13": label, "name": name, "graph_of_one_equal": f"{same}/{GRAPH_REPLAYS}",
                "nodes_per_call": nodes, "chain_ms_per_frame": chain.ms_per_frame,
                "chain_n": CHAIN_N, "t_n_s": chain.short_s, "t_3n_s": chain.long_s,
                "host_ms_per_frame": host_ms, "capture_s": chain.capture_s,
                "peak_mib": chain.peak_bytes / 2 ** 20}))
        ess = models.build(AKAZE + "_essential_matrix", device=dev)
        spec = models.get(AKAZE + "_essential_matrix")
        try:
            common.benchmark_chain(ess, models.arg_specs(spec, ess.cfg, H, W, device=dev))
        except ValueError as e:
            print(f"[chain essential] refused before capture: {e}")
        else:
            check(False, "[chain essential] the essential matcher's chain did not raise")


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    t = max(t_bytes, t_ops)
    return {"bound_ms": t * 1e3, "bound_us": t * 1e6,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sampler_ops(b, k, radius) -> float:
    """Adds and divides of the direct box sums, nearest mode: (2r+1)^2 per
    sample (the (2r+1)^2 - 1 adds and one divide)."""
    return float(b * k * ((2 * radius.long() + 1) ** 2).sum().item())


def sampson_median(e, mk1, mk2, k_inv) -> float:
    """Median Sampson error (normalized units, float64) of matched (y, x)
    pixel pairs under E."""
    def norm(k):
        return np.c_[k[:, 1], k[:, 0], np.ones(len(k))] @ k_inv.T.astype(np.float64)
    x1, x2, e = norm(mk1), norm(mk2), e.astype(np.float64)
    l2, l1 = x1 @ e.T, x2 @ e
    err = (l2 * x2).sum(1) ** 2 / (l2[:, 0] ** 2 + l2[:, 1] ** 2 + l1[:, 0] ** 2 + l1[:, 1] ** 2)
    return float(np.median(err))


def e_diff(a, b) -> float:
    """Max abs difference of two E's, each scaled to unit Frobenius norm,
    up to sign."""
    a = a.astype(np.float64) / np.linalg.norm(a)
    b = b.astype(np.float64) / np.linalg.norm(b)
    return float(min(np.abs(a - b).max(), np.abs(a + b).max()))


def pose_errors(host, intr):
    """Per frame, (R, t) from the frame's E and valid matches by the port's
    NumPy ``recover_pose``, against the truth of ``vo_sequence`` (R = I,
    t along +-x): the rotation error and the angle between t and the x
    axis, in degrees; None where the pose step fails."""
    from onnx_image_processing_tpu_torch.vo import recover_pose

    errs = []
    for mk1, mk2, _, valid, e in host:
        v = valid[0]
        r, t, _ = recover_pose(e, mk1[0][v], mk2[0][v], intr)
        if r is None:
            errs.append(None)
            continue
        rot = np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
        tdir = np.degrees(np.arccos(min(1.0, abs(t[0, 0]) / np.linalg.norm(t))))
        errs.append((float(rot), float(tdir)))
    return errs


def vo_poses(label, host_g, host_c, k_inv, bars) -> None:
    """Poses of the card's and of the CPU's E and matches, side by side:
    per-frame rotation and t-direction errors, failures, medians. The
    card's median rotation error may exceed the CPU's by POSE_ROT_GAP_DEG
    (where both sides have poses) and it may fail POSE_FAIL_SLACK frames
    more; ``bars`` (median rotation, median t-direction, failures), where
    given, bind both sides."""
    from onnx_image_processing_tpu_torch.vo import CameraIntrinsics

    kk = np.linalg.inv(k_inv.astype(np.float64))
    intr = CameraIntrinsics(kk[0, 0], kk[1, 1], kk[0, 2], kk[1, 2], W, H)
    sides = {"card": pose_errors(host_g, intr), "CPU": pose_errors(host_c, intr)}

    def fmt(x):
        return "fail" if x is None else f"{x[0]:.3f}/{x[1]:.2f}"

    print(f"[{label}] pose per frame, rotation / t-direction error in degrees, card | CPU: "
          + ", ".join(f"{fmt(g)} | {fmt(c)}" for g, c in zip(sides["card"], sides["CPU"])))
    med = {}
    for side, errs in sides.items():
        ok = [x for x in errs if x is not None]
        rot, tdir = (float(np.median([x[i] for x in ok])) if ok else None for i in (0, 1))
        med[side] = (rot, tdir, len(errs) - len(ok))
        print(f"[{label}] {side} poses: median rotation error "
              f"{'-' if rot is None else f'{rot:.4f}'} deg, median t-direction error "
              f"{'-' if tdir is None else f'{tdir:.3f}'} deg, failures {med[side][2]} of "
              f"{len(errs)}")
    (rot_g, _, fail_g), (rot_c, _, fail_c) = med["card"], med["CPU"]
    gap = None if rot_g is None or rot_c is None else rot_g - rot_c
    print(f"[{label}] card - CPU median rotation error "
          f"{'-' if gap is None else f'{gap:+.4f}'} deg (max +{POSE_ROT_GAP_DEG}); failures "
          f"card {fail_g}, CPU {fail_c} (max CPU + {POSE_FAIL_SLACK}); absolute bars "
          + ("none" if bars is None else "median rotation <= {} deg, t-direction <= {} deg, "
             "failures <= {}".format(*bars)))
    check(gap is None or gap <= POSE_ROT_GAP_DEG, f"[{label}] the card's poses rotate worse")
    check(fail_g <= fail_c + POSE_FAIL_SLACK, f"[{label}] the card fails more poses")
    for side, (rot, tdir, fails) in med.items():
        check(bars is None or (rot is not None and rot <= bars[0] and tdir <= bars[1]
                               and fails <= bars[2]),
              f"[{label}] the {side}'s poses miss the absolute bars")


def run_vo(label, name, overrides, frames_g, frames_c, k_inv, expect_zero, sampson_max,
           pose_bars):
    """Drive the VO device path on the card as the VO loop does: the
    streaming split with mutual-NN extraction, each new frame extracted once
    and matched against the cached features of the frame before it, one
    host copy of the outputs per frame. Checks per-frame launch counts,
    streaming vs the two-image module, E on the card vs on the CPU, E
    finite and rank 2, and the pooled median Sampson error of the valid
    matches under E; prints ms per frame, host syncs (and where each one is
    made) and launches per frame.
    Returns the launch counts summed over the frames."""
    import traceback
    import warnings

    import torch
    from onnx_image_processing_tpu_torch import models
    from onnx_image_processing_tpu_torch.cli.visual_odometry import to_host
    from onnx_image_processing_tpu_torch.models.essential_family import essential_from_match
    from onnx_image_processing_tpu_torch.models.extraction import append_mutual_matches
    from onnx_image_processing_tpu_torch.kernels import launch_counts, reset_launch_counts

    dev = frames_g[0].device
    kw = dict(max_matches=VO_MAX_MATCHES, match_threshold=VO_MATCH_THRESHOLD, **overrides)
    extract, match = models.build_streaming(name + "_extraction", device=dev, **kw)
    kinv_g, kinv_c = torch.from_numpy(k_inv).to(dev), torch.from_numpy(k_inv)

    # Pass 1: the counted run, frame by frame.
    totals: dict[str, int] = {}
    per_frame, host = [], []
    ref = extract(frames_g[0])
    for img in frames_g[1:]:
        reset_launch_counts()
        feats = extract(img)
        host.append(to_host(match(ref, feats, kinv_g)))
        torch.cuda.synchronize()
        counts = launch_counts()
        per_frame.append(counts)
        for k, c in counts.items():
            totals[k] = totals.get(k, 0) + c
        ref = feats
    # The same frames through the same path on the CPU, for the poses.
    extract_c, match_c = models.build_streaming(name + "_extraction", device="cpu", **kw)
    host_c, ref = [], extract_c(frames_c[0])
    for img in frames_c[1:]:
        feats = extract_c(img)
        host_c.append(to_host(match_c(ref, feats, kinv_c)))
        ref = feats
    vo_poses(label, host, host_c, k_inv, pose_bars)
    print(f"[{label}] launches per frame:", json.dumps(per_frame[0], sort_keys=True),
          f"(the same in all {len(per_frame)} frames: {all(c == per_frame[0] for c in per_frame)})")
    expect_zero = (*expect_zero, ABLATE)
    for counts in per_frame:
        for k, c in counts.items():
            if k in expect_zero:
                check(c == 0, f"[{label}] kernel {k} launched {c} times in a frame, expected none")
            else:
                check(c > 0, f"[{label}] kernel {k} was not launched in a frame")

    meds, ranks, nvalid = [], [], []
    for mk1, mk2, _, valid, e in host:
        check(e.shape == (3, 3) and bool(np.isfinite(e).all()), f"[{label}] E not finite")
        sv = np.linalg.svd(e.astype(np.float64), compute_uv=False)
        ranks.append(sv[2] / sv[0])
        v = valid[0]
        nvalid.append(int(v.sum()))
        meds.append(sampson_median(e, mk1[0][v], mk2[0][v], k_inv))
    pooled = float(np.median(meds))
    print(f"[{label}] valid matches per frame {nvalid}; sigma3/sigma1 of E at most "
          f"{max(ranks):.3e} (max {RANK2_MAX}); median Sampson error {pooled:.4e} "
          f"(pooled over frames; per frame {min(meds):.3e}..{max(meds):.3e}), "
          f"max {sampson_max:.4e}")
    check(max(ranks) < RANK2_MAX, f"[{label}] E not rank 2")
    check(pooled <= sampson_max, f"[{label}] median Sampson error {pooled} > {sampson_max}")

    # Streaming vs the two-image module on one frame pair, on the card.
    two = models.build(name, device=dev, **kw)
    f0, f1 = frames_g[0], frames_g[1]
    stacked = two.features(torch.cat([f0, f1]))
    per_image = [extract(f0), extract(f1)]
    same = all(torch.equal(t[b:b + 1], per_image[b][i])
               for i, t in enumerate(stacked) for b in (0, 1))
    s_out = models.build_streaming(name, device=dev, **kw)[1](*per_image, kinv_g)
    t_out = two(f0, f1, kinv_g)
    p_gap = (s_out[2] - t_out[2]).abs().max().item()
    e_gap = e_diff(s_out[3].cpu().numpy(), t_out[3].cpu().numpy())
    print(f"[{label}] streaming vs two-image on the card: keypoints, scores and "
          f"descriptors bit-identical {same}; P max abs diff {p_gap:.3e}, E diff {e_gap:.3e}")
    check(same, f"[{label}] streaming features differ from the stacked pair's")
    check(p_gap <= P_ATOL, f"[{label}] streaming P differs by {p_gap}")

    # E on the card vs the port on CPU copies, on two frame pairs: the whole
    # path, and the solve alone on the CPU's keypoints, scores and P moved
    # to the card. The soft LS solve is continuous in P and is held to
    # E_ATOL. RANSAC is not: its hypothesis solves run a float32 Cholesky at
    # condition ~1e6, so rounding moves their MSAC scores and the argmax
    # may pick another all-inlier hypothesis (on the CPU alone a 1e-5
    # change of P moves E by up to 0.06 on these frames). RANSAC's E is held
    # by its fit: the card's E must fit the CPU's matches within 1.5x of the
    # CPU's own E, or within the 2-px bound.
    ransac = two.cfg.essential_ransac_hypotheses > 0
    cpu = models.build(name, device="cpu", **kw)
    fit_bound = float(SAMPSON_PX * k_inv[0, 0]) ** 2
    for i in (0, len(frames_g) // 2):
        fc1, fc2 = cpu.features(frames_c[i]), cpu.features(frames_c[i + 1])
        k1c, k2c, pc, ec = cpu.tail(fc1, fc2, kinv_c)
        k1g, k2g, pg, eg = two(frames_g[i], frames_g[i + 1], kinv_g)
        p_gap, swaps = p_common_diff(k1g[0].cpu().numpy(), k2g[0].cpu().numpy(),
                                     pg[0].cpu().numpy(), k1c[0].numpy(), k2c[0].numpy(),
                                     pc[0].numpy())
        e_geo = essential_from_match(k1c.to(dev), fc1[1].to(dev), k2c.to(dev),
                                     fc2[1].to(dev), pc.to(dev), kinv_g, two.cfg).cpu().numpy()
        eg, ec = eg.cpu().numpy(), ec.numpy()
        gap, geo_gap = e_diff(eg, ec), e_diff(e_geo, ec)
        mk1, mk2, _, v = (t.numpy() for t in append_mutual_matches((k1c, k2c, pc), cpu.cfg))
        mk1, mk2 = mk1[0][v[0]], mk2[0][v[0]]
        fit_c, fit_g, fit_geo = (sampson_median(e, mk1, mk2, k_inv) for e in (ec, eg, e_geo))
        fit_max = max(1.5 * fit_c, fit_bound)
        print(f"[{label}] frames {i}-{i + 1}, GPU vs CPU: keypoint set difference {swaps}, "
              f"P max abs diff on common keypoints {p_gap:.3e}; E diff (unit norm, up to "
              f"sign) {gap:.3e}, the solve alone on the CPU's P {geo_gap:.3e}"
              f"{'' if ransac else f' (max {E_ATOL})'}; median Sampson error of the CPU's "
              f"{len(mk1)} matches under the CPU's E {fit_c:.4e}, the card's {fit_g:.4e}, "
              f"the card's solve alone {fit_geo:.4e} (max {fit_max:.4e})")
        check(fit_g <= fit_max and fit_geo <= fit_max,
              f"[{label}] the card's E does not fit the CPU's matches")
        if not ransac:
            check(geo_gap <= E_ATOL, f"[{label}] the solve on the card differs by {geo_gap}")
            if swaps == 0:
                check(gap <= E_ATOL, f"[{label}] E on the card differs from the CPU's by {gap}")

    # Pass 2: ms per frame, host clock around synchronized stages.
    ext_ms, match_ms, pair_ms = [], [], []
    ref = extract(frames_g[0])
    for img in frames_g[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = extract(img)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        to_host(match(ref, feats, kinv_g))
        t2 = time.perf_counter()
        ext_ms.append((t1 - t0) * 1e3)
        match_ms.append((t2 - t1) * 1e3)
        pair_ms.append((t2 - t0) * 1e3)
        ref = feats
    # Host syncs of one frame: PyTorch warns at each synchronizing call; the
    # innermost frame of the port (or of this script) names the call.
    syncs = []

    def record(message, *_):
        if "synchronizing CUDA operation" in str(message):
            site = [f for f in traceback.extract_stack()[:-1]
                    if "onnx_image_processing_tpu_torch" in f.filename
                    or f.filename.endswith("chip_smoke.py")][-1]
            syncs.append(f"{site.filename.split('/')[-1]}:{site.lineno} {site.line}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        to_host(match(ref, extract(frames_g[1]), kinv_g))
        torch.cuda.set_sync_debug_mode(0)
    print(f"[{label}] ms per frame (median of {len(pair_ms)}, host clock around synchronized "
          f"calls): extract {np.median(ext_ms):.3f}, match + host copy "
          f"{np.median(match_ms):.3f}, frame {np.median(pair_ms):.3f}; host syncs per "
          f"frame {len(syncs)}")
    for site in sorted(set(syncs)):
        print(f"[{label}]   sync x{syncs.count(site)} at {site}")
    return totals


def akaze_gap(both, akaze, lad_args) -> None:
    """Where the AKAZE path on the card and on the CPU part, stage by stage,
    at the CPU's keypoints: the ladder's maps, atan2 of the moments, the
    orientation at the keypoints, the nearest sample positions (cos/sin of
    each device), the descriptors, and the sampler kernel fed the CPU's own
    sampler inputs (the kernel without the devices' geometry)."""
    import torch
    from onnx_image_processing_tpu_torch import models, ops
    from onnx_image_processing_tpu_torch.kernels import akaze_ladder, sparse_sampler
    from onnx_image_processing_tpu_torch.models.akaze_family import akaze_detect_cfg
    from onnx_image_processing_tpu_torch.ops.sampling import sample_nearest

    dev, cfg, tg = both.device, akaze.cfg, akaze.table
    tc = models.build(AKAZE, max_matches=MAX_MATCHES, device="cpu").table
    bc = both.cpu()
    maps_g = [m.cpu() for m in akaze_ladder.akaze_ladder(both[:, 0].contiguous(), *lad_args)]
    maps_c = akaze_ladder.akaze_ladder_plain(bc[:, 0].contiguous(), *lad_args)
    ladder = max((g - c).abs().max().item() for g, c in zip(maps_g, maps_c))
    at_g = torch.atan2(maps_g[2].to(dev), maps_g[1].to(dev)).cpu()
    at_c = torch.atan2(maps_c[2], maps_c[1])
    print(f"[AKAZE gap] ladder maps GPU vs CPU max abs diff {ladder:.3e}; atan2 of the "
          f"same moments on each device: {int((at_g != at_c).sum())} of {at_c.numel()} "
          f"angles differ, max {(at_g - at_c).abs().max().item():.3e} rad")

    (_, o_g), (s_c, o_c) = akaze_detect_cfg(both, cfg), akaze_detect_cfg(bc, cfg)
    kc, _ = ops.nms_select_topk(s_c[:, 0], cfg.max_keypoints, cfg.score_threshold,
                                tc.max_radius, nms_radius=cfg.nms_radius)
    kg = kc.to(dev)
    th_g = sample_nearest(o_g[:, 0], kg[..., 0], kg[..., 1]).cpu()
    th_c = sample_nearest(o_c[:, 0], kc[..., 0], kc[..., 1])
    in_g = [t.cpu() for t in ops.box_sample_inputs(both, kg, tg, orientation=o_g)]
    in_c = ops.box_sample_inputs(bc, kc, tc, orientation=o_c)
    moved = (torch.round(in_g[3]) != torch.round(in_c[3])) | (torch.round(in_g[4]) != torch.round(in_c[4]))
    print(f"[AKAZE gap] at {kc.shape[1]} keypoints per image: {int((th_g != th_c).sum())} "
          f"orientations differ (max {(th_g - th_c).abs().max().item():.3e} rad); "
          f"{int(moved.sum())} of {moved.numel()} nearest sample positions differ, at "
          f"{int(moved.any(-1).sum())} keypoints")

    kw = dict(binarize=cfg.binarize, soft_binarize=cfg.soft_binarize,
              temperature=cfg.temperature)
    d_g = ops.sparse_bad(both, kg, tg, orientation=o_g, **kw).cpu()
    d_c = ops.sparse_bad(bc, kc, tc, orientation=o_c, **kw)
    off = (d_g - d_c).abs().amax(-1) > 1e-5
    smp_g = sparse_sampler.box_sample(*(t.to(dev) for t in in_c), tg.sample_radius,
                                      tg.groups, 56, tg.max_radius).cpu()
    smp_c = sparse_sampler.box_sample_plain(*in_c, tc.sample_radius, tc.groups, 56, tc.max_radius)
    print(f"[AKAZE gap] descriptors max abs diff {(d_g - d_c).abs().max().item():.3e}; "
          f"{int(off.sum())} keypoints past 1e-5, {int((off & ~moved.any(-1)).sum())} of them "
          f"with no sample position moved; sampler kernel on the CPU's sampler inputs vs "
          f"the CPU plain version: max abs diff {(smp_g - smp_c).abs().max().item():.3e}")


def main() -> None:
    import torch

    # ---- phase 0: the card ----------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs the port on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print("card (nvidia-smi name, power.limit):")
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from onnx_image_processing_tpu_torch import models, ops
    from onnx_image_processing_tpu_torch.kernels import (
        _build, akaze_ladder, detect_frontend, launch_counts, reset_launch_counts,
        select_frontend, sinkhorn_kernel, sparse_sampler)
    from onnx_image_processing_tpu_torch.tools import ablate_sampler
    from onnx_image_processing_tpu_torch.tools.ablate_sampler import cuda_ms, graph_ms
    from onnx_image_processing_tpu_torch.tools.kernel_times import device_launches

    def device(fn) -> dict:
        """The kernel alone: ms from a CUDA-graph replay, launches from a trace."""
        return {"device_ms": graph_ms(fn), "device_launches_per_call": device_launches(fn)}
    from onnx_image_processing_tpu_torch.models.akaze_family import akaze_detect_cfg
    from onnx_image_processing_tpu_torch.models.shi_tomasi_family import _sparse_detect_describe

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {built.seconds:.2f} s) -> {built.path.name}")
    for line in built.log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    dev = torch.device("cuda")
    img1, img2 = bench_pair()
    g1, g2 = torch.from_numpy(img1).to(dev), torch.from_numpy(img2).to(dev)
    matcher = models.build(FLAGSHIP, max_keypoints=MAX_KEYPOINTS,
                           max_matches=MAX_MATCHES, device=dev)
    cfg, table = matcher.cfg, matcher.table
    akaze = models.build(AKAZE, max_matches=MAX_MATCHES, device=dev)
    acfg = akaze.cfg
    results = {}

    # ---- phase 2: kernels vs plain versions at the paths' shapes ----------
    both = torch.cat([g1, g2])
    scores = ops.shi_tomasi_score(both, cfg.block_size)[:, 0].contiguous()
    margin = table.max_radius
    sel_args = (cfg.nms_radius, cfg.score_threshold, margin)
    a_scores, a_orient = akaze_detect_cfg(both, acfg)
    a_scores = a_scores[:, 0].contiguous()
    a_sel_args = (acfg.nms_radius, acfg.score_threshold, akaze.table.max_radius)
    rng = np.random.default_rng(77)
    ties = torch.from_numpy((rng.integers(0, 5, (2, H, W)) / 4.0).astype(np.float32)).to(dev)
    dcfg = models.get(DENSE).defaults
    d_scores = ops.shi_tomasi_score(both, dcfg.block_size)[:, 0].contiguous()
    select_err = 0.0
    for name, s, args, k in (
            ("flagship scores", scores, sel_args, cfg.max_keypoints),
            ("AKAZE scores", a_scores, a_sel_args, acfg.max_keypoints),
            ("dense matcher scores", d_scores, (dcfg.nms_radius, dcfg.score_threshold, 0),
             dcfg.max_keypoints),
            ("tie map", ties, (cfg.nms_radius, 0.1, margin), cfg.max_keypoints),
            ("tie map r=3", ties, (3, 0.0, 0), acfg.max_keypoints)):
        bm_k, bi_k = select_frontend.nms_block_reduce(s, *args)
        bm_p, bi_p = select_frontend.nms_block_reduce_plain(s, *args)
        check(torch.equal(bm_k, bm_p) and torch.equal(bi_k, bi_p),
              f"select_frontend not bit-identical on the {name}")
        select_err = max(select_err, (bm_k - bm_p).abs().max().item())
        kp_k, ks_k = select_frontend.nms_select_blocks(s, args[0], k, *args[1:])
        kp_p, ks_p = select_frontend.nms_select_blocks_plain(s, args[0], k, *args[1:])
        check(torch.equal(kp_k, kp_p) and torch.equal(ks_k, ks_p),
              f"select_frontend top-k not bit-identical on the {name}")
        select_err = max(select_err, (kp_k - kp_p).abs().max().item(),
                         (ks_k - ks_p).abs().max().item())
        print(f"select_frontend {name} {tuple(bm_k.shape)}, top {k}: block grid and "
              f"keypoints bit-identical ({int((ks_k > 0).sum())} valid)")
    k = cfg.max_keypoints
    topk_args = (cfg.nms_radius, k, *sel_args[1:])
    kp_k, ks_k = select_frontend.nms_select_blocks(scores, *topk_args)
    topk = device(lambda: ops.nms_select_topk(scores, k, cfg.score_threshold, margin,
                                              nms_radius=cfg.nms_radius))
    results["select_frontend"] = {
        "max_abs_err": select_err,
        "ms": cuda_ms(lambda: select_frontend.nms_select_blocks(scores, *topk_args)),
        "plain_ms": cuda_ms(lambda: select_frontend.nms_select_blocks_plain(scores, *topk_args)),
        **device(lambda: select_frontend.nms_select_blocks(scores, *topk_args)),
        # The flagship's whole selection, ops.nms_select_topk (the kernel's
        # only caller): device ms and device launches of one call.
        "device_ms_topk": topk["device_ms"],
        "device_launches_per_call_topk": topk["device_launches_per_call"],
        # Separable window max (2r+1 compares per axis), then the NMS,
        # threshold and border tests and the block max: ~4 more per pixel;
        # the top-k's passes over the block maxima are a few per block.
        "bound": bound(nbytes(scores, kp_k, ks_k),
                       scores.numel() * (2 * (2 * cfg.nms_radius + 1) + 4)),
    }

    kpts, _ = ops.nms_select_topk(scores, cfg.max_keypoints, cfg.score_threshold,
                                  margin, nms_radius=cfg.nms_radius)
    mm = ops.angle_moments(both, patch_size=cfg.patch_size, sigma=cfg.sigma)
    a_kpts, _ = ops.nms_select_topk(a_scores, acfg.max_keypoints, *a_sel_args[1:],
                                    nms_radius=acfg.nms_radius)
    sampler_err = 0.0
    for label, t, inputs in (
            ("flagship", table, ops.box_sample_inputs(both, kpts, table, mm)),
            ("AKAZE", akaze.table,
             ops.box_sample_inputs(both, a_kpts, akaze.table, orientation=a_orient))):
        args = (*inputs, t.sample_radius, t.groups, 56, t.max_radius)
        for bilinear in (False, True):
            out_k = sparse_sampler.box_sample(*args, bilinear=bilinear)
            out_p = sparse_sampler.box_sample_plain(*args, bilinear=bilinear)
            err = (out_k - out_p).abs().max().item()
            mode = "bilinear" if bilinear else "nearest"
            print(f"sparse_sampler {label} {mode} {tuple(out_k.shape)}: max abs err {err:.3e}")
            check(err <= SAMPLER_ATOL, f"sparse_sampler {label} {mode} error {err} > {SAMPLER_ATOL}")
            sampler_err = max(sampler_err, err)
        if label == "flagship":
            smp_args = args
        else:
            print(f"sparse_sampler {label}: {cuda_ms(lambda: sparse_sampler.box_sample(*args)):.4f} ms, "
                  f"plain {cuda_ms(lambda: sparse_sampler.box_sample_plain(*args)):.4f} ms")
    results["sparse_sampler"] = {
        "max_abs_err": sampler_err,
        "ms": cuda_ms(lambda: sparse_sampler.box_sample(*smp_args)),
        "plain_ms": cuda_ms(lambda: sparse_sampler.box_sample_plain(*smp_args)),
        **device(lambda: sparse_sampler.box_sample(*smp_args)),
        "bound": bound(nbytes(*smp_args[:6], smp_args[3]),
                       sampler_ops(*smp_args[3].shape[:2], smp_args[5])),
    }

    # The stage ablation: one templated kernel, so the full variant is the
    # sampler kernel itself.
    full = sparse_sampler.box_sample_ablated(*smp_args)
    check(torch.equal(full, sparse_sampler.box_sample(*smp_args)),
          "ablation: the full variant differs from the sampler kernel")
    check(torch.equal(full, sparse_sampler.box_sample_plain(*smp_args)),
          "ablation: the full variant differs from the plain version")
    centre_groups = tuple((0, lo, hi) for (_, lo, hi) in smp_args[6])
    no_box = sparse_sampler.box_sample_ablated(*smp_args, skip=("boxsum",))
    check(torch.equal(no_box, sparse_sampler.box_sample_plain(
        *smp_args[:6], centre_groups, *smp_args[7:])),
          "ablation: 'boxsum' skipped differs from its plain definition (radius 0)")
    no_load = sparse_sampler.box_sample_ablated(*smp_args, skip=("load",))
    check(bool(torch.isfinite(no_load).all()), "ablation: 'load' skipped gives non-finite samples")
    kept = torch.full_like(full, -7.0)
    sparse_sampler.box_sample_ablated(*smp_args, skip=("store",), out=kept)
    check(bool((kept == -7.0).all()), "ablation: 'store' skipped wrote to the output")
    print(f"sparse_sampler_ablate flagship {tuple(full.shape)}: full = kernel = plain bit for "
          f"bit; no box sums = plain at radius 0 bit for bit; no load finite; no store "
          f"left the buffer untouched")

    d_kpts, _ = ops.nms_select_topk(d_scores, dcfg.max_keypoints, dcfg.score_threshold, 0,
                                    nms_radius=dcfg.nms_radius)
    d_args = (*ops.box_sample_inputs(both, d_kpts, table), table.sample_radius,
              table.groups, 56, table.max_radius)
    err = (sparse_sampler.box_sample(*d_args, bilinear=True)
           - sparse_sampler.box_sample_plain(*d_args, bilinear=True)).abs().max().item()
    print(f"sparse_sampler dense matcher bilinear {tuple(d_args[3].shape)}: max abs err "
          f"{err:.3e}; {cuda_ms(lambda: sparse_sampler.box_sample(*d_args, bilinear=True)):.4f} ms, "
          f"plain {cuda_ms(lambda: sparse_sampler.box_sample_plain(*d_args, bilinear=True)):.4f} ms")
    check(err <= SAMPLER_ATOL, f"sparse_sampler dense bilinear error {err} > {SAMPLER_ATOL}")
    results["sparse_sampler"]["max_abs_err"] = max(sampler_err, err)
    results["sparse_sampler"]["device_ms_dense_bilinear"] = graph_ms(
        lambda: sparse_sampler.box_sample(*d_args, bilinear=True))

    desc = ops.sparse_bad(both, kpts, table, orientation_mm=mm, binarize=cfg.binarize,
                          soft_binarize=cfg.soft_binarize, temperature=cfg.temperature)
    akaze_desc = ops.sparse_bad(both, a_kpts, akaze.table, orientation=a_orient,
                                binarize=acfg.binarize, soft_binarize=acfg.soft_binarize,
                                temperature=acfg.temperature)
    sinkhorn_err = 0.0
    sinkhorn_device = {}
    for label, d, c in (("flagship", desc, cfg), ("AKAZE", akaze_desc, acfg)):
        ls, lmu, lnu = ops.sinkhorn_inputs(d[:1], d[1:], c.epsilon, c.unused_score)
        iters = c.sinkhorn_iterations
        p_k = sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, iters)
        p_p = sinkhorn_kernel.sinkhorn_core_plain(ls, lmu, lnu, iters)
        err = (p_k - p_p).abs().max().item()
        n = ls.shape[1] - 1
        col_err = (p_k[0, :, :n].sum(0) - 1).abs().max().item()
        row_dev_k = (p_k[0, :n, :].sum(1) - 1).abs().max().item()
        row_dev_p = (p_p[0, :n, :].sum(1) - 1).abs().max().item()
        print(f"sinkhorn {label} {tuple(p_k.shape)} eps={c.epsilon}: max abs err {err:.3e}; "
              f"column sums within {col_err:.3e} of 1; row sums within "
              f"{row_dev_k:.3e} of 1 (plain {row_dev_p:.3e}) after {iters} sweeps")
        check(err <= SINKHORN_ATOL, f"sinkhorn {label} error {err} > {SINKHORN_ATOL}")
        check(col_err <= MARGINAL_ATOL, f"sinkhorn {label} column sums off by {col_err}")
        sinkhorn_err = max(sinkhorn_err, err)
        n1, m1 = ls.shape[1:]
        print(f"sinkhorn {label}: {sinkhorn_kernel.device_plan(n1, m1, dev)}")
        sinkhorn_device[label] = graph_ms(lambda: sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, iters))
        if label == "flagship":
            sk_args = (ls, lmu, lnu, iters)
        else:
            print(f"sinkhorn {label}: {cuda_ms(lambda: sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, iters)):.4f} ms, "
                  f"plain {cuda_ms(lambda: sinkhorn_kernel.sinkhorn_core_plain(ls, lmu, lnu, iters)):.4f} ms")
    sk_out = sinkhorn_kernel.sinkhorn_core(*sk_args)
    results["sinkhorn"] = {
        "max_abs_err": sinkhorn_err,
        "ms": cuda_ms(lambda: sinkhorn_kernel.sinkhorn_core(*sk_args)),
        "plain_ms": cuda_ms(lambda: sinkhorn_kernel.sinkhorn_core_plain(*sk_args)),
        **device(lambda: sinkhorn_kernel.sinkhorn_core(*sk_args)),
        "device_ms_1025": sinkhorn_device["AKAZE"],
        # Each sweep: max, subtract, exp, add per entry (a row LSE, then a
        # column LSE), 20 iterations; then one add and exp per entry.
        "bound": bound(nbytes(*sk_args[:3], sk_out),
                       sk_out.numel() * (sk_args[3] * 2 * 4 + 2)),
    }

    df_args = (cfg.block_size, cfg.patch_size, cfg.sigma, cfg.nms_radius)
    detect_err = 0.0
    for with_angle in (True, False):
        got = detect_frontend.detect_frontend(both, *df_args, with_angle=with_angle)
        want = detect_frontend.detect_frontend_plain(both, *df_args, with_angle=with_angle)
        errs = [(g - e).abs().max().item() for g, e in zip(got, want) if e is not None]
        exact = all(torch.equal(g, e) for g, e in zip(got, want) if e is not None)
        mode = "with moments" if with_angle else "score only"
        print(f"detect_frontend {mode} {tuple(got[0].shape)}: max abs err "
              f"{max(errs):.3e}, bit-identical {exact} ({int((want[0] > 0).sum())} NMS survivors)")
        check(exact, f"detect_frontend {mode} not bit-identical")
        detect_err = max(detect_err, *errs)
        print(f"detect_frontend {mode}: "
              f"{cuda_ms(lambda: detect_frontend.detect_frontend(both, *df_args, with_angle=with_angle)):.4f} ms, plain "
              f"{cuda_ms(lambda: detect_frontend.detect_frontend_plain(both, *df_args, with_angle=with_angle)):.4f} ms")
    # detect_select at the fused flagship pair's settings (K, margin): the
    # detect frontend and its premasked block top-k in one launch.
    ds_args = (*df_args, cfg.max_keypoints, cfg.score_threshold, margin)
    got = detect_frontend.detect_select(both, *ds_args)
    want = detect_frontend.detect_select_plain(both, *ds_args)
    exact = all(torch.equal(g, e) for g, e in zip(got, want))
    print(f"detect_select {tuple(got[0].shape)} ({int((got[1] > 0).sum())} valid): keypoints, "
          f"scores and the three maps bit-identical {exact}; "
          f"{cuda_ms(lambda: detect_frontend.detect_select(both, *ds_args)):.4f} ms, plain "
          f"{cuda_ms(lambda: detect_frontend.detect_select_plain(both, *ds_args)):.4f} ms")
    check(exact, "detect_select not bit-identical")
    detect_err = max(detect_err, *((g - e).abs().max().item() for g, e in zip(got, want)))
    select_dev = device(lambda: detect_frontend.detect_select(both, *ds_args))
    bs, ps_, r = cfg.block_size, cfg.patch_size, cfg.nms_radius
    # Per pixel: two separable Sobel derivatives (24), three products,
    # three separable box sums (6 b), the score (8), the NMS window
    # (2 (2r+1) + 2) and two separable moments (8 p).
    detect_ops = both.numel() * (24 + 3 + 6 * bs + 8 + 2 * (2 * r + 1) + 2 + 8 * ps_)
    results["detect_frontend"] = {
        "max_abs_err": detect_err,
        "ms": cuda_ms(lambda: detect_frontend.detect_frontend(both, *df_args)),
        "plain_ms": cuda_ms(lambda: detect_frontend.detect_frontend_plain(both, *df_args)),
        **device(lambda: detect_frontend.detect_frontend(both, *df_args)),
        "device_ms_select": select_dev["device_ms"],
        "device_launches_per_call_select": select_dev["device_launches_per_call"],
        "bound": bound(16 * both.numel(), detect_ops),
        # detect_select: the same bytes and the keypoints written; per pixel
        # also the margin and threshold masks and the block max and argmin
        # (4 more); the top-k's passes over the block maxima, a few per block.
        "bound_select": bound(16 * both.numel() + nbytes(*got[:2]),
                              detect_ops + 4 * both.numel()),
    }

    a = akaze.cfg.akaze
    lad_args = (a.num_scales, a.diffusion_iterations, a.kappa, a.threshold, a.nms_size,
                a.orientation_patch_size, a.orientation_sigma)
    both_hw = both[:, 0].contiguous()
    frame_hw = both_hw[:1].contiguous()   # one VO frame
    ladder_err = 0.0
    for name, img in (("pair", both_hw), ("VO frame", frame_hw)):
        got = akaze_ladder.akaze_ladder(img, *lad_args)
        want = akaze_ladder.akaze_ladder_plain(img, *lad_args)
        errs = [(g - e).abs().max().item() for g, e in zip(got, want)]
        exact = all(torch.equal(g, e) for g, e in zip(got, want))
        plan = akaze_ladder.device_plan(*img.shape, a.nms_size // 2,
                                        a.orientation_patch_size // 2, dev)
        print(f"akaze_ladder {name} {tuple(got[0].shape)}: max abs err score {errs[0]:.3e}, "
              f"m10 {errs[1]:.3e}, m01 {errs[2]:.3e}, bit-identical {exact} "
              f"({int((want[0] > 0).sum())} NMS survivors); {plan}")
        check(exact, f"akaze_ladder not bit-identical on the {name}")
        ladder_err = max(ladder_err, *errs)
    results["akaze_ladder"] = {
        "max_abs_err": ladder_err,
        "ms": cuda_ms(lambda: akaze_ladder.akaze_ladder(both_hw, *lad_args)),
        "plain_ms": cuda_ms(lambda: akaze_ladder.akaze_ladder_plain(both_hw, *lad_args)),
        **device(lambda: akaze_ladder.akaze_ladder(both_hw, *lad_args)),
        "device_ms_b1": graph_ms(lambda: akaze_ladder.akaze_ladder(frame_hw, *lad_args)),
        # Bytes: the image read once and score, m10, m01 of every scale
        # written once. Per pixel and scale: each FED step ~25 (gradients,
        # conductance, four fluxes, update), the Hessian score 13, its NMS
        # window 2 nms_size, the two separable moments 8 p.
        "bound": bound(nbytes(both_hw) * (1 + 3 * a.num_scales),
                       both_hw.numel() * a.num_scales * (
                           25 * a.diffusion_iterations + 13 + 2 * a.nms_size
                           + 8 * a.orientation_patch_size)),
    }

    # ---- phase 3: the slice end to end ------------------------------------
    c1, c2 = torch.from_numpy(img1), torch.from_numpy(img2)
    flag_kw = dict(max_keypoints=MAX_KEYPOINTS)
    paths = {"flagship": run_path("flagship", FLAGSHIP, flag_kw, (g1, g2), (c1, c2),
                                  expect_zero=("detect_frontend", "akaze_ladder"),
                                  self_min=SELF_MIN_VALID)[0]}

    # ---- phase 4: the flagship with the fused detect frontend --------------
    counts, fused, _ = run_path("fused", FLAGSHIP, dict(flag_kw, fused_detect=True), (g1, g2),
                             (c1, c2), expect_zero=("select_frontend", "akaze_ladder"),
                             self_min=SELF_MIN_VALID)
    paths["fused"] = counts
    kx, _, dx_ = _sparse_detect_describe(both, matcher.cfg, table)
    kp, _, dp_ = _sparse_detect_describe(both, fused.cfg, fused.table)
    kx, kp, dx_, dp_ = (t.cpu().numpy() for t in (kx, kp, dx_, dp_))
    for b in range(2):
        ix, ip, swaps = common_rows(kx[b], kp[b])
        d_err = float(np.abs(dp_[b, ip] - dx_[b, ix]).max())
        print(f"[fused] vs unfused on the card, image {b}: keypoint set difference {swaps} "
              f"(max {KPT_SWAPS}), descriptor max abs diff on common keypoints {d_err:.3e} "
              f"(max {DESC_ATOL})")
        check(swaps <= KPT_SWAPS and d_err <= DESC_ATOL, f"[fused] vs unfused, image {b}")

    # ---- phase 5: the AKAZE matcher -----------------------------------------
    paths["AKAZE"] = run_path("AKAZE", AKAZE, {}, (g1, g2), (c1, c2),
                              expect_zero=("detect_frontend",))[0]
    akaze_gap(both, akaze, lad_args)

    # ---- phase 6: the with-filters and the unoriented matchers --------------
    unfused_zero = ("detect_frontend", "akaze_ladder")
    counts, _, (gout, cout) = run_path("filters", FILTERS, flag_kw, (g1, g2), (c1, c2),
                                       expect_zero=unfused_zero, self_min=FILTERS_SELF_MIN)
    paths["filters"] = counts
    ig, ic, _ = common_rows(gout[0][0], cout[0][0])
    flips = int((gout[3][0][ig] != cout[3][0][ic]).sum())
    print(f"[filters] filter masks GPU vs CPU: {flips} of {len(ig)} common keypoints differ "
          f"({int(gout[3].sum())} vs {int(cout[3].sum())} rows pass)")
    check(flips == 0, "[filters] filter masks differ between the card and the CPU")
    paths["unoriented"] = run_path("unoriented", UNORIENTED, flag_kw, (g1, g2), (c1, c2),
                                   expect_zero=unfused_zero, self_min=SELF_MIN_VALID)[0]

    # ---- phase 7: the VO device path ----------------------------------------
    frames = vo_sequence()
    frames_g = [torch.from_numpy(f).to(dev) for f in frames]
    frames_c = [torch.from_numpy(f) for f in frames]
    fx = 0.8 * W  # the VO CLI's default intrinsics
    k_inv = np.linalg.inv(np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]])).astype(np.float32)
    sampson_bound = (SAMPSON_PX / fx) ** 2
    print(f"[VO] {len(frames)} frames {H}x{W}, x-motion {VO_STEP} px per frame times an "
          f"inverse depth in [0.6, 1.4]; fx {fx}; Sampson bound (2 px / fx)^2 = "
          f"{sampson_bound:.4e}")
    paths["VO AKAZE"] = run_vo("VO AKAZE", AKAZE + "_essential_matrix", {}, frames_g, frames_c,
                               k_inv, ("detect_frontend",),
                               1.5 * JAX_AKAZE_SAMPSON_RATIO * sampson_bound, None)
    paths["VO RANSAC"] = run_vo(
        "VO RANSAC", FLAGSHIP + "_essential_matrix",
        dict(essential_ransac_hypotheses=256, essential_irls_iters=2), frames_g, frames_c,
        k_inv, unfused_zero, sampson_bound, POSE_BARS_RANSAC)

    # ---- phase 8: the dense family ---------------------------------------------
    run_dense((g1, g2), (c1, c2), paths)

    # ---- phase 9: the image CLIs' device functions, the sampler ablation -----
    run_clis((g1, g2), (c1, c2))
    abl_args = ablate_sampler.ablation_inputs(dev)
    reset_launch_counts()
    lines = ablate_sampler.run(dev)
    torch.cuda.synchronize()
    paths["ablation"] = launch_counts()
    check_counts("ablation", paths["ablation"], (ABLATE,))
    for line in lines:
        print(json.dumps(line))
    full = sparse_sampler.box_sample_ablated(*abl_args)
    check(torch.equal(full, sparse_sampler.box_sample(*abl_args)),
          "ablation inputs: the full variant differs from the sampler kernel")
    reset_launch_counts()
    sparse_sampler.box_sample_ablated(*abl_args)
    ablate_per_call = launch_counts()[ABLATE]
    results[ABLATE] = {
        "max_abs_err": (full - sparse_sampler.box_sample_plain(*abl_args)).abs().max().item(),
        "ms": lines[0]["ms"],
        "plain_ms": cuda_ms(lambda: sparse_sampler.box_sample_plain(*abl_args)),
        "device_ms": lines[0]["device_ms"],
        "device_launches_per_call": device_launches(
            lambda: sparse_sampler.box_sample_ablated(*abl_args)),
        "bound": bound(nbytes(*abl_args[:6], abl_args[3]),
                       sampler_ops(*abl_args[3].shape[:2], abl_args[5])),
    }

    # ---- phase 10: the rest of the op library, the serving layer ------------
    t10 = time.perf_counter()
    run_ops((g1, g2), (c1, c2))
    run_serving(dev, paths, results)
    print(f"phase 10: {time.perf_counter() - t10:.2f} s")

    # ---- phase 11: export on the card ----------------------------------------
    t11 = time.perf_counter()
    run_export((g1, g2), paths)
    print(f"phase 11: {time.perf_counter() - t11:.2f} s")

    # ---- phase 12: the mesh and the soak --------------------------------------
    t12 = time.perf_counter()
    run_mesh(dev, paths)
    run_soak(dev)
    print(f"phase 12: {time.perf_counter() - t12:.2f} s")

    # ---- phase 13: the CLIs' chain protocol, whole paths in CUDA graphs -------
    t13 = time.perf_counter()
    run_chain(g1, g2, paths)
    print(f"phase 13: {time.perf_counter() - t13:.2f} s")

    sources = {"select_frontend": ("select_frontend.cu", "kernels/select_frontend.py:329", "flagship"),
               "sparse_sampler": ("sparse_sampler.cu", "kernels/sparse_sampler.py:411", "flagship"),
               "sinkhorn": ("sinkhorn.cu", "kernels/sinkhorn_kernel.py:111", "flagship"),
               "detect_frontend": ("detect_frontend.cu", "kernels/detect_frontend.py:300", "fused"),
               "akaze_ladder": ("akaze_ladder.cu", "kernels/akaze_ladder.py:161", "AKAZE"),
               ABLATE: ("sparse_sampler.cu", None, "ablation")}
    # Launches: the sum over the path runs (each read right after its run);
    # per call: the one counted call of the kernel's own path.
    launches = {k: sum(c[k] for c in paths.values()) for k in sources}
    kernels = []
    for name, (cu, tpu, path) in sources.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"onnx_image_processing_tpu_torch/csrc/{cu}",
            "replaces": (f"onnx_image_processing_tpu/{tpu}" if tpu
                         else "benchmarks/ablate_sampler.py:167"),
            "launches": launches[name],
            "launches_per_call": ablate_per_call if name == ABLATE else paths[path][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            **{k: v for k, v in r.items() if k.startswith(("device", "launches_per_chunk"))},
            **r["bound"],
            **{f"{k}_select": v for k, v in r.get("bound_select", {}).items()},
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
