#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: the quickest proof that
the port still builds, agrees with its plain versions and runs end to end.

    python3 chip_smoke.py

Phases (any failed check raises; nothing falls back to the CPU):

0. Refuse to run without CUDA; print the card (nvidia-smi name, power limit)
   and the torch / CUDA versions.
1. Build the five CUDA kernels from ``csrc/`` with nvcc; print the seconds
   and each kernel's registers / shared memory from ptxas.
2. Each kernel against its plain PyTorch version on the card, on the
   paths' own inputs (480x640 pair; select on the flagship's and AKAZE's
   score maps; the sampler at the flagship's 512 keypoints with moment
   orientation and AKAZE's 1024 with its dense orientation, S=805 samples;
   Sinkhorn at 513x513 and 1025x1025; the detect frontend at block 5 /
   NMS 5 with and without moments; the AKAZE ladder at its defaults): max
   error and median ms of both.
3. The flagship slice through ``models.build(..., device="cuda")``: launch
   counts of one run, agreement with the same slice on CPU copies, a
   self-match and a known-shift check, and the median ms per pair.
4. The flagship with ``fused_detect=True`` (detect-frontend kernel, no
   select-frontend kernel): the checks of phase 3, plus fused vs unfused
   keypoints and descriptors on the card.
5. The AKAZE matcher at its registry defaults (1024 keypoints, 512 pairs):
   the checks of phase 3, then where its GPU and CPU runs part, stage by
   stage (printed, not checked).

The last two lines are a JSON object of per-kernel results and
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
FLAGSHIP = "shi_tomasi_angle_sparse_bad_sinkhorn"
AKAZE = "akaze_sparse_bad_sinkhorn"

# Tolerances on the card, kernel vs plain version.
SAMPLER_ATOL = 1e-3     # box means of [0, 255] pixels
SINKHORN_ATOL = 1e-5    # transport probabilities
MARGINAL_ATOL = 1e-3    # column sums after the final column sweep
# The two stencil kernels are bit-identical to their plain versions on the
# card; they fail only past the JAX package's own kernel-vs-oracle bounds.
DETECT_ATOL = 2e-2      # masked score and moments
LADDER_SCORE_ATOL = 1e-3
LADDER_MOMENT_ATOL = 5e-3
SURVIVOR_FRAC = 1e-4    # share of pixels whose NMS survival differs
# GPU slice vs CPU slice.
KPT_SWAPS = 2           # symmetric set difference of keypoints, per image
P_ATOL = 5e-3           # P on the keypoints both runs selected
VALID_RTOL = 0.02       # count of valid matches
SELF_MIN_VALID = MAX_MATCHES  # self-match fills every slot on the card and the CPU
DESC_ATOL = 2e-3        # fused vs unfused descriptors on common keypoints


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


def texture_pair(seed: int = 1):
    """A non-periodic texture (blurred uniform noise) and its 7-px x-roll.
    bench.py's lattice repeats every ~56 px, so its matches cannot pin the
    shift; this texture's can."""
    rng = np.random.default_rng(seed)

    def blur(a, r):
        k = 2 * r + 1
        for ax in (0, 1):
            pad = [(r + 1, r) if i == ax else (0, 0) for i in range(2)]
            c = np.cumsum(np.pad(a, pad, mode="edge"), axis=ax)
            n = c.shape[ax]
            a = (np.take(c, range(k, n), axis=ax) - np.take(c, range(0, n - k), axis=ax)) / k
        return a

    tex = blur(blur(blur(rng.uniform(0, 1, (H, W)), 2), 2), 2)
    tex = 255 * (tex - tex.min()) / (tex.max() - tex.min())
    img1 = np.clip(tex + rng.normal(0, 3, (H, W)), 0, 255)
    img2 = np.clip(np.roll(tex, SHIFT_X, 1) + rng.normal(0, 3, (H, W)), 0, 255)
    return (img1.astype(np.float32)[None, None], img2.astype(np.float32)[None, None])


def cuda_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def p_common_diff(k1a, k2a, pa, k1b, k2b, pb) -> tuple[float, int]:
    """Max |P_a - P_b| over the keypoints both runs selected (plus the
    dustbin), matched by coordinates; returns it and the swap count."""
    idx = []
    swaps = 0
    for a, b in ((k1a, k1b), (k2a, k2b)):
        inv_a = {tuple(v): i for i, v in enumerate(a.tolist())}
        inv_b = {tuple(v): i for i, v in enumerate(b.tolist())}
        shared = sorted(set(inv_a) & set(inv_b))
        swaps = max(swaps, len(set(inv_a) ^ set(inv_b)))
        idx.append((np.array([inv_a[v] for v in shared] + [len(a)]),
                    np.array([inv_b[v] for v in shared] + [len(b)])))
    (ia1, ib1), (ia2, ib2) = idx
    diff = np.abs(pa[np.ix_(ia1, ia2)] - pb[np.ix_(ib1, ib2)])
    return float(diff.max()), swaps


def survivor_diff(a, b) -> float:
    """Share of pixels that survive NMS (score > 0) in one map only."""
    return ((a > 0) != (b > 0)).float().mean().item()


def run_path(label, name, overrides, g_pair, c_pair, expect_zero=(), self_min=0):
    """Drive one path end to end on the card: launch counts of one run (each
    kernel of the path > 0, those in ``expect_zero`` = 0), agreement with the
    same path on CPU copies, a self-match (identical coordinates in at least
    as many slots as the CPU run and ``self_min``) and the texture shift;
    prints the ms per pair. Returns the launch counts and the CUDA matcher."""
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
    print(f"[{label}] launches in one run:", json.dumps(counts, sort_keys=True))
    for k, c in counts.items():
        if k in expect_zero:
            check(c == 0, f"[{label}] kernel {k} launched {c} times, expected none")
        else:
            check(c > 0, f"[{label}] kernel {k} was not launched by the path")
    mk1, mk2, ms, mv = (t.cpu().numpy() for t in out)
    check(mk1.shape == (1, MAX_MATCHES, 2) and ms.shape == (1, MAX_MATCHES),
          f"[{label}] extraction output shapes {mk1.shape} {ms.shape}")
    check(bool(np.isfinite(ms).all() and np.isfinite(mk1).all()), f"[{label}] non-finite outputs")

    matcher = models.build(name, device=dev, **kw)
    cpu_matcher = models.build(name, device="cpu", **kw)
    cpu_extraction = models.build(name + "_extraction", device="cpu", **kw)
    k = matcher.cfg.max_keypoints
    k1g, k2g, pg = (t.cpu().numpy() for t in matcher(*g_pair))
    k1c, k2c, pc = (t.numpy() for t in cpu_matcher(*c_pair))
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

    sk1, sk2, _, sv = (t.cpu().numpy() for t in extraction(g_pair[0], g_pair[0]))
    self_valid = int(sv.sum())
    self_cpu = int(cpu_extraction(c_pair[0], c_pair[0])[3].sum())
    same = bool((sk1[sv] == sk2[sv]).all())
    print(f"[{label}] self-match: {self_valid} of {MAX_MATCHES} slots valid (CPU {self_cpu}), "
          f"identical coordinates: {same}")
    check(same and self_valid >= max(self_cpu, self_min), f"[{label}] self-match")

    t1, t2 = (torch.from_numpy(a).to(dev) for a in texture_pair())
    tk1, tk2, _, tv = (t.cpu().numpy() for t in extraction(t1, t2))
    d = (tk2 - tk1)[tv]
    dx, dy = float(np.median(d[:, 1])), float(np.median(d[:, 0]))
    print(f"[{label}] shift: texture rolled {SHIFT_X} px in x -> {int(tv.sum())} valid "
          f"matches, median dx {dx}, dy {dy}")
    check(abs(dx - SHIFT_X) <= 1 and abs(dy) <= 1, f"[{label}] shift not recovered")

    times = []
    for i in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extraction(*g_pair)
        torch.cuda.synchronize()
        if i >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"[{label}] {np.median(times):.3f} ms per pair (median of {len(times)} calls, "
          f"host clock around synchronized calls)")
    return counts, matcher


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
        _build, akaze_ladder, detect_frontend, select_frontend, sinkhorn_kernel,
        sparse_sampler)
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
    select_err = 0.0
    for name, s, args in (("flagship scores", scores, sel_args),
                          ("AKAZE scores", a_scores, a_sel_args),
                          ("tie map", ties, (cfg.nms_radius, 0.1, margin)),
                          ("tie map r=3", ties, (3, 0.0, 0))):
        bm_k, bi_k = select_frontend.nms_block_reduce(s, *args)
        bm_p, bi_p = select_frontend.nms_block_reduce_plain(s, *args)
        check(torch.equal(bm_k, bm_p) and torch.equal(bi_k, bi_p),
              f"select_frontend not bit-identical on the {name}")
        select_err = max(select_err, (bm_k - bm_p).abs().max().item())
        print(f"select_frontend {name} {tuple(bm_k.shape)}: bit-identical")
    results["select_frontend"] = {
        "max_abs_err": select_err,
        "ms": cuda_ms(lambda: select_frontend.nms_block_reduce(scores, *sel_args)),
        "plain_ms": cuda_ms(lambda: select_frontend.nms_block_reduce_plain(scores, *sel_args)),
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
    }

    desc = ops.sparse_bad(both, kpts, table, orientation_mm=mm, binarize=cfg.binarize,
                          soft_binarize=cfg.soft_binarize, temperature=cfg.temperature)
    akaze_desc = ops.sparse_bad(both, a_kpts, akaze.table, orientation=a_orient,
                                binarize=acfg.binarize, soft_binarize=acfg.soft_binarize,
                                temperature=acfg.temperature)
    sinkhorn_err = 0.0
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
        if label == "flagship":
            sk_args = (ls, lmu, lnu, iters)
        else:
            print(f"sinkhorn {label}: {cuda_ms(lambda: sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, iters)):.4f} ms, "
                  f"plain {cuda_ms(lambda: sinkhorn_kernel.sinkhorn_core_plain(ls, lmu, lnu, iters)):.4f} ms")
    results["sinkhorn"] = {
        "max_abs_err": sinkhorn_err,
        "ms": cuda_ms(lambda: sinkhorn_kernel.sinkhorn_core(*sk_args)),
        "plain_ms": cuda_ms(lambda: sinkhorn_kernel.sinkhorn_core_plain(*sk_args)),
    }

    df_args = (cfg.block_size, cfg.patch_size, cfg.sigma, cfg.nms_radius)
    detect_err = 0.0
    for with_angle in (True, False):
        got = detect_frontend.detect_frontend(both, *df_args, with_angle=with_angle)
        want = detect_frontend.detect_frontend_plain(both, *df_args, with_angle=with_angle)
        errs = [(g - e).abs().max().item() for g, e in zip(got, want) if e is not None]
        exact = all(torch.equal(g, e) for g, e in zip(got, want) if e is not None)
        surv = survivor_diff(got[0], want[0])
        mode = "with moments" if with_angle else "score only"
        print(f"detect_frontend {mode} {tuple(got[0].shape)}: max abs err "
              f"{max(errs):.3e}, bit-identical {exact}, NMS survivor difference {surv:.2e}")
        check(max(errs) <= DETECT_ATOL, f"detect_frontend {mode} error {max(errs)} > {DETECT_ATOL}")
        check(surv < SURVIVOR_FRAC, f"detect_frontend {mode} survivors differ on {surv}")
        detect_err = max(detect_err, *errs)
        print(f"detect_frontend {mode}: "
              f"{cuda_ms(lambda: detect_frontend.detect_frontend(both, *df_args, with_angle=with_angle)):.4f} ms, plain "
              f"{cuda_ms(lambda: detect_frontend.detect_frontend_plain(both, *df_args, with_angle=with_angle)):.4f} ms")
    results["detect_frontend"] = {
        "max_abs_err": detect_err,
        "ms": cuda_ms(lambda: detect_frontend.detect_frontend(both, *df_args)),
        "plain_ms": cuda_ms(lambda: detect_frontend.detect_frontend_plain(both, *df_args)),
    }

    a = akaze.cfg.akaze
    lad_args = (a.num_scales, a.diffusion_iterations, a.kappa, a.threshold, a.nms_size,
                a.orientation_patch_size, a.orientation_sigma)
    both_hw = both[:, 0].contiguous()
    got = akaze_ladder.akaze_ladder(both_hw, *lad_args)
    want = akaze_ladder.akaze_ladder_plain(both_hw, *lad_args)
    errs = [(g - e).abs().max().item() for g, e in zip(got, want)]
    exact = all(torch.equal(g, e) for g, e in zip(got, want))
    surv = survivor_diff(got[0], want[0])
    print(f"akaze_ladder {tuple(got[0].shape)}: max abs err score {errs[0]:.3e}, m10 "
          f"{errs[1]:.3e}, m01 {errs[2]:.3e}, bit-identical {exact}, NMS survivor "
          f"difference {surv:.2e} ({int((want[0] > 0).sum())} survivors)")
    check(errs[0] <= LADDER_SCORE_ATOL, f"akaze_ladder score error {errs[0]}")
    check(max(errs[1:]) <= LADDER_MOMENT_ATOL, f"akaze_ladder moment error {max(errs[1:])}")
    check(surv < SURVIVOR_FRAC, f"akaze_ladder survivors differ on {surv}")
    results["akaze_ladder"] = {
        "max_abs_err": max(errs),
        "ms": cuda_ms(lambda: akaze_ladder.akaze_ladder(both_hw, *lad_args)),
        "plain_ms": cuda_ms(lambda: akaze_ladder.akaze_ladder_plain(both_hw, *lad_args)),
    }

    # ---- phase 3: the slice end to end ------------------------------------
    c1, c2 = torch.from_numpy(img1), torch.from_numpy(img2)
    flag_kw = dict(max_keypoints=MAX_KEYPOINTS)
    paths = {"flagship": run_path("flagship", FLAGSHIP, flag_kw, (g1, g2), (c1, c2),
                                  expect_zero=("detect_frontend", "akaze_ladder"),
                                  self_min=SELF_MIN_VALID)[0]}

    # ---- phase 4: the flagship with the fused detect frontend --------------
    counts, fused = run_path("fused", FLAGSHIP, dict(flag_kw, fused_detect=True), (g1, g2),
                             (c1, c2), expect_zero=("select_frontend", "akaze_ladder"),
                             self_min=SELF_MIN_VALID)
    paths["fused"] = counts
    kx, _, dx_ = _sparse_detect_describe(both, matcher.cfg, table)
    kp, _, dp_ = _sparse_detect_describe(both, fused.cfg, fused.table)
    kx, kp, dx_, dp_ = (t.cpu().numpy() for t in (kx, kp, dx_, dp_))
    for b in range(2):
        ix = {tuple(v): i for i, v in enumerate(kx[b].tolist())}
        ip = {tuple(v): i for i, v in enumerate(kp[b].tolist())}
        common = sorted(set(ix) & set(ip))
        swaps = len(set(ix) ^ set(ip))
        d_err = float(np.abs(dp_[b, [ip[v] for v in common]] - dx_[b, [ix[v] for v in common]]).max())
        print(f"[fused] vs unfused on the card, image {b}: keypoint set difference {swaps} "
              f"(max {KPT_SWAPS}), descriptor max abs diff on common keypoints {d_err:.3e} "
              f"(max {DESC_ATOL})")
        check(swaps <= KPT_SWAPS and d_err <= DESC_ATOL, f"[fused] vs unfused, image {b}")

    # ---- phase 5: the AKAZE matcher -----------------------------------------
    paths["AKAZE"] = run_path("AKAZE", AKAZE, {}, (g1, g2), (c1, c2),
                              expect_zero=("detect_frontend",))[0]
    akaze_gap(both, akaze, lad_args)

    sources = {"select_frontend": ("select_frontend.cu", "select_frontend.py:329"),
               "sparse_sampler": ("sparse_sampler.cu", "sparse_sampler.py:411"),
               "sinkhorn": ("sinkhorn.cu", "sinkhorn_kernel.py:111"),
               "detect_frontend": ("detect_frontend.cu", "detect_frontend.py:300"),
               "akaze_ladder": ("akaze_ladder.cu", "akaze_ladder.py:161")}
    # Launches: the sum over the three path runs (each read right after its run).
    launches = {k: sum(c[k] for c in paths.values()) for k in sources}
    kernels = []
    for name, (cu, tpu) in sources.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"onnx_image_processing_tpu_torch/csrc/{cu}",
            "replaces": f"onnx_image_processing_tpu/kernels/{tpu}",
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
