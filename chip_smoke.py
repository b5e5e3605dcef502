#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: the quickest proof that
the port still builds, agrees with its plain versions and runs end to end.

    python3 chip_smoke.py

Phases (any failed check raises; nothing falls back to the CPU):

0. Refuse to run without CUDA; print the card (nvidia-smi name, power limit)
   and the torch / CUDA versions.
1. Build the three CUDA kernels from ``csrc/`` with nvcc; print the seconds
   and each kernel's registers / shared memory from ptxas.
2. Each kernel against its plain PyTorch version on the card, on the
   flagship's own inputs (480x640 pair, 512 keypoints, S=805 samples, the
   513x513 Sinkhorn matrix): max error and median ms of both.
3. The flagship slice through ``models.build(..., device="cuda")``: launch
   counts of one run, agreement with the same slice on CPU copies, a
   self-match and a known-shift check, and the median ms per pair.

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

# Tolerances on the card, kernel vs plain version.
SAMPLER_ATOL = 1e-3     # box means of [0, 255] pixels
SINKHORN_ATOL = 1e-5    # transport probabilities
MARGINAL_ATOL = 1e-3    # column sums after the final column sweep
# GPU slice vs CPU slice.
KPT_SWAPS = 2           # symmetric set difference of keypoints, per image
P_ATOL = 5e-3           # P on the keypoints both runs selected
VALID_RTOL = 0.02       # count of valid matches
SELF_MIN_VALID = MAX_MATCHES  # self-match fills every slot on the card and the CPU


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
        _build, launch_counts, reset_launch_counts, select_frontend,
        sinkhorn_kernel, sparse_sampler)

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
    results = {}

    # ---- phase 2: kernels vs plain versions at the flagship's shapes ------
    both = torch.cat([g1, g2])
    scores = ops.shi_tomasi_score(both, cfg.block_size)[:, 0].contiguous()
    margin = table.max_radius
    sel_args = (cfg.nms_radius, cfg.score_threshold, margin)
    rng = np.random.default_rng(77)
    ties = torch.from_numpy((rng.integers(0, 5, (2, H, W)) / 4.0).astype(np.float32)).to(dev)
    select_err = 0.0
    for name, s, args in (("flagship scores", scores, sel_args),
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
    smp_args = (*ops.box_sample_inputs(both, kpts, table, mm), table.sample_radius,
                table.groups, 56, table.max_radius)
    for bilinear in (False, True):
        out_k = sparse_sampler.box_sample(*smp_args, bilinear=bilinear)
        out_p = sparse_sampler.box_sample_plain(*smp_args, bilinear=bilinear)
        err = (out_k - out_p).abs().max().item()
        mode = "bilinear" if bilinear else "nearest"
        print(f"sparse_sampler {mode} {tuple(out_k.shape)}: max abs err {err:.3e}")
        check(err <= SAMPLER_ATOL, f"sparse_sampler {mode} error {err} > {SAMPLER_ATOL}")
        if not bilinear:
            sampler_err = err
    results["sparse_sampler"] = {
        "max_abs_err": sampler_err,
        "ms": cuda_ms(lambda: sparse_sampler.box_sample(*smp_args)),
        "plain_ms": cuda_ms(lambda: sparse_sampler.box_sample_plain(*smp_args)),
    }

    desc = ops.sparse_bad(both, kpts, table, orientation_mm=mm, binarize=cfg.binarize,
                          soft_binarize=cfg.soft_binarize, temperature=cfg.temperature)
    ls, lmu, lnu = ops.sinkhorn_inputs(desc[:1], desc[1:], cfg.epsilon, cfg.unused_score)
    iters = cfg.sinkhorn_iterations
    p_k = sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, iters)
    p_p = sinkhorn_kernel.sinkhorn_core_plain(ls, lmu, lnu, iters)
    err = (p_k - p_p).abs().max().item()
    n = ls.shape[1] - 1
    col_err = (p_k[0, :, :n].sum(0) - 1).abs().max().item()
    row_dev_k = (p_k[0, :n, :].sum(1) - 1).abs().max().item()
    row_dev_p = (p_p[0, :n, :].sum(1) - 1).abs().max().item()
    print(f"sinkhorn {tuple(p_k.shape)} eps={cfg.epsilon}: max abs err {err:.3e}; "
          f"column sums within {col_err:.3e} of 1; row sums within "
          f"{row_dev_k:.3e} of 1 (plain {row_dev_p:.3e}) after {iters} sweeps")
    check(err <= SINKHORN_ATOL, f"sinkhorn error {err} > {SINKHORN_ATOL}")
    check(col_err <= MARGINAL_ATOL, f"sinkhorn column sums off by {col_err}")
    results["sinkhorn"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: sinkhorn_kernel.sinkhorn_core(ls, lmu, lnu, iters)),
        "plain_ms": cuda_ms(lambda: sinkhorn_kernel.sinkhorn_core_plain(ls, lmu, lnu, iters)),
    }

    # ---- phase 3: the slice end to end ------------------------------------
    extraction = models.build(FLAGSHIP + "_extraction", max_keypoints=MAX_KEYPOINTS,
                              max_matches=MAX_MATCHES, device=dev)
    reset_launch_counts()
    out = extraction(g1, g2)
    torch.cuda.synchronize()
    counts = launch_counts()
    print("launches in one run of the slice:", json.dumps(counts, sort_keys=True))
    for name, c in counts.items():
        check(c > 0, f"kernel {name} was not launched by the main path")
    mk1, mk2, ms, mv = (t.cpu().numpy() for t in out)
    check(mk1.shape == (1, MAX_MATCHES, 2) and ms.shape == (1, MAX_MATCHES),
          f"extraction output shapes {mk1.shape} {ms.shape}")
    check(bool(np.isfinite(ms).all() and np.isfinite(mk1).all()), "non-finite outputs")

    c1, c2 = torch.from_numpy(img1), torch.from_numpy(img2)
    cpu_matcher = models.build(FLAGSHIP, max_keypoints=MAX_KEYPOINTS,
                               max_matches=MAX_MATCHES, device="cpu")
    cpu_extraction = models.build(FLAGSHIP + "_extraction", max_keypoints=MAX_KEYPOINTS,
                                  max_matches=MAX_MATCHES, device="cpu")
    k1g, k2g, pg = (t.cpu().numpy() for t in matcher(g1, g2))
    k1c, k2c, pc = (t.numpy() for t in cpu_matcher(c1, c2))
    check(bool(np.isfinite(pg).all()) and pg.shape == (1, MAX_KEYPOINTS + 1, MAX_KEYPOINTS + 1),
          f"P shape {pg.shape} or non-finite")
    p_diff, swaps = p_common_diff(k1g[0], k2g[0], pg[0], k1c[0], k2c[0], pc[0])
    print(f"GPU vs CPU slice: keypoint set difference {swaps} (max {KPT_SWAPS}), "
          f"P max abs diff on common keypoints {p_diff:.3e} (max {P_ATOL})")
    check(swaps <= KPT_SWAPS, f"keypoint sets differ by {swaps}")
    check(p_diff <= P_ATOL, f"P differs by {p_diff}")
    nv_g = int(mv.sum())
    nv_c = int(cpu_extraction(c1, c2)[3].sum())
    print(f"valid matches: GPU {nv_g}, CPU {nv_c}")
    check(abs(nv_g - nv_c) <= VALID_RTOL * nv_c, "valid match counts differ by more than 2%")

    sk1, sk2, _, sv = (t.cpu().numpy() for t in extraction(g1, g1))
    self_valid = int(sv.sum())
    same = bool((sk1[sv] == sk2[sv]).all())
    print(f"self-match: {self_valid} of {MAX_MATCHES} slots valid, identical coordinates: {same}")
    check(same and self_valid >= SELF_MIN_VALID, "self-match")

    t1, t2 = (torch.from_numpy(a).to(dev) for a in texture_pair())
    tk1, tk2, _, tv = (t.cpu().numpy() for t in extraction(t1, t2))
    d = (tk2 - tk1)[tv]
    dx, dy = float(np.median(d[:, 1])), float(np.median(d[:, 0]))
    print(f"shift: texture rolled {SHIFT_X} px in x -> {int(tv.sum())} valid matches, "
          f"median dx {dx}, dy {dy}")
    check(abs(dx - SHIFT_X) <= 1 and abs(dy) <= 1, "shift not recovered")

    times = []
    for i in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extraction(g1, g2)
        torch.cuda.synchronize()
        if i >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"slice: {np.median(times):.3f} ms per pair (median of {len(times)} calls, "
          f"host clock around synchronized calls)")

    sources = {"select_frontend": ("select_frontend.cu", "select_frontend.py:329"),
               "sparse_sampler": ("sparse_sampler.cu", "sparse_sampler.py:411"),
               "sinkhorn": ("sinkhorn.cu", "sinkhorn_kernel.py:111")}
    kernels = []
    for name, (cu, tpu) in sources.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"onnx_image_processing_tpu_torch/csrc/{cu}",
            "replaces": f"onnx_image_processing_tpu/kernels/{tpu}",
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
