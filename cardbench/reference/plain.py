"""The plain reference of the benchmark's two configurations, in plain
PyTorch (and NumPy for the pose step), float32 with no TF32.

It follows the upstream models' semantics as the JAX package pins them: the
Shi-Tomasi and AKAZE detectors as zero- or edge-padded separable stencils in
one tap order, max-pool NMS and the block top-k (ties to the lowest index),
oriented sparse BAD descriptors read from the same 56x56 windows, log-domain
Sinkhorn with a dustbin, mutual-NN extraction, and the soft weighted 8-point
essential solve (float64 for the 9x9 eigenproblem and the projection). It
imports nothing of the program and reads only its own copy of the learned
BAD table. Every function works on one device's tensors, the card's or the
CPU's.

``precision="tf32"`` is the control: every float32 matrix product takes its
operands rounded to TF32 (10 mantissa bits), as the card's TF32 mode does.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

_TABLE = Path(__file__).resolve().parent / "bad_params_512.npz"
_PATCH = 56        # the descriptor's window side
_PATCH_HALF = 23   # window origin: keypoint - 23, rows floored to 8


@contextlib.contextmanager
def fp32_products():
    """TF32 off for products and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (13 low mantissa bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    elif precision != "fp32":
        raise ValueError(f"precision must be 'fp32' or 'tf32', got {precision!r}")
    return torch.matmul(a, b)


# ---- stencils ----------------------------------------------------------------

def _pad(x: torch.Tensor, ph: int, pw: int, mode: str) -> torch.Tensor:
    if mode == "edge":
        h, w = x.shape[-2:]
        rows = torch.arange(-ph, h + ph, device=x.device).clamp(0, h - 1)
        cols = torch.arange(-pw, w + pw, device=x.device).clamp(0, w - 1)
        return x.index_select(-2, rows).index_select(-1, cols)
    value = {"zero": 0.0, "neg_inf": float("-inf")}[mode]
    return torch.nn.functional.pad(x, (pw, pw, ph, ph), value=value)


def _taps_h(x: torch.Tensor, taps) -> torch.Tensor:
    """Valid correlation along rows: sum_t taps[t] x[i + t], zero taps skipped, in order."""
    n = x.shape[-2] - len(taps) + 1
    acc = None
    for t, tap in enumerate(np.asarray(taps, np.float32)):
        if tap != 0.0:
            term = float(tap) * x.narrow(-2, t, n)
            acc = term if acc is None else acc + term
    return acc


def _taps_w(x: torch.Tensor, taps) -> torch.Tensor:
    n = x.shape[-1] - len(taps) + 1
    acc = None
    for t, tap in enumerate(np.asarray(taps, np.float32)):
        if tap != 0.0:
            term = float(tap) * x.narrow(-1, t, n)
            acc = term if acc is None else acc + term
    return acc


def _sep(x: torch.Tensor, col, row, mode: str) -> torch.Tensor:
    """'Same'-size separable correlation: column taps, then row taps."""
    xp = _pad(x, len(col) // 2, len(row) // 2, mode)
    return _taps_w(_taps_h(xp, col), row)


def _maxpool(x: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    xp = _pad(x, r, r, mode)
    h, w = x.shape[-2:]
    col = xp.narrow(-2, 0, h)
    for d in range(1, 2 * r + 1):
        col = torch.maximum(col, xp.narrow(-2, d, h))
    out = col.narrow(-1, 0, w)
    for d in range(1, 2 * r + 1):
        out = torch.maximum(out, col.narrow(-1, d, w))
    return out


def _gauss(sigma: float, size: int):
    t = np.arange(-(size // 2), size // 2 + 1, dtype=np.float32)
    g = np.exp(-(t ** 2) / (2.0 * sigma ** 2)).astype(np.float32)
    return g, (t * g).astype(np.float32)


def shi_tomasi(x: torch.Tensor, block: int) -> torch.Tensor:
    """lambda_min of the Sobel structure tensor summed over a ``block``
    window, edges replicated; (B, H, W) -> (B, H, W)."""
    s, d = [1.0, 2.0, 1.0], [-1.0, 0.0, 1.0]
    xp = _pad(x, 1, 1, "edge")
    ix = _taps_w(_taps_h(xp, s), d)
    iy = _taps_w(_taps_h(xp, d), s)
    r = block // 2
    ones = [1.0] * block

    def bsum(v):
        return _taps_w(_taps_h(_pad(v, r, r, "edge"), ones), ones)

    sxx, syy, sxy = bsum(ix * ix), bsum(iy * iy), bsum(ix * iy)
    half = (sxx + syy) * 0.5
    diff = (sxx - syy) * 0.5
    lam = half - torch.sqrt(diff * diff + sxy * sxy + 1e-10)
    return torch.clamp_min(lam, 0.0)


def moments(x: torch.Tensor, size: int, sigma: float):
    """Gaussian-weighted first moments (m10, m01) over a zero-padded patch."""
    g, tg = _gauss(sigma, size)
    xp = _pad(x, size // 2, size // 2, "zero")
    return _taps_w(_taps_h(xp, g), tg), _taps_w(_taps_h(xp, tg), g)


def akaze(x: torch.Tensor, a: dict):
    """AKAZE: per scale, FED Perona-Malik diffusion steps carried from the
    previous scale, the det-Hessian score under a zero-bordered max-pool
    NMS and threshold, and the orientation moments; the score is the max
    over scales and the angle atan2(m01, m10) of the scales that reach it
    (ties averaged). (B, H, W) -> (scores, angles), each (B, H, W)."""
    s121, d101, l121, xy = [1.0, 2.0, 1.0], [-1.0, 0.0, 1.0], [1.0, -2.0, 1.0], [1.0, 0.0, -1.0]

    def conv(v, col, row, scale):
        return _sep(v, col, row, "zero") * scale

    inv_k2 = 1.0 / (a["kappa"] * a["kappa"])
    cur = x
    scores, angles = [], []
    for _ in range(a["num_scales"]):
        for _ in range(a["diffusion_iterations"]):
            gx = conv(cur, s121, d101, 1.0 / 8.0)
            gy = conv(cur, d101, s121, 1.0 / 8.0)
            c = 1.0 / (1.0 + (gx * gx + gy * gy + 1e-8) * inv_k2)
            cur = cur + 0.25 * (conv(c * gx, s121, d101, 1.0 / 8.0)
                                + conv(c * gy, d101, s121, 1.0 / 8.0))
        lxx = conv(cur, s121, l121, 1.0 / 16.0)
        lyy = conv(cur, l121, s121, 1.0 / 16.0)
        lxy = conv(cur, xy, xy, 1.0 / 4.0)
        resp = lxx * lyy - lxy * lxy
        keep = (resp == _maxpool(resp, a["nms_size"] // 2, "zero")) & (resp > a["threshold"])
        scores.append(torch.clamp_min(resp * keep.to(resp.dtype), 0.0))
        m10, m01 = moments(cur, a["orientation_patch_size"], a["orientation_sigma"])
        angles.append(torch.atan2(m01, m10))
    scores, angles = torch.stack(scores), torch.stack(angles)
    best = scores.amax(dim=0)
    mask = (scores == best[None]).to(torch.float32)
    mask = mask / torch.clamp_min(mask.sum(dim=0, keepdim=True), 1.0)
    return best, (angles * mask).sum(dim=0)


# ---- keypoints -----------------------------------------------------------------

def _stable_topk(v: torch.Tensor, k: int):
    s, i = torch.sort(v, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def select(scores: torch.Tensor, k: int, nms_radius: int, threshold: float, margin: int):
    """NMS (score >= window max - 1e-7), border margin and threshold, then
    the k largest maxima of (r+1)^2 blocks, each block's earliest maximal
    pixel; keypoints (B, k, 2) (y, x), (-1, -1) with score 0 where none."""
    b, h, w = scores.shape
    keep = (scores >= _maxpool(scores, nms_radius, "neg_inf") - 1e-7).to(scores.dtype)
    masked = scores * keep
    ys = torch.arange(h, device=scores.device)
    xs = torch.arange(w, device=scores.device)
    inside = ((ys >= margin) & (ys < h - margin))[:, None] & ((xs >= margin) & (xs < w - margin))
    masked = masked * inside.to(masked.dtype)
    masked = torch.where(masked > threshold, masked, 0.0)
    bs = nms_radius + 1
    hb, wb = -(-h // bs), -(-w // bs)
    if hb * wb < k:
        raise ValueError(f"{hb * wb} blocks of {bs}x{bs} cannot hold {k} keypoints")
    blocks = torch.nn.functional.pad(masked, (0, wb * bs - w, 0, hb * bs - h)).reshape(
        b, hb, bs, wb, bs)
    bmax = blocks.amax(dim=(2, 4))
    lin = (torch.arange(hb * bs, device=scores.device)[:, None] * w
           + torch.arange(wb * bs, device=scores.device)[None, :]).reshape(1, hb, bs, wb, bs)
    first = torch.where(blocks == bmax[:, :, None, :, None], lin, 2 ** 62).amin(dim=(2, 4))
    top, blk = _stable_topk(bmax.reshape(b, -1), k)
    idx = torch.gather(first.reshape(b, -1), 1, blk)
    kpts = torch.stack([torch.div(idx, w, rounding_mode="floor"), idx % w], -1).to(torch.float32)
    valid = top > 0
    return torch.where(valid[..., None], kpts, -1.0), torch.where(valid, top, 0.0)


# ---- descriptors -------------------------------------------------------------

@dataclass(frozen=True)
class Table:
    """The learned 512-pair BAD table: each pair's two box offsets (rectified
    around the 32x32 patch centre), its box radius and its threshold."""
    off: torch.Tensor         # (2, 2, P): box, (y, x), pair
    radius: torch.Tensor      # (P,) int64
    thresholds: torch.Tensor  # (P,)
    max_radius: int


def load_table(device, num_pairs: int = 512) -> Table:
    if num_pairs != 512:
        raise ValueError("the reference carries the 512-pair table only")
    with np.load(_TABLE) as z:
        box = z["box_params"].astype(np.float32)
        thr = z["thresholds"].astype(np.float32)
    off = np.stack([np.stack([box[:, 2], box[:, 0]]), np.stack([box[:, 3], box[:, 1]])]) - 16.0
    radius = box[:, 4].astype(np.int64)
    return Table(torch.from_numpy(off).to(device), torch.from_numpy(radius).to(device),
                 torch.from_numpy(thr).to(device), int(radius.max()))


def _nearest(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    b, h, w = img.shape
    idx = torch.round(y).long() * w + torch.round(x).long()
    return torch.gather(img.reshape(b, -1), 1, idx.reshape(b, -1)).reshape(y.shape)


def _box_means(x: torch.Tensor, table: Table) -> torch.Tensor:
    """(B, R+1, H, W): channel r the mean of the (2r+1)^2 box centred on each
    pixel, edges replicated; summed along x, then y, in offset order."""
    b, h, w = x.shape
    rm = table.max_radius
    xp = _pad(x, rm, rm, "edge")
    banks = [x]
    for r in range(1, rm + 1):
        m = rm - r
        sub = xp[:, m:m + h + 2 * r, m:m + w + 2 * r]
        acc = sub[..., :, 0:w]
        for dx in range(1, 2 * r + 1):
            acc = acc + sub[..., :, dx:dx + w]
        bank = acc[..., 0:h, :]
        for dy in range(1, 2 * r + 1):
            bank = bank + acc[..., dy:dy + h, :]
        banks.append(bank / torch.full((), float((2 * r + 1) ** 2), device=x.device))
    return torch.stack(banks, dim=1)


def describe(x: torch.Tensor, kpts: torch.Tensor, table: Table, theta: torch.Tensor,
             binarize: bool, normalize: bool = True) -> torch.Tensor:
    """Oriented sparse BAD descriptors (B, K, P) of (B, H, W) images at
    keypoints (B, K, 2), each pair's offsets rotated by the keypoint's angle
    ``theta`` (B, K) and read at the nearest pixel of the keypoint's 56x56
    window; hard-binarized with ``binarize``, zero at invalid keypoints,
    L2-normalized with ``normalize``."""
    b, h, w = x.shape
    if h < _PATCH or w < _PATCH:
        raise ValueError(f"images must be at least {_PATCH}x{_PATCH}")
    ky = kpts[..., 0].clamp(0.0, h - 1)
    kx = kpts[..., 1].clamp(0.0, w - 1)
    cos_t, sin_t = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    start_y = (torch.div(torch.round(ky).to(torch.int32) - _PATCH_HALF, 8, rounding_mode="floor")
               * 8).clamp(0, (h - _PATCH) // 8 * 8)
    start_x = (torch.round(kx).to(torch.int32) - _PATCH_HALF).clamp(0, w - _PATCH)
    bank = _box_means(x, table).reshape(b, -1)
    chan = table.radius[None, None, :] * (h * w)
    samples = []
    for box in (0, 1):
        oy, ox = table.off[box, 0][None, None, :], table.off[box, 1][None, None, :]
        pos_y = (ky[..., None] + (ox * sin_t + oy * cos_t)).clamp(0.0, h - 1)
        pos_x = (kx[..., None] + (ox * cos_t - oy * sin_t)).clamp(0.0, w - 1)
        sy = start_y[..., None].to(torch.float32)
        sx = start_x[..., None].to(torch.float32)
        iy = torch.round((pos_y - sy).clamp(0.0, _PATCH - 1.0)).long() + start_y[..., None].long()
        ix = torch.round((pos_x - sx).clamp(0.0, _PATCH - 1.0)).long() + start_x[..., None].long()
        idx = (chan + iy * w + ix).reshape(b, -1)
        samples.append(torch.gather(bank, 1, idx).reshape(iy.shape))
    d = (samples[0] - samples[1]) - table.thresholds[None, None, :]
    if binarize:
        d = (d <= 0).to(d.dtype)
    d = d * (kpts[..., 0] >= 0).to(torch.float32)[..., None]
    if normalize:
        d = d / torch.sqrt((d * d).sum(dim=-1, keepdim=True)).clamp_min(1e-12)
    return d


def features(images: torch.Tensor, cfg: dict, table: Table):
    """Keypoints (B, K, 2), their scores (B, K) and descriptors (B, K, P) of
    (B, 1, H, W) images under a configuration's settings."""
    s = cfg["settings"]
    x = images.to(torch.float32)[:, 0]
    margin = table.max_radius if s.get("border_margin") is None else s["border_margin"]
    if cfg["detector"] == "shi_tomasi_angle":
        scores = shi_tomasi(x, s["block_size"])
        m10, m01 = moments(x, s["patch_size"], s["sigma"])
        kpts, ks = select(scores, s["max_keypoints"], s["nms_radius"], s["score_threshold"], margin)
        ky, kx = kpts[..., 0].clamp(0.0, x.shape[1] - 1), kpts[..., 1].clamp(0.0, x.shape[2] - 1)
        theta = torch.atan2(_nearest(m01, ky, kx), _nearest(m10, ky, kx))
    elif cfg["detector"] == "akaze":
        scores, angles = akaze(x, s["akaze"])
        kpts, ks = select(scores, s["max_keypoints"], s["nms_radius"], s["score_threshold"], margin)
        ky, kx = kpts[..., 0].clamp(0.0, x.shape[1] - 1), kpts[..., 1].clamp(0.0, x.shape[2] - 1)
        theta = _nearest(angles, ky, kx)
    else:
        raise ValueError(f"unknown detector {cfg['detector']!r}")
    desc = describe(x, kpts, table, theta, s["binarize"], s["normalize_descriptors"])
    return kpts, ks, desc


# ---- matching ----------------------------------------------------------------

def sinkhorn(d1: torch.Tensor, d2: torch.Tensor, s: dict, precision: str) -> torch.Tensor:
    """(N+1, M+1) assignment of (N, P) and (M, P) descriptors: squared L2
    cost, dustbin scores -unused/eps, marginals [1..1, M] and [1..1, N],
    ``iterations`` log-domain sweeps (rows, then columns)."""
    if s["distance_type"] != "l2":
        raise ValueError("the reference carries the L2 cost only")
    eps = s["epsilon"]
    n, m = d1.shape[0], d2.shape[0]
    cost = torch.clamp_min((d1 * d1).sum(-1, keepdim=True) + (d2 * d2).sum(-1, keepdim=True).T
                           - 2.0 * matmul(d1, d2.T, precision), 0.0)
    ls = torch.nn.functional.pad(-cost / eps, (0, 1, 0, 1), value=-s["unused_score"] / eps)
    dev = d1.device
    log_mu = torch.zeros(n + 1, device=dev)
    log_nu = torch.zeros(m + 1, device=dev)
    log_mu[n] = math.log(m)
    log_nu[m] = math.log(n)
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(s["sinkhorn_iterations"]):
        u = log_mu - torch.logsumexp(ls + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(ls + u[:, None], dim=0)
    return torch.exp(ls + u[:, None] + v[None, :])


def mutual_matches(p: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor, s: dict):
    """Mutual-NN matches of P above ``match_threshold``, the
    ``max_matches`` most probable (ties to the lower index): matched
    keypoints (L, 2) each and their probabilities (L,)."""
    n, m = k1.shape[0], k2.shape[0]
    core = p[:n, :m]
    best_j = torch.argmax(core, dim=1)
    best_p = core.amax(dim=1)
    best_i = torch.argmax(core, dim=0)
    ok = (best_i[best_j] == torch.arange(n, device=p.device)) & (best_p >= s["match_threshold"])
    top, idx = _stable_topk(torch.where(ok, best_p, -1.0), min(s["max_matches"], n))
    keep = top > 0
    idx = idx[keep]
    return k1[idx], k2[best_j[idx]], top[keep]


# ---- essential matrix ----------------------------------------------------------

def _kth(p: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """The k-th largest value along ``dim`` (duplicates counted), keepdim."""
    return torch.sort(p, dim=dim, descending=True).values.narrow(dim, k - 1, 1)


def essential(p: torch.Tensor, k1, ks1, k2, ks2, k_inv: torch.Tensor, precision: str,
              top_k: int = 3, floor: float = 0.01):
    """The soft weighted 8-point E (x2^T E x1 = 0) from P: weights are the
    entries top-``top_k`` in their row and column and above ``floor``
    (valid keypoints only); weighted Hartley normalization of both point
    sets; the normal matrix's least eigenvector in float64; denormalized;
    projected to singular values (s, s, 0) in float64. Returns E (3, 3)
    float32 on the host and the normal matrix's eigenvalues, ascending."""
    n, m = k1.shape[0], k2.shape[0]
    core = p[:n, :m] * (ks1 > 0).to(p.dtype)[:, None] * (ks2 > 0).to(p.dtype)[None, :]
    w = core * ((core >= _kth(core, top_k, 1)) & (core >= _kth(core, top_k, 0))
                & (core > floor)).to(core.dtype)

    def norm_pts(k):
        xy1 = torch.stack([k[:, 1], k[:, 0], torch.ones_like(k[:, 0])], -1)
        return matmul(xy1, k_inv.T, precision)[:, :2]

    def hartley(pts, wt):
        ws = wt.sum() + 1e-8
        c = (wt[:, None] * pts).sum(0) / ws
        md = torch.sqrt((wt * ((pts - c) ** 2).sum(-1)).sum() / ws + 1e-8)
        sc = math.sqrt(2.0) / (md + 1e-8)
        t = torch.zeros(3, 3, device=pts.device)
        t[0, 0] = t[1, 1] = sc
        t[0, 2], t[1, 2], t[2, 2] = -sc * c[0], -sc * c[1], 1.0
        h = torch.cat([(pts - c) * sc, torch.ones_like(pts[:, :1])], -1)
        return t, h

    t1, h1 = hartley(norm_pts(k1), w.sum(1))
    t2, h2 = hartley(norm_pts(k2), w.sum(0))
    f1 = (h1[:, :, None] * h1[:, None, :]).reshape(n, 9)
    f2 = (h2[:, :, None] * h2[:, None, :]).reshape(m, 9)
    mm = matmul(f1.T, matmul(w, f2, precision), precision)
    mm = mm.reshape(3, 3, 3, 3).permute(0, 2, 1, 3).reshape(9, 9)
    eig, vec = torch.linalg.eigh(mm.double().cpu())
    e_raw = vec[:, 0].reshape(3, 3)
    e = (t1.double().cpu().T @ e_raw @ t2.double().cpu()).T
    u, sv, vt = torch.linalg.svd(e)
    s_avg = (sv[0] + sv[1]) / 2.0
    e = u @ torch.diag(torch.stack([s_avg, s_avg, torch.zeros_like(s_avg)])) @ vt
    return e.to(torch.float32), eig
