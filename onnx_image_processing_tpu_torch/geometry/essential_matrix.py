"""Weighted 8-point essential-matrix estimation (port of
``onnx_image_processing_tpu/geometry/essential_matrix.py``).

Plain PyTorch around three kernels: the JAX package runs all of this
outside any Pallas kernel, and its ``eigh``, ``svd`` and hypothesis solve
run on the card as ``kernels/essential_solve.py`` (:func:`min_eigvec9`,
:func:`project_onto_essential_manifold`, the hypothesis stage of
:func:`essential_ransac_from_candidates`; on a CPU tensor their plain
versions). The functions take leading batch dimensions where JAX ``vmap``s
them (the RANSAC hypotheses), so the batched and the single solve are one
code path. Every product runs in full float32 (:func:`..core.full_fp32`),
where JAX pins ``Precision.HIGHEST``: on the card a float32 product may
otherwise run as TF32; the 9x9 eigenproblems are solved in float64
(:func:`min_eigvec9`). Nothing branches on a tensor's value or reads one on
the host, so a solve on the card can be captured in a CUDA graph.
"""

from __future__ import annotations

import functools
import math

import torch

from ..core import full_fp32
from ..ops.keypoints import _top_k
from ._gumbel import gumbel_table


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product in full float32."""
    with full_fp32():
        return torch.matmul(a, b)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., n, n) x (..., n) -> (..., n) in full float32."""
    return _mm(m, v[..., None])[..., 0]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _trace(m: torch.Tensor) -> torch.Tensor:
    return m.diagonal(dim1=-2, dim2=-1).sum(-1)


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Cofactor-expansion determinant of (..., 3, 3) matrices."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _chol_solve(a: torch.Tensor, rhs: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """Cholesky factor + solve of a small static-size SPD system, unrolled
    scalar by scalar as in JAX. ``a`` (..., n, n), ``rhs`` (..., n),
    ``jitter`` a scalar or (...) tensor added to the diagonal."""
    n = a.shape[-1]
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j] + jitter if i == j else a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp_min(s, 1e-30))
            else:
                l[i][j] = s / l[j][j]
    y = [None] * n
    for i in range(n):
        s = rhs[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, dim=-1)


def min_eigvec9(m: torch.Tensor, n_iter: int = 30, method: str = "eigh") -> torch.Tensor:
    """Minimum eigenvector of symmetric PSD (..., 9, 9) matrices.

    ``"eigh"``: exact, in float64 (:func:`..kernels.essential_solve.min_eigvec9`:
    ``torch.linalg.eigh`` on a CPU tensor, a Jacobi kernel on a CUDA one).
    The normal matrix is ill-conditioned, and a float32 eigh on an H100
    (cuSOLVER) returned a worse smallest eigenvector than the CPU's: on
    ``chip_smoke.py`` phase 7's VO frames the RANSAC refit with it tripled
    the median t-direction error of the recovered pose (16.8 deg against
    the CPU's 5.7). ``"fast"``: shifted inverse
    iteration with the unrolled 9x9 Cholesky solve (three steps).
    ``"power"``: the reference's trace-shifted power iteration, for parity
    tests only (it does not converge in ``n_iter`` steps on real data).
    """
    if method == "fast":
        # delta regularizes the exactly singular case; it shifts the
        # spectrum uniformly, so the minimizer is unchanged.
        delta = 1e-6 * _trace(m) / 9.0 + 1e-30
        v = torch.full(m.shape[:-1], 1.0 / 3.0, dtype=m.dtype, device=m.device)
        for _ in range(3):
            v = _chol_solve(m, v, jitter=delta)
            v = v / (_norm(v) + 1e-30)
        return v
    if method == "eigh":
        from ..kernels import essential_solve

        return essential_solve.min_eigvec9(m)
    if method != "power":
        raise ValueError(f"min_eigvec9: unknown method {method!r} "
                         "(expected 'eigh', 'fast', or 'power')")
    eye = torch.eye(9, dtype=m.dtype, device=m.device)
    m_s = _trace(m)[..., None, None] * eye - m
    v = torch.full(m.shape[:-1], 1.0 / 3.0, dtype=m.dtype, device=m.device)
    for _ in range(n_iter):
        v = _mv(m_s, v)
        v = v / (_norm(v) + 1e-8)
    return v


def _power_iter3(b: torch.Tensor, n_iter: int) -> torch.Tensor:
    v = torch.full(b.shape[:-1], 1.0 / math.sqrt(3.0), dtype=b.dtype, device=b.device)
    for _ in range(n_iter):
        v = _mv(b, v)
        v = v / (_norm(v) + 1e-8)
    return v


def _eig3_sym(b: torch.Tensor):
    """Analytic eigenvalues (descending) of symmetric (..., 3, 3) matrices
    (Cardano's trigonometric form)."""
    q = _trace(b) / 3.0
    p1 = b[..., 0, 1] ** 2 + b[..., 0, 2] ** 2 + b[..., 1, 2] ** 2
    p2 = ((b[..., 0, 0] - q) ** 2 + (b[..., 1, 1] - q) ** 2
          + (b[..., 2, 2] - q) ** 2 + 2.0 * p1)
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))
    bn = (b - q[..., None, None] * _eye3(b)) / p[..., None, None]
    r = torch.clamp(_det3(bn) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3
    return lam1, lam2, lam3


def _largest_column(m: torch.Tensor) -> torch.Tensor:
    """Column of (..., 3, 3) matrices with the largest norm; ties go to the
    lower index (branch-free)."""
    n = (m * m).sum(-2)
    first = n[..., 0] >= n[..., 1]
    c01 = torch.where(first[..., None], m[..., :, 0], m[..., :, 1])
    n01 = torch.where(first, n[..., 0], n[..., 1])
    return torch.where((n01 >= n[..., 2])[..., None], c01, m[..., :, 2])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _compose(u: torch.Tensor, s_avg: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u diag(s_avg, s_avg, 0) v^T."""
    d = torch.stack([s_avg, s_avg, torch.zeros_like(s_avg)], dim=-1)
    return _mm(_mm(u, torch.diag_embed(d)), v.transpose(-1, -2))


def _with_sign(cols, sign):
    """Stack three column vectors, the third times ``sign``."""
    return torch.stack([cols[0], cols[1], cols[2] * sign[..., None]], dim=-1)


def _project_from_v(e: torch.Tensor, v1, v2, v3, eps: float) -> torch.Tensor:
    """The tail shared by the ``exact3`` and ``power`` projections: right
    basis (v1, v2, v3) with its det sign fixed, left basis from E v, equal
    singular values."""
    v = torch.stack([v1, v2, v3], dim=-1)
    v = _with_sign((v1, v2, v3), torch.sign(_det3(v)))
    ev0 = _mv(e, v[..., :, 0])
    ev1 = _mv(e, v[..., :, 1])
    sigma1 = torch.linalg.vector_norm(ev0, dim=-1)
    sigma2 = torch.linalg.vector_norm(ev1, dim=-1)
    s_avg = (sigma1 + sigma2) / 2.0
    u1 = ev0 / (sigma1[..., None] + eps)
    u2 = ev1 / (sigma2[..., None] + eps)
    u3 = _cross(u1, u2)
    u = _with_sign((u1, u2, u3), torch.sign(_det3(torch.stack([u1, u2, u3], dim=-1))))
    return _compose(u, s_avg, v)


def project_onto_essential_manifold(e: torch.Tensor, n_iter: int = 10,
                                    method: str = "svd") -> torch.Tensor:
    """Project (..., 3, 3) matrices to singular values [s, s, 0].

    ``"svd"``: exact (:func:`..kernels.essential_solve.project_essential`:
    ``torch.linalg.svd`` with the det-sign correction of U and V on a CPU
    tensor, a float64 kernel on a CUDA one). ``"exact3"``: closed form
    from the analytic eigenvalues of E^T E (null direction from an
    adjugate column, v1 from the deflation product, with a fallback axis
    when lam1 ~ lam2). ``"power"``: the reference's
    power-iteration SVD, for parity tests.
    """
    if method == "svd":
        from ..kernels import essential_solve

        return essential_solve.project_essential(e)
    if method == "exact3":
        b = _mm(e.transpose(-1, -2), e)
        lam1, lam2, lam3 = _eig3_sym(b)
        eye = _eye3(b)
        # v3: every column of adj(B - lam3 I) lies along the null direction;
        # the largest one is numerically safest.
        a3 = b - lam3[..., None, None] * eye
        adj3 = torch.stack([_cross(a3[..., :, 1], a3[..., :, 2]),
                            _cross(a3[..., :, 2], a3[..., :, 0]),
                            _cross(a3[..., :, 0], a3[..., :, 1])], dim=-1)
        v3 = _largest_column(adj3)
        v3 = v3 / (_norm(v3) + 1e-30)
        # v1 from (B - lam2 I)(B - lam3 I) = (lam1-lam2)(lam1-lam3) v1 v1^T,
        # with v3 projected out; the coordinate axis least aligned with v3
        # stands in when that product vanishes.
        prod = _mm(b - lam2[..., None, None] * eye, b - lam3[..., None, None] * eye)
        v1 = _largest_column(prod)
        v1 = v1 - (v1 * v3).sum(-1, keepdim=True) * v3
        fb = torch.nn.functional.one_hot(torch.argmin(v3.abs(), dim=-1), 3).to(e.dtype)
        fb = fb - (fb * v3).sum(-1, keepdim=True) * v3
        n1 = _norm(v1)
        keep = n1 > (1e-12 * lam1.abs() * (lam1 - lam3).abs() + 1e-30)[..., None]
        v1 = torch.where(keep, v1 / (n1 + 1e-30), fb / (_norm(fb) + 1e-30))
        v2 = _cross(v3, v1)
        v2 = v2 / (_norm(v2) + 1e-30)
        return _project_from_v(e, v1, v2, v3, 1e-30)
    if method != "power":
        raise ValueError(f"project_onto_essential_manifold: unknown method "
                         f"{method!r} (expected 'svd', 'exact3', or 'power')")
    b = _mm(e.transpose(-1, -2), e)
    v1 = _power_iter3(b, n_iter)
    v3 = _power_iter3(_trace(b)[..., None, None] * _eye3(b) - b, n_iter)
    v2 = _cross(v3, v1)
    v2 = v2 / (_norm(v2) + 1e-8)
    return _project_from_v(e, v1, v2, v3, 1e-8)


def hartley_normalization(pts: torch.Tensor, weights: torch.Tensor):
    """Weighted Hartley normalization: centroid to the origin, weighted RMS
    distance sqrt(2).

    Args:
        pts: (..., N, 2) points; weights: (..., N).

    Returns:
        (T (..., 3, 3), scale (...), centroid (..., 2)).
    """
    w_sum = weights.sum(-1) + 1e-8
    centroid = (weights[..., None] * pts).sum(-2) / w_sum[..., None]
    dist_sq = ((pts - centroid[..., None, :]) ** 2).sum(-1)
    mean_dist = torch.sqrt((weights * dist_sq).sum(-1) / w_sum + 1e-8)
    scale = math.sqrt(2.0) / (mean_dist + 1e-8)
    z = torch.zeros_like(scale)
    o = torch.ones_like(scale)
    t = torch.stack([
        torch.stack([scale, z, -scale * centroid[..., 0]], dim=-1),
        torch.stack([z, scale, -scale * centroid[..., 1]], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)
    return t, scale, centroid


def _kth_largest(p: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """k-th largest value (duplicates counted) along ``dim``, keepdim, by k
    max/count sweeps: ``t`` is the c-th distinct level from the top and
    ``cnt`` counts the elements >= t; once cnt >= k, t is the answer."""
    t = p.amax(dim=dim, keepdim=True)
    cnt = (p >= t).sum(dim=dim, keepdim=True)
    for _ in range(k - 1):
        nxt = torch.where(p < t, p, -torch.inf).amax(dim=dim, keepdim=True)
        need_more = cnt < k
        t = torch.where(need_more, nxt, t)
        cnt = torch.where(need_more, (p >= t).sum(dim=dim, keepdim=True), cnt)
    return t


def bidirectional_topk_weights(p_core: torch.Tensor, top_k: int = 3,
                               prob_threshold: float = 0.01) -> torch.Tensor:
    """Keep P[i, j] only where it is top-k in both its row and its column and
    above an absolute threshold; the survivors are the 8-point weights."""
    if p_core.shape[0] < top_k or p_core.shape[1] < top_k:
        raise ValueError(
            f"bidirectional_topk_weights: P core shape {tuple(p_core.shape)} "
            f"has an axis shorter than top_k={top_k}")
    thresh_row = _kth_largest(p_core, top_k, dim=1)      # (N, 1)
    thresh_col = _kth_largest(p_core, top_k, dim=0)      # (1, M)
    mask = (p_core >= thresh_row) & (p_core >= thresh_col) & (p_core > prob_threshold)
    return p_core * mask.to(p_core.dtype)


def _homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def sampson_error_matrix(e: torch.Tensor, pts1_n: torch.Tensor,
                         pts2_n: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """All-pairs Sampson error for ``x2^T E x1 = 0``: (N, M) from (N, 2) and
    (M, 2) normalized (x, y) points."""
    f1, f2 = _homogeneous(pts1_n), _homogeneous(pts2_n)
    l2 = _mm(f1, e.transpose(-1, -2))                  # (N, 3) = E x1
    l1 = _mm(f2, e)                                    # (M, 3) = E^T x2
    numer = _mm(l2, f2.transpose(-1, -2)) ** 2         # (N, M)
    denom = ((l2[:, 0] ** 2 + l2[:, 1] ** 2)[:, None]
             + (l1[:, 0] ** 2 + l1[:, 1] ** 2)[None, :])
    return numer / (denom + eps)


def sampson_error_matched(e: torch.Tensor, pts1_n: torch.Tensor,
                          pts2_n: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-correspondence Sampson error of matched (N, 2) point pairs under
    (..., 3, 3) essential matrices: (..., N)."""
    f1, f2 = _homogeneous(pts1_n), _homogeneous(pts2_n)
    l2 = _mm(f1, e.transpose(-1, -2))                  # (..., N, 3) = E x1
    l1 = _mm(f2, e)                                    # (..., N, 3) = E^T x2
    numer = (l2 * f2).sum(-1) ** 2
    denom = l2[..., 0] ** 2 + l2[..., 1] ** 2 + l1[..., 0] ** 2 + l1[..., 1] ** 2
    return numer / (denom + eps)


def essential_from_matched_points(weights: torch.Tensor, pts1_n: torch.Tensor,
                                  pts2_n: torch.Tensor, method: str = "eigh",
                                  project: bool = True) -> torch.Tensor:
    """Weighted 8-point solve on 1-1 matched correspondences.

    Args:
        weights: (..., N) per-correspondence weights.
        pts1_n / pts2_n: (..., N, 2) normalized (x, y) points, row i of one
            matched with row i of the other.
        method: "eigh" (exact) or "fast" (unrolled-Cholesky inverse
            iteration; the projection then takes the closed form).
        project: apply the essential-manifold projection (hypothesis
            scoring skips it).

    Returns:
        (..., 3, 3) essential matrices, ``x2^T E x1 = 0``.
    """
    n = pts1_n.shape[-2]
    t1, s1, c1 = hartley_normalization(pts1_n, weights)
    t2, s2, c2 = hartley_normalization(pts2_n, weights)
    h1 = _homogeneous((pts1_n - c1[..., None, :]) * s1[..., None, None])
    h2 = _homogeneous((pts2_n - c2[..., None, :]) * s2[..., None, None])
    # Design rows kron(h1_i, h2_i), index a*3+b: the all-pairs solve's
    # layout, so the same transposed denormalization applies.
    a = (h1[..., :, :, None] * h2[..., :, None, :]).reshape(*h1.shape[:-2], n, 9)
    m_mat = _mm(a.transpose(-1, -2), weights[..., None] * a)
    e_raw = min_eigvec9(m_mat, method=method).reshape(*m_mat.shape[:-2], 3, 3)
    e_denorm = _mm(_mm(t1.transpose(-1, -2), e_raw), t2).transpose(-1, -2)
    if not project:
        return e_denorm
    return project_onto_essential_manifold(
        e_denorm, method="exact3" if method == "fast" else "svd")


@functools.lru_cache(maxsize=8)
def _gumbel_on(seed: int, hypotheses: int, n: int, device: str) -> torch.Tensor:
    """The (hypotheses, n) Gumbel table on ``device``, made once."""
    return torch.from_numpy(gumbel_table(seed, hypotheses, n)).to(device)


def essential_ransac_from_candidates(weights: torch.Tensor, pts1_n: torch.Tensor,
                                     pts2_n: torch.Tensor, tau,
                                     hypotheses: int = 128,
                                     polish_iters: int = 2,
                                     seed: int = 0) -> torch.Tensor:
    """Fixed-shape vectorized RANSAC over matched candidates.

    1. Minimal samples by the Gumbel-top-k trick: ``top_8(log w + G)`` over
       JAX's own (hypotheses, N) Gumbel table (``_gumbel.py``), so the
       hypotheses are JAX's.
    2. All hypotheses solved at once (``method="fast"``, no projection;
       :func:`..kernels.essential_solve.essential_hypotheses`, one kernel
       launch on the card).
    3. MSAC score ``sum_i w_i max(0, 1 - sampson_i / tau)`` per hypothesis.
    4. Weighted refit on the best hypothesis's inliers, then
       ``polish_iters`` re-gated Cauchy-IRLS steps whose gate is floored at
       4x the median residual of that inlier core.

    Args:
        weights: (N,) candidate weights; <= 0 marks invalid rows.
        pts1_n / pts2_n: (N, 2) matched normalized (x, y) candidates.
        tau: squared-Sampson inlier threshold, (px / fx)^2.

    Returns:
        (3, 3) essential matrix.
    """
    from ..kernels import essential_solve

    n = weights.shape[0]
    dev = weights.device
    tau = torch.as_tensor(tau, dtype=torch.float32, device=dev)
    valid = weights > 0
    logw = torch.where(valid, torch.log(torch.clamp_min(weights, 1e-30)), -torch.inf)
    gumbel = _gumbel_on(seed, hypotheses, n, str(dev))
    _, idx = _top_k(logw[None, :] + gumbel, 8)                       # (S, 8)

    p1h = pts1_n[idx]                                                # (S, 8, 2)
    p2h = pts2_n[idx]
    # Uniform weights over the sampled valid points; an invalid pick zeroes
    # out and its hypothesis degrades to a lower-rank fit, scored low.
    w8 = valid[idx].to(torch.float32)
    e_h = essential_solve.essential_hypotheses(w8, p1h, p2h)          # (S, 3, 3)

    s_all = sampson_error_matched(e_h, pts1_n, pts2_n)               # (S, N)
    msac = torch.clamp_min(1.0 - s_all / (tau + 1e-30), 0.0)
    best = torch.argmax((weights[None, :] * msac).sum(dim=1))
    s_best = s_all.index_select(0, best[None])[0]
    w_in = weights * (s_best < tau).to(weights.dtype)
    e = essential_from_matched_points(w_in, pts1_n, pts2_n)

    if polish_iters:
        # Re-gate the inliers against the polished model each step, with
        # the gate floored at 4x the median residual of the trusted core
        # (the best hypothesis's inliers), so a tau near the inlier scale
        # cannot collapse the set (see the JAX docstring for the measured
        # failure modes this form avoids).
        in_core = w_in > 0
        mid = torch.clamp(torch.div(in_core.sum() - 1, 2, rounding_mode="floor"), 0, n - 1)
        for _ in range(polish_iters):
            s = sampson_error_matched(e, pts1_n, pts2_n)
            s_sorted = torch.sort(torch.where(in_core, s, torch.inf)).values
            sigma = s_sorted.index_select(0, mid[None])[0]
            gate_tau = torch.maximum(tau, 4.0 * torch.where(torch.isfinite(sigma), sigma, 0.0))
            gate = (s < gate_tau).to(weights.dtype)
            infl = 1.0 / (1.0 + s / (gate_tau + 1e-18))
            e = essential_from_matched_points(weights * gate * infl, pts1_n, pts2_n)
    return e


def essential_from_weighted_points(weights: torch.Tensor, pts1_n: torch.Tensor,
                                   pts2_n: torch.Tensor, n_iter: int = 30,
                                   n_iter_manifold: int = 10,
                                   method: str = "eigh", irls_iters: int = 0,
                                   irls_tau=None) -> torch.Tensor:
    """Weighted 8-point solve from (N, M) pair weights and normalized point
    sets pts1_n (N, 2), pts2_n (M, 2).

    ``method`` as :func:`min_eigvec9`; ``"power"`` also takes the
    reference's denormalization T2^T E_raw T1. ``irls_iters`` > 0 adds
    Cauchy reweighting by Sampson error (scale ``irls_tau``, else 0.25 of
    the weighted mean error); not with ``"power"``.

    Returns:
        (3, 3) essential matrix.
    """
    if irls_iters and method == "power":
        raise ValueError("irls_iters requires method 'eigh' or 'fast' "
                         "(method='power' is the reference-parity mode)")
    n = pts1_n.shape[0]
    m = pts2_n.shape[0]

    def solve(w):
        t1, s1, c1 = hartley_normalization(pts1_n, w.sum(dim=1))
        t2, s2, c2 = hartley_normalization(pts2_n, w.sum(dim=0))
        h1 = _homogeneous((pts1_n - c1) * s1)
        h2 = _homogeneous((pts2_n - c2) * s2)
        f1_flat = (h1[:, :, None] * h1[:, None, :]).reshape(n, 9)
        f2_flat = (h2[:, :, None] * h2[:, None, :]).reshape(m, 9)
        m_flat = _mm(f1_flat.T, _mm(w, f2_flat))                     # (9, 9)
        m_mat = m_flat.reshape(3, 3, 3, 3).permute(0, 2, 1, 3).reshape(9, 9)
        e_raw = min_eigvec9(m_mat, n_iter, method=method).reshape(3, 3)
        if method == "power":
            e_denorm = _mm(_mm(t2.T, e_raw), t1)
            return project_onto_essential_manifold(e_denorm, n_iter_manifold,
                                                   method="power")
        # e_raw satisfies x1_hn^T e_raw x2_hn = 0, so the standard
        # (x2^T E x1 = 0) denormalization is (T1^T e_raw T2)^T.
        e_denorm = _mm(_mm(t1.T, e_raw), t2).T
        return project_onto_essential_manifold(
            e_denorm, method="exact3" if method == "fast" else "svd")

    e = solve(weights)
    for _ in range(irls_iters):
        s = sampson_error_matrix(e, pts1_n, pts2_n)
        if irls_tau is not None:
            tau = torch.as_tensor(irls_tau, dtype=torch.float32, device=weights.device)
        else:
            tau = 0.25 * (weights * s).sum() / (weights.sum() + 1e-12)
        e = solve(weights * (1.0 / (1.0 + s / (tau + 1e-18))))
    return e


def estimate_essential_matrix(p: torch.Tensor, k_inv: torch.Tensor,
                              image_shape: tuple[int, int] = (32, 32),
                              top_k: int = 3, n_iter: int = 30,
                              n_iter_manifold: int = 10,
                              prob_threshold: float = 0.01,
                              method: str = "eigh") -> torch.Tensor:
    """Standalone estimator: P (N+1, M+1) with feature index i at pixel
    (x = i % W, y = i // W) of ``image_shape``, normalized by ``k_inv``.

    Returns:
        (3, 3) essential matrix.
    """
    n = p.shape[0] - 1
    m = p.shape[1] - 1
    h, w = image_shape
    if h * w < n:
        raise ValueError(f"grid {image_shape} too small for N={n}")
    if h * w < m:
        raise ValueError(f"grid {image_shape} too small for M={m}")
    weights = bidirectional_topk_weights(p[:n, :m].to(torch.float32), top_k,
                                         prob_threshold)
    idx = torch.arange(h * w, dtype=torch.float32, device=p.device)
    coords_h = torch.stack([torch.remainder(idx, w),
                            torch.div(idx, w, rounding_mode="floor"),
                            torch.ones_like(idx)], dim=-1)            # (H*W, 3)
    coords_n = _mm(coords_h, k_inv.to(torch.float32).T)[:, :2]
    return essential_from_weighted_points(weights, coords_n[:n], coords_n[:m],
                                          n_iter, n_iter_manifold, method)


def estimate_essential_from_keypoints(p: torch.Tensor, keypoints1: torch.Tensor,
                                      keypoints2: torch.Tensor,
                                      valid1: torch.Tensor, valid2: torch.Tensor,
                                      k_inv: torch.Tensor, top_k: int = 3,
                                      n_iter: int = 30, n_iter_manifold: int = 10,
                                      method: str = "eigh", irls_iters: int = 0,
                                      irls_px: float = 2.0,
                                      ransac_hypotheses: int = 0,
                                      ransac_px: float = 0.75) -> torch.Tensor:
    """E from (y, x) keypoints and their Sinkhorn matrix (batch-free).

    Invalid keypoints get zero weight before the solve. ``ransac_hypotheses``
    > 0 runs :func:`essential_ransac_from_candidates` over the mutual best
    matches of P (threshold ``ransac_px`` pixels, ``irls_iters`` polish
    steps); 0 keeps the soft-weighted LS solve (+ optional IRLS at
    ``irls_px`` pixels).

    Args:
        p: (K+1, K+1); keypoints*: (K, 2) (y, x); valid*: (K,) bool;
            k_inv: (3, 3).

    Returns:
        (3, 3) essential matrix.
    """
    n = keypoints1.shape[0]
    m = keypoints2.shape[0]
    p_core = p[:n, :m].to(torch.float32)
    p_core = p_core * valid1.to(p_core.dtype)[:, None] * valid2.to(p_core.dtype)[None, :]
    k_inv = k_inv.to(torch.float32)

    def normalize(kpts):
        xy1 = torch.stack([kpts[:, 1], kpts[:, 0], torch.ones_like(kpts[:, 0])], dim=-1)
        return _mm(xy1, k_inv.T)[:, :2]

    if ransac_hypotheses:
        # Candidates: the mutual best matches of P (first index on ties, as
        # jnp.argmax), weighted by their probability, one per image-1 point.
        j_best = torch.argmax(p_core, dim=1)                           # (N,)
        i_best = torch.argmax(p_core, dim=0)                           # (M,)
        mutual = i_best[j_best] == torch.arange(n, device=p.device)
        w = torch.gather(p_core, 1, j_best[:, None])[:, 0] * mutual.to(torch.float32)
        w = w * (w > 0.01)  # the reference's absolute probability floor
        tau = (ransac_px * k_inv[0, 0]) ** 2
        return essential_ransac_from_candidates(
            w, normalize(keypoints1), normalize(keypoints2)[j_best], tau,
            hypotheses=ransac_hypotheses, polish_iters=irls_iters)

    weights = bidirectional_topk_weights(p_core, top_k)
    # Camera-aware IRLS scale (px / fx)^2, from the run-time intrinsics.
    tau = (irls_px * k_inv[0, 0]) ** 2 if irls_iters else None
    return essential_from_weighted_points(weights, normalize(keypoints1),
                                          normalize(keypoints2), n_iter,
                                          n_iter_manifold, method,
                                          irls_iters=irls_iters, irls_tau=tau)
