"""Otsu and multi-Otsu thresholding (port of
``onnx_image_processing_tpu/ops/threshold.py``).

Class statistics are prefix sums of the histogram; multi-Otsu searches the
whole threshold grid. The histogram follows ``jnp.bincount(x, length=n)``:
negative values count in bin 0 and values at or past ``n`` are dropped
(``torch.bincount`` would grow the histogram instead, which moves every
multi-Otsu threshold of an image that holds ``max_val``).
"""

from __future__ import annotations

import itertools

import torch


def _histogram(values: torch.Tensor, length: int) -> torch.Tensor:
    """float32 counts of the int32 ``values`` in ``length`` bins, as
    ``jnp.bincount(values, length=length)``."""
    idx = values.reshape(-1).to(torch.int64).clamp(min=0)
    keep = idx < length
    hist = torch.zeros(length, dtype=torch.int64, device=values.device)
    hist.scatter_add_(0, idx.clamp(max=length - 1), keep.to(torch.int64))
    return hist.to(torch.float32)


def otsu_threshold(img: torch.Tensor, min_val: int = 0, max_val: int = 255):
    """Otsu's binarization threshold and the binarized image.

    Args:
        img: (H, W) integer-valued image in [min_val, max_val].

    Returns:
        (thresh (int32 0-dim tensor), bin_img (H, W) int32 in
        {min_val, max_val}); pixels <= thresh + min_val map to min_val.
    """
    bins = max_val - min_val + 1
    hist = _histogram(img.to(torch.int32) - min_val, bins)
    vals = torch.arange(min_val, max_val + 1, dtype=torch.float32, device=img.device)
    csum = torch.cumsum(hist, 0)
    cval = torch.cumsum(hist * vals, 0)
    num_wh = csum[-1] - csum
    mean_bk = cval / csum                      # NaN where the class is empty
    mean_wh = (cval[-1] - cval) / num_wh
    var = csum * num_wh * (mean_bk - mean_wh) ** 2
    var = torch.where(torch.isnan(var), 0.0, var)
    thresh = torch.argmax(var).to(torch.int32)
    bin_img = torch.where(img <= thresh + min_val, min_val, max_val).to(torch.int32)
    return thresh, bin_img


def multi_otsu_threshold(x: torch.Tensor, min_val: int = 0, max_val: int = 255,
                         n_class: int = 3, calc_hist: bool = True):
    """n-class Otsu thresholds by exhaustive search over the threshold grid.

    As the reference: BINS = max_val - min_val (not + 1), class c covers
    bins [t_{c-1}, t_c), and each returned threshold is the last bin of its
    class (t_c - 1). Maximizes sum_{i<j} n_i n_j (mu_i - mu_j)^2; the first
    maximum in raster order of the grid wins.

    Args:
        x: (H, W) image (``calc_hist=True``) or a (BINS,) histogram.

    Returns:
        tuple of (n_class - 1) int32 0-dim tensors.
    """
    if n_class < 2:
        raise ValueError(f"n_class must be >= 2, got {n_class}")
    bins = max_val - min_val
    dev = x.device
    hist = (_histogram(x.to(torch.int32) - min_val, bins) if calc_hist
            else x.to(torch.float32))
    vals = torch.arange(min_val, max_val, dtype=torch.float32, device=dev)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    cs_n = torch.cat([zero, torch.cumsum(hist, 0)])
    cs_v = torch.cat([zero, torch.cumsum(hist * vals, 0)])

    n_t = n_class - 1
    axis = torch.arange(1, bins, device=dev)
    grids = torch.meshgrid(*[axis] * n_t, indexing="ij")
    valid = torch.ones(grids[0].shape, dtype=torch.bool, device=dev)
    for a in range(n_t - 1):
        valid &= grids[a] < grids[a + 1]

    bounds = [torch.zeros_like(grids[0])] + list(grids) + [torch.full_like(grids[0], bins)]
    nums, means = [], []
    for c in range(n_class):
        lo, hi = bounds[c], bounds[c + 1]
        n_c = cs_n[hi] - cs_n[lo]
        nums.append(n_c)
        means.append((cs_v[hi] - cs_v[lo]) / n_c)  # NaN where empty
    var = torch.zeros(grids[0].shape, dtype=torch.float32, device=dev)
    for i, j in itertools.combinations(range(n_class), 2):
        var = var + nums[i] * nums[j] * (means[i] - means[j]) ** 2
    var = torch.where(torch.isnan(var) | ~valid, 0.0, var)
    flat = torch.argmax(var.reshape(-1))
    idxs = torch.unravel_index(flat, var.shape)
    return tuple((g[idxs] - 1).to(torch.int32) for g in grids)
