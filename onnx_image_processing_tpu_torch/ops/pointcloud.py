"""Voxel-grid point-cloud downsampling with static shapes (port of
``onnx_image_processing_tpu/ops/pointcloud.py``).

The output is always (N, D) plus an (N,) mask: the first M rows are the
voxel centroids in sorted-key order, the rest zero. Two stable sorts and a
prefix sum, and no ``nonzero``, boolean indexing or ``.item()`` (each would
wait for the device and give a shape that depends on the data):

1. ``torch.sort(key, stable=True)`` orders the points by linearized voxel
   key; the coordinates follow by a gather.
2. Group sums come from an inclusive ``cumsum`` of the residuals
   ``p - floor(p / leaf) * leaf`` (each below ``leaf``, so the running sum
   stays small), differenced at the group ends; the group's base is added
   back after the mean. On the card the scan is parallel and rounds
   otherwise than the CPU's sequential one.
3. A second stable sort, on the not-end flag, moves the group ends to the
   front in key order.

The key is int32 and wraps as the JAX package's does at extreme
range / leaf ratios (rare key collisions), never widened: int64 would
change which keys collide. The JAX package's first sort is unstable, so a
group's residuals are summed in another order there: centroids agree to a
tolerance, the mask and M exactly. ``leaf_size`` becomes a 0-dim tensor on
the points' device, because PyTorch's CUDA division by a Python or CPU
scalar multiplies by its reciprocal, which can move a point on a voxel
boundary into the next voxel.
"""

from __future__ import annotations

import torch


def voxel_downsampling(points: torch.Tensor, leaf_size) -> tuple[torch.Tensor, torch.Tensor]:
    """Average the points within each voxel cell.

    Args:
        points: (N, D) coordinates (typically D = 3).
        leaf_size: voxel edge length (a number or a 0-dim tensor).

    Returns:
        (centroids (N, D) float32, mask (N,) bool): the first M rows are
        the voxel centroids ordered by voxel key, the rest zero.
    """
    n, d = points.shape
    if n == 0:
        return points, torch.ones((0,), dtype=torch.bool, device=points.device)
    pts = points.to(torch.float32)
    leaf = torch.as_tensor(leaf_size, dtype=torch.float32, device=pts.device).reshape(())

    vox = torch.floor(pts / leaf).to(torch.int32)
    vox = vox - vox.amin(dim=0)
    vmax = vox.amax(dim=0)
    key = vox[:, 0]
    for a in range(1, d):
        key = key * (vmax[a] + 1) + vox[:, a]

    skey, order = torch.sort(key, stable=True)
    spts = pts.index_select(0, order)
    sbase = torch.floor(spts / leaf) * leaf
    # Scanned along the inner axis of a (D, N) copy: a scan down the outer
    # axis of (N, D) runs one sequential thread per column on the card.
    csum = torch.cumsum((spts - sbase).T.contiguous(), dim=1).T
    idx1 = torch.arange(1, n + 1, dtype=torch.int32, device=pts.device)
    # Neighbours by rolling, not by slices of n - 1 rows: a symbolic trace
    # would then need n >= 3.
    last, first = idx1 == n, idx1 == 1
    is_end = (skey != skey.roll(-1)) | last
    m = is_end.sum()

    _, order2 = torch.sort((~is_end).to(torch.int32), stable=True)
    cend = csum.index_select(0, order2)
    cnt_end = idx1.index_select(0, order2)
    base = sbase.index_select(0, order2)

    prev = torch.where(first[:, None], 0.0, cend.roll(1, 0))
    prev_cnt = torch.where(first, 0, cnt_end.roll(1))
    counts = cnt_end - prev_cnt
    mask = torch.arange(n, device=pts.device) < m
    means = base + (cend - prev) / counts.clamp(min=1).to(torch.float32)[:, None]
    return means * mask[:, None], mask
