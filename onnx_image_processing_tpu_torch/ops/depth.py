"""Depth-image ops: unprojection, normals, rigid transform, projection and
depth -> RGB alignment (port of ``onnx_image_processing_tpu/ops/depth.py``).

Divisions by an intrinsic divide by a 0-dim tensor on the data's device:
PyTorch's CUDA division by a Python number multiplies by its reciprocal,
one ulp off the true quotient. The alignment's splat is one deterministic
``scatter_reduce_(..., "amin")`` over the four neighbours (a min does not
depend on the order of the updates).
"""

from __future__ import annotations

import torch

from ..core import full_fp32
from .filters import conv1d_h, conv1d_w, pad2d

_S121 = (1.0, 2.0, 1.0)
_D10m1 = (1.0, 0.0, -1.0)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _ray_grid(height: int, width: int, cx: float, cy: float, fx: float, fy: float,
              scale: float, device) -> torch.Tensor:
    """(H, W, 3) rays [(u - cx) / fx, (v - cy) / fy, 1] * scale."""
    u = torch.arange(width, dtype=torch.float32, device=device) - cx
    v = torch.arange(height, dtype=torch.float32, device=device) - cy
    u, v = u / _scalar(fx, u), v / _scalar(fy, v)
    uu = u[None, :].expand(height, width)
    vv = v[:, None].expand(height, width)
    return torch.stack([uu, vv, torch.ones_like(uu)], dim=-1) * scale


def depth_to_pointcloud(depth: torch.Tensor, cx: float, cy: float, fx: float, fy: float,
                        scale: float = 1.0) -> torch.Tensor:
    """Unproject an (H, W) or (H, W, 1) depth image to an (H, W, 3)
    camera-frame point cloud."""
    if depth.ndim == 2:
        depth = depth[..., None]
    h, w = depth.shape[:2]
    return depth.to(torch.float32) * _ray_grid(h, w, cx, cy, fx, fy, scale, depth.device)


def depth_to_pointcloud_with_normal(depth: torch.Tensor, cx: float, cy: float, fx: float,
                                    fy: float, scale: float = 1.0):
    """Point cloud and per-pixel normals: the x / y derivatives (zero
    padding, unnormalized [1, 0, -1] x [1, 2, 1] taps) summed over the xyz
    channels, then [dx, dy, -1] normalized.

    Returns:
        (pcd (H, W, 3), normals (H, W, 3)).
    """
    pcd = depth_to_pointcloud(depth, cx, cy, fx, fy, scale)
    xp = pad2d(pcd.movedim(-1, 0), 1, 1, mode="zero")
    dx = conv1d_w(conv1d_h(xp, _S121), _D10m1).sum(dim=0)
    dy = conv1d_w(conv1d_h(xp, _D10m1), _S121).sum(dim=0)
    vec = torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)
    norm = torch.sqrt((vec ** 2).sum(dim=-1, keepdim=True))
    return pcd, vec / norm


def transform_points(points: torch.Tensor, rotation: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """Rigid transform ``p @ R + t`` of (..., 3) points, in full float32."""
    with full_fp32():
        return (points @ rotation.to(torch.float32)
                + translation.to(torch.float32).reshape(3))


def points_to_pixels(points: torch.Tensor, cx: float, cy: float, fx: float, fy: float):
    """Pixel coordinates (px, py) of (..., 3) camera-frame points; points
    at zero depth map to (0, 0)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    at_zero = z == 0.0
    px = torch.where(at_zero, 0.0, x / z * fx + cx)
    py = torch.where(at_zero, 0.0, y / z * fy + cy)
    return px, py


def depth_alignment(depth_image: torch.Tensor, rotation: torch.Tensor,
                    translation: torch.Tensor, width: int, height: int,
                    depth_cx: float, depth_cy: float, depth_fx: float, depth_fy: float,
                    rgb_cx: float, rgb_cy: float, rgb_fx: float, rgb_fy: float,
                    scale: float = 1.0) -> torch.Tensor:
    """Align an (H, W) depth image to the RGB camera: unproject, transform
    (``p @ R + t``), reproject, then splat each depth to its four
    neighbouring pixels keeping the nearest. Returns (height, width), 0
    where nothing lands.

    A projection in [width - 0.5, width) has its right neighbour at x =
    width (likewise for y): such updates go to a spare slot past the image
    and are dropped, as the JAX package's ``mode="drop"`` drops them,
    instead of landing on the next row's first pixel.
    """
    pts = depth_to_pointcloud(depth_image, depth_cx, depth_cy, depth_fx, depth_fy, scale)
    pts = transform_points(pts.reshape(-1, 3), rotation, translation)
    px, py = points_to_pixels(pts, rgb_cx, rgb_cy, rgb_fx, rgb_fy)

    oob = (px < 0) | (px >= width) | (py < 0) | (py >= height)
    px = torch.where(oob, 0.0, px)
    py = torch.where(oob, 0.0, py)
    # Truncation toward zero; the coordinates are >= 0 here.
    x0 = torch.trunc(px - 0.5).to(torch.int64)
    x1 = torch.trunc(px + 0.5).to(torch.int64)
    y0 = torch.trunc(py - 0.5).to(torch.int64)
    y1 = torch.trunc(py + 0.5).to(torch.int64)

    fill = 10000.0
    ys = torch.cat([y0, y0, y1, y1])
    xs = torch.cat([x0, x1, x0, x1])
    spare = height * width
    flat = torch.where((xs < width) & (ys < height), ys * width + xs, spare)
    vals = depth_image.reshape(-1).to(torch.float32).repeat(4)
    aligned = torch.full((spare + 1,), fill, dtype=torch.float32, device=depth_image.device)
    aligned.scatter_reduce_(0, flat, vals, reduce="amin")
    aligned = aligned[:spare].reshape(height, width)
    return torch.where(aligned == fill, 0.0, aligned)
