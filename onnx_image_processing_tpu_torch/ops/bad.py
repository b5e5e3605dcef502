"""BAD (Box Average Difference) descriptors, sparse and dense (port of
``onnx_image_processing_tpu/ops/bad.py``).

The learned box-pair constants are data: ``load_bad_params`` reads the
port's own ``data/bad_params_{256,512}.npz`` (byte copies of the JAX
package's) with numpy, and :class:`BADTable`
holds what the descriptor path needs as module buffers, so ``.to(device)``
moves the table with the model.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..kernels import sparse_sampler, use_kernel
from .filters import box_average_bank, edge_extend, pad2d
from .sampling import sample_bank_fused, sample_bilinear, sample_nearest

_DATA_DIR = Path(__file__).resolve().parents[1] / "data"

# Patch geometry of the sampler window, kept exactly as the JAX package's:
# learned offsets lie in [-16, 15], so any rotation keeps |offset| < 23; row
# origins are floored to multiples of 8, adding up to 7 px of slack; hence a
# 56 x 56 window. Both packages then see the same windows.
_PATCH_HALF = 23
_PATCH = 56
# The tiled dense route streams row chunks of the pixel grid through the
# sampler, each chunk's ly, lx and output at most this many bytes.
_TILED_CHUNK_BYTES = 256 << 20


@dataclass(frozen=True)
class BADParams:
    """Learned BAD constants as host numpy; offsets are rectified around the
    32x32 learned patch centre (raw minus 16)."""

    offset_x1: np.ndarray  # (P,) f32
    offset_x2: np.ndarray
    offset_y1: np.ndarray
    offset_y2: np.ndarray
    radii: np.ndarray      # (P,) int32
    thresholds: np.ndarray  # (P,) f32
    num_pairs: int
    max_radius: int


def load_bad_params(num_pairs: int = 256) -> BADParams:
    """Read the learned table for 256 or 512 pairs from the shipped npz."""
    if num_pairs not in (256, 512):
        raise ValueError(
            f"num_pairs must be 256 or 512 to use learned BAD patterns, got {num_pairs}")
    with np.load(_DATA_DIR / f"bad_params_{num_pairs}.npz") as z:
        box_params = z["box_params"].astype(np.float32)
        thresholds = z["thresholds"].astype(np.float32)
    radii = box_params[:, 4].astype(np.int32)
    return BADParams(
        offset_x1=box_params[:, 0] - 16.0,
        offset_x2=box_params[:, 1] - 16.0,
        offset_y1=box_params[:, 2] - 16.0,
        offset_y2=box_params[:, 3] - 16.0,
        radii=radii,
        thresholds=thresholds,
        num_pairs=num_pairs,
        max_radius=int(radii.max()),
    )


@dataclass(frozen=True)
class SampleLayout:
    """Unique-box sample axis of a pair table: each distinct (offset, radius)
    box once, radius-major, so each radius group is one contiguous slice;
    ``idx1``/``idx2`` map the learned pair order onto it."""

    groups: tuple      # ((radius, lo, hi), ...) contiguous on the S axis
    idx1: np.ndarray   # (P,) int32
    idx2: np.ndarray
    off_y: np.ndarray  # (S,) f32
    off_x: np.ndarray


def sample_layout(params: BADParams) -> SampleLayout:
    """Port of ``_build_sample_layout``: 805 unique boxes at P=512."""
    p = params.num_pairs
    radii_np = np.asarray(params.radii)
    order = np.argsort(radii_np, kind="stable")
    inv_order_np = np.argsort(order)
    radii_sorted = radii_np[order]

    group_bounds = []
    idx1_sorted = np.empty(p, np.int64)
    idx2_sorted = np.empty(p, np.int64)
    off_y_list, off_x_list = [], []
    base = 0
    lo = 0
    for r in sorted(set(int(v) for v in np.unique(radii_sorted))):
        hi = lo + int((radii_sorted == r).sum())
        n_g = hi - lo
        pts = np.stack([
            np.concatenate([params.offset_y1[order][lo:hi],
                            params.offset_y2[order][lo:hi]]),
            np.concatenate([params.offset_x1[order][lo:hi],
                            params.offset_x2[order][lo:hi]]),
        ], axis=1)
        uniq, inv = np.unique(pts, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        idx1_sorted[lo:hi] = base + inv[:n_g]
        idx2_sorted[lo:hi] = base + inv[n_g:]
        off_y_list.append(uniq[:, 0])
        off_x_list.append(uniq[:, 1])
        group_bounds.append((r, base, base + len(uniq)))
        base += len(uniq)
        lo = hi
    return SampleLayout(
        groups=tuple(group_bounds),
        idx1=idx1_sorted[inv_order_np].astype(np.int32),
        idx2=idx2_sorted[inv_order_np].astype(np.int32),
        off_y=np.concatenate(off_y_list).astype(np.float32),
        off_x=np.concatenate(off_x_list).astype(np.float32))


class BADTable(nn.Module):
    """A pair table as buffers: unique-box offsets ``off_y``/``off_x`` (S,),
    per-sample box radius ``sample_radius`` (S,), the pair maps
    ``idx1``/``idx2`` (P,) and ``thresholds`` (P,). ``groups``,
    ``num_pairs`` and ``max_radius`` are plain attributes."""

    def __init__(self, params: BADParams):
        super().__init__()
        layout = sample_layout(params)
        self.num_pairs = params.num_pairs
        self.max_radius = params.max_radius
        self.groups = layout.groups
        radius = np.empty(len(layout.off_y), np.int32)
        for (r, lo, hi) in layout.groups:
            radius[lo:hi] = r
        self.register_buffer("off_y", torch.from_numpy(layout.off_y.copy()))
        self.register_buffer("off_x", torch.from_numpy(layout.off_x.copy()))
        self.register_buffer("sample_radius", torch.from_numpy(radius))
        self.register_buffer("idx1", torch.from_numpy(layout.idx1.astype(np.int64)))
        self.register_buffer("idx2", torch.from_numpy(layout.idx2.astype(np.int64)))
        self.register_buffer("thresholds", torch.from_numpy(
            np.asarray(params.thresholds, np.float32).copy()))


def params_from_jax(bad_params) -> BADTable:
    """The port's buffers from the JAX package's ``BADParams`` (any object
    with its fields as numpy arrays), so both packages compute with one table."""
    return BADTable(BADParams(
        offset_x1=np.asarray(bad_params.offset_x1, np.float32),
        offset_x2=np.asarray(bad_params.offset_x2, np.float32),
        offset_y1=np.asarray(bad_params.offset_y1, np.float32),
        offset_y2=np.asarray(bad_params.offset_y2, np.float32),
        radii=np.asarray(bad_params.radii, np.int32),
        thresholds=np.asarray(bad_params.thresholds, np.float32),
        num_pairs=int(bad_params.num_pairs),
        max_radius=int(bad_params.max_radius)))


def _finalize(centered: torch.Tensor, binarize: bool, soft_binarize: bool,
              temperature: float) -> torch.Tensor:
    """Binarization options; a BAD bit is 1 when response <= threshold."""
    if not binarize:
        return centered
    if soft_binarize:
        return torch.sigmoid(-centered * temperature)
    return (centered <= 0).to(centered.dtype)


def box_sample_inputs(image: torch.Tensor, keypoints: torch.Tensor,
                      table: BADTable,
                      orientation_mm: tuple[torch.Tensor, torch.Tensor] | None = None,
                      orientation: torch.Tensor | None = None,
                      angles: torch.Tensor | None = None):
    """The sampler's inputs for ``keypoints`` on ``image``.

    Sample positions are the table's unique-box offsets, rotated by the
    keypoint's angle when one of ``orientation_mm``, ``orientation`` or
    ``angles`` is given (see :func:`sparse_bad`), clamped to the image; each
    keypoint's window origin is floored to 8 in y and clamped to the image,
    as in the JAX package.

    Returns:
        ``(image_padded (B, H+2r, W+2r), start_y (B, K) int32,
        start_x (B, K) int32, ly (B, K, S), lx (B, K, S))``.
    """
    x = image.to(torch.float32)[:, 0]
    b, h, w = x.shape
    ps = _PATCH
    ky = keypoints[:, :, 0].clamp(0.0, h - 1)
    kx = keypoints[:, :, 1].clamp(0.0, w - 1)
    off_y = table.off_y[None, None, :]   # (1, 1, S)
    off_x = table.off_x[None, None, :]

    if sum(o is not None for o in (orientation, orientation_mm, angles)) > 1:
        raise ValueError("pass at most one of orientation, orientation_mm, angles")
    if angles is not None:
        theta = angles.to(torch.float32)  # (B, K)
    elif orientation_mm is not None:
        m10_s = sample_nearest(orientation_mm[0].to(torch.float32)[:, 0], ky, kx)
        m01_s = sample_nearest(orientation_mm[1].to(torch.float32)[:, 0], ky, kx)
        theta = torch.atan2(m01_s, m10_s)  # (B, K)
    elif orientation is not None:
        theta = sample_nearest(orientation.to(torch.float32)[:, 0], ky, kx)
    else:
        theta = None
    if theta is not None:
        cos_t = torch.cos(theta)[..., None]
        sin_t = torch.sin(theta)[..., None]
        dy = off_x * sin_t + off_y * cos_t
        dx = off_x * cos_t - off_y * sin_t
    else:
        dy, dx = off_y, off_x

    pos_y = (ky[..., None] + dy).clamp(0.0, h - 1)
    pos_x = (kx[..., None] + dx).clamp(0.0, w - 1)

    # Images smaller than the window are edge-extended to ps x ps; sample
    # positions stay clamped to the real image.
    if h < ps or w < ps:
        x = edge_extend(x, 0, max(h, ps) - h, 0, max(w, ps) - w)
        h, w = x.shape[-2:]
    start_y = (torch.div(torch.round(ky).to(torch.int32) - _PATCH_HALF, 8,
                         rounding_mode="floor") * 8).clamp(0, (h - ps) // 8 * 8)
    start_x = (torch.round(kx).to(torch.int32) - _PATCH_HALF).clamp(0, w - ps)
    xp = pad2d(x, table.max_radius, table.max_radius, mode="edge")
    ly = (pos_y - start_y[..., None].to(torch.float32)).clamp(0.0, ps - 1.0)
    lx = (pos_x - start_x[..., None].to(torch.float32)).clamp(0.0, ps - 1.0)
    return (xp.contiguous(), start_y.contiguous(), start_x.contiguous(),
            ly.contiguous(), lx.contiguous())


def sparse_bad(
    image: torch.Tensor,
    keypoints: torch.Tensor,
    table: BADTable,
    orientation_mm: tuple[torch.Tensor, torch.Tensor] | None = None,
    binarize: bool = False,
    soft_binarize: bool = True,
    temperature: float = 10.0,
    normalize_descriptors: bool = True,
    sampling_mode: str = "nearest",
    orientation: torch.Tensor | None = None,
    angles: torch.Tensor | None = None,
) -> torch.Tensor:
    """BAD descriptors at keypoint locations.

    Args:
        image: (B, 1, H, W) grayscale image.
        keypoints: (B, K, 2) float (y, x); invalid slots are (-1, -1) and
            get zero descriptors.
        table: the pair table (:class:`BADTable`), on the image's device.
        orientation_mm: optional (m10, m01) moment maps, each (B, 1, H, W),
            from :func:`..ops.orientation.angle_moments`; sampled (nearest)
            at the keypoints, atan2 per keypoint rotates the pair offsets.
        sampling_mode: 'nearest' or 'bilinear' box-mean sampling.
        orientation: optional (B, 1, H, W) orientation map in radians (the
            AKAZE frontend's), sampled (nearest) at the keypoints.
        angles: optional (B, K) per-keypoint angles in radians, already
            selected by the caller. At most one of ``orientation_mm``,
            ``orientation`` and ``angles`` may be given.

    Returns:
        (B, K, P) descriptors, optionally L2-normalized.
    """
    if sampling_mode not in ("nearest", "bilinear"):
        raise ValueError(f"sampling_mode must be 'nearest' or 'bilinear', got {sampling_mode}")
    xp, start_y, start_x, ly, lx = box_sample_inputs(
        image, keypoints, table, orientation_mm, orientation, angles)
    samples = sparse_sampler.box_sample(
        xp, start_y, start_x, ly, lx, table.sample_radius, table.groups,
        _PATCH, table.max_radius, bilinear=sampling_mode == "bilinear")

    s1 = samples[..., table.idx1]  # (B, K, P), learned pair order
    s2 = samples[..., table.idx2]
    centered = (s1 - s2) - table.thresholds[None, None, :]
    desc = _finalize(centered, binarize, soft_binarize, temperature)
    valid = (keypoints[:, :, 0] >= 0).to(torch.float32)
    desc = desc * valid[..., None]
    if normalize_descriptors:
        # F.normalize: v / max(||v||_2, 1e-12)
        norm = torch.sqrt((desc * desc).sum(dim=-1, keepdim=True))
        desc = desc / norm.clamp_min(1e-12)
    return desc


def _pair_boxes(table: BADTable):
    """Per-pair box geometry from the table's buffers, on its device: radius
    (P,) and the (y, x) offsets of box 1 and box 2, each (P,) float32."""
    return (table.sample_radius[table.idx1], table.off_y[table.idx1],
            table.off_x[table.idx1], table.off_y[table.idx2], table.off_x[table.idx2])


def dense_bad(
    image: torch.Tensor,
    table: BADTable,
    orientation: torch.Tensor | None = None,
    binarize: bool = False,
    soft_binarize: bool = True,
    temperature: float = 10.0,
    oriented_route: str = "auto",
) -> torch.Tensor:
    """Dense BAD descriptor map, (B, P, H, W).

    Args:
        image: (B, 1, H, W) grayscale image.
        table: the pair table (:class:`BADTable`), on the image's device.
        orientation: optional (B, 1, H, W) per-pixel orientation in radians;
            when given, the pair offsets are rotated per pixel. Without it
            each pair's box mean is a clamped integer shift of one channel
            of the box-average bank, gathered for all 2P boxes at once.
        oriented_route: how the oriented map is evaluated. 'gather' samples
            the bank bilinearly at all H*W*2P rotated positions (the exact
            oracle; several (B, P, H, W) index tensors). 'tiled' treats every
            pixel as a keypoint and streams row chunks of the grid through
            :func:`sparse_bad` in bilinear mode, i.e. through the sampler
            kernel on a CUDA tensor (within ~2e-3 of 'gather'). 'auto' picks
            'tiled' for a CUDA tensor and 'gather' for a CPU tensor.
    """
    if oriented_route not in ("auto", "gather", "tiled"):
        raise ValueError(f"oriented_route must be auto|gather|tiled, got {oriented_route}")
    if orientation is not None and (oriented_route == "tiled" or (
            oriented_route == "auto" and use_kernel(image))):
        return _dense_oriented_tiled(image, table, orientation, binarize,
                                     soft_binarize, temperature)
    x = image.to(torch.float32)[:, 0]
    b, h, w = x.shape
    p = table.num_pairs
    dev = x.device
    bank = box_average_bank(x, table.max_radius)            # (B, R+1, H, W)
    radius, oy1, ox1, oy2, ox2 = _pair_boxes(table)
    if orientation is None:
        # Learned offsets are integers: box j of pair p is bank channel r_p
        # at rows clamp(i + dy_j), columns clamp(k + dx_j); one gather takes
        # all 2P shifted boxes.
        ch = torch.cat([radius, radius]).long()
        dy = torch.cat([oy1, oy2]).long()
        dx = torch.cat([ox1, ox2]).long()
        rows = (torch.arange(h, device=dev) + dy[:, None]).clamp(0, h - 1)
        cols = (torch.arange(w, device=dev) + dx[:, None]).clamp(0, w - 1)
        boxes = bank[:, ch[:, None, None], rows[:, :, None], cols[:, None, :]]
        diff = boxes[:, :p] - boxes[:, p:]                  # (B, P, H, W)
    else:
        theta = orientation.to(torch.float32)[:, 0]
        cos_t = torch.cos(theta)[:, None]                   # (B, 1, H, W)
        sin_t = torch.sin(theta)[:, None]
        base_y = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
        base_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
        chan = radius[None, :, None, None]

        def rot_sample(ox, oy):
            ox, oy = ox[None, :, None, None], oy[None, :, None, None]
            py = (base_y + (ox * sin_t + oy * cos_t)).expand(b, p, h, w)
            px = (base_x + (ox * cos_t - oy * sin_t)).expand(b, p, h, w)
            return sample_bank_fused(bank, chan, py, px, mode="bilinear")

        diff = rot_sample(ox1, oy1) - rot_sample(ox2, oy2)
    centered = diff - table.thresholds[None, :, None, None]
    return _finalize(centered, binarize, soft_binarize, temperature)


def _dense_oriented_tiled(image: torch.Tensor, table: BADTable,
                          orientation: torch.Tensor, binarize: bool,
                          soft_binarize: bool, temperature: float) -> torch.Tensor:
    """The oriented dense map with every pixel as a keypoint, in row chunks
    (at most ``_TILED_CHUNK_BYTES`` of ly, lx and output each), each chunk
    one :func:`sparse_bad` call in bilinear mode; finalized once."""
    b, _, h, w = image.shape
    p, s = table.num_pairs, table.off_y.shape[0]
    rows = max(1, _TILED_CHUNK_BYTES // (3 * 4 * b * s * w))
    dev = image.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    centered = torch.empty((b, p, h * w), dtype=torch.float32, device=dev)
    for y0 in range(0, h, rows):
        ys = torch.arange(y0, min(y0 + rows, h), dtype=torch.float32, device=dev)
        grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1).reshape(1, -1, 2)
        # binarize=False: the raw centered values (s1 - s2 - threshold).
        chunk = sparse_bad(image, grid.expand(b, -1, -1), table, orientation=orientation,
                           binarize=False, normalize_descriptors=False,
                           sampling_mode="bilinear")
        centered[:, :, y0 * w:y0 * w + grid.shape[1]] = chunk.transpose(1, 2)
    out = _finalize(centered, binarize, soft_binarize, temperature)
    return out.reshape(b, p, h, w)


def extract_descriptors_at_keypoints(descriptor_map: torch.Tensor,
                                     keypoints: torch.Tensor) -> torch.Tensor:
    """Dense descriptors (B, D, H, W) gathered at integer (y, x) keypoints
    (B, K, 2) -> (B, K, D)."""
    b, d, h, w = descriptor_map.shape
    idx = keypoints[:, :, 0].long() * w + keypoints[:, :, 1].long()   # (B, K)
    flat = descriptor_map.reshape(b, d, h * w)
    out = torch.gather(flat, 2, idx[:, None, :].expand(b, d, idx.shape[-1]))
    return out.transpose(1, 2)


def extract_descriptors_at_keypoints_subpixel(descriptor_map: torch.Tensor,
                                              keypoints: torch.Tensor) -> torch.Tensor:
    """Bilinear sub-pixel descriptor extraction (grid_sample bilinear, border
    padding, align_corners=True) -> (B, K, D)."""
    b, d, h, w = descriptor_map.shape
    k = keypoints.shape[1]
    y = keypoints[:, None, :, 0].expand(b, d, k).reshape(b * d, k)
    x = keypoints[:, None, :, 1].expand(b, d, k).reshape(b * d, k)
    vals = sample_bilinear(descriptor_map.reshape(b * d, h, w), y, x)
    return vals.reshape(b, d, k).transpose(1, 2)
