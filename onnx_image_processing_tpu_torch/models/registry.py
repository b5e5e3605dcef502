"""Pipeline registry of the port: name -> module on a device.

The JAX registry's 24 names: the matchers (flagship, its with-filters
variant, the unoriented and the dense-descriptor matchers, AKAZE, the two
essential-matrix pipelines), their ``_extraction`` wrappers, the
single-image heads (``shi_tomasi``, ``shi_tomasi_angle``,
``shi_tomasi_bad``, ``shi_tomasi_angle_sparse_bad``, ``bad``, ``akaze``,
``fast``, ``dog``, ``dog_with_score``) and the standalone ``sinkhorn``,
``essential_matrix_estimator`` and ``voxel_downsampling``, each with the
JAX registry's defaults: the reference's export defaults (flagship: 512
hard-binarized pairs, eps 0.05, nms radius 5, Shi-Tomasi block 5; AKAZE
matcher: 512 unbinarized pairs, 1024 keypoints, eps 0.05, nms radius 3).
:func:`build_batched` serves B pairs of a two-image matcher in one call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..core import MatcherConfig
from ..geometry import estimate_essential_matrix
from ..ops import (BADTable, dense_bad, dog_responses, dog_score, fast_score,
                   load_bad_params, shi_tomasi_score, voxel_downsampling)
from .akaze_family import AKAZESparseBADSinkhorn, akaze_detect_cfg
from .essential_family import (AKAZESparseBADSinkhornEssential,
                               ShiTomasiAngleSparseBADSinkhornEssential)
from .extraction import with_match_extraction
from .shi_tomasi_family import (ShiTomasiAngleSparseBADSinkhorn,
                                ShiTomasiAngleSparseBADSinkhornWithFilters,
                                ShiTomasiBADSinkhorn, ShiTomasiSparseBADSinkhorn,
                                _check_devices, shi_tomasi_angle_sparse_bad_detect,
                                shi_tomasi_bad_detect, shi_tomasi_with_angle,
                                sinkhorn_cfg)


@dataclass(frozen=True)
class PipelineSpec:
    name: str
    factory: Callable[[MatcherConfig], nn.Module]
    defaults: MatcherConfig
    description: str = ""
    takes_k_inv: bool = False  # essential-matrix pipelines take a (3, 3) K^-1
    n_images: int = 2          # image inputs; 0 for tensor-input pipelines
    # Single-image heads that select keypoints by NMS and top-k: their
    # symbolic shapes carry the block-grid constraint of the matchers.
    selects_keypoints: bool = False
    # Inputs of a tensor-input pipeline: (cfg, height, width, batch, rng) ->
    # numpy arrays (images are (batch, 1, height, width) otherwise).
    make_args: Callable | None = None
    # Why a call cannot be captured in a CUDA graph (it reads a value on the
    # host), for cli.common.benchmark_chain; None where it can be.
    capture_blocker: str | None = None


_REGISTRY: dict[str, PipelineSpec] = {}

_BASE = MatcherConfig()
_CI = MatcherConfig(num_pairs=512, max_keypoints=1024, binarize=True,
                    soft_binarize=False, epsilon=0.05, nms_radius=5)
_AKAZE = MatcherConfig(num_pairs=512, max_keypoints=1024, epsilon=0.05,
                       nms_radius=3)


def register(spec: PipelineSpec) -> None:
    _REGISTRY[spec.name] = spec


def names() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str) -> PipelineSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown pipeline {name!r}; available: {names()}")
    return _REGISTRY[name]


def resolve_config(spec: PipelineSpec, cfg: MatcherConfig | None = None,
                   **overrides) -> MatcherConfig:
    """The one config rule: ``cfg`` (else the spec's defaults) with flat
    ``overrides`` folded in. Shared by build, export and verification, so a
    traced module and its example inputs never disagree."""
    return (cfg or spec.defaults).with_(**overrides) if overrides else (cfg or spec.defaults)


def build(name: str, cfg: MatcherConfig | None = None, *,
          device: str | torch.device, **overrides) -> nn.Module:
    """The pipeline ``name`` as an eval-mode module on ``device``.

    ``cfg`` (else the registered defaults) with flat ``overrides`` folded
    in, as in the JAX registry. Call it with inputs on the same device:
    (B, 1, H, W) float32 images, and a (3, 3) ``k_inv`` where the spec
    ``takes_k_inv``. What the JAX registry's ``build`` returns, a
    ``jax.jit`` executable, is ``models.jit`` of this module: one CUDA
    graph per input signature on the card (``core/jit.py``). The module
    itself stays eager, for export, the chain protocol and the launch
    counters.
    """
    spec = get(name)
    module = spec.factory(resolve_config(spec, cfg, **overrides)).to(torch.device(device)).eval()
    module.pipeline_name = name
    module.capture_blocker = spec.capture_blocker
    return module


def k_inv_for(height: int, width: int) -> np.ndarray:
    """A plausible inverse intrinsic matrix (focal 500 px, principal point
    at the image centre), float32."""
    k = np.array([[500.0, 0, width / 2], [0, 500.0, height / 2], [0, 0, 1]])
    return np.linalg.inv(k).astype(np.float32)


def arg_specs(spec: PipelineSpec, cfg: MatcherConfig, height: int, width: int,
              batch: int = 1, *, device: str | torch.device, seed: int = 0) -> tuple:
    """Example inputs of a pipeline on ``device``, made from ``seed``: images
    (batch, 1, height, width) uniform in [0, 255], a plausible ``k_inv``,
    or the tensor-input pipeline's own (``make_args``). They serve tracing
    (``torch.export`` takes example tensors where the JAX package takes
    abstract shapes) and verification."""
    rng = np.random.default_rng(seed)
    if spec.make_args is not None:
        arrays = spec.make_args(cfg, height, width, batch, rng)
    else:
        arrays = [rng.uniform(0, 255, (batch, 1, height, width)).astype(np.float32)
                  for _ in range(spec.n_images)]
        if spec.takes_k_inv:
            arrays.append(k_inv_for(height, width))
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device) for a in arrays)


def compile_model(name: str, height: int, width: int, batch: int = 1,
                  cfg: MatcherConfig | None = None, *, device: str | torch.device,
                  **overrides) -> Callable:
    """The pipeline exported at a static shape and called once on
    ``device`` (which builds and loads the kernels there); returns the
    exported program's callable module. The JAX package's compile step has
    an XLA cost analysis; a ``torch.export`` program has none."""
    from .serialize import export_model

    spec = get(name)
    fn = export_model(name, height, width, batch, cfg, device=device, **overrides).module()
    fn(*arg_specs(spec, resolve_config(spec, cfg, **overrides), height, width, batch,
                  device=device))
    return fn


class Batched(nn.Module):
    """A two-image pipeline over B stacked pairs, optionally in sequential
    sub-batches of at most ``chunk`` pairs whose outputs are concatenated.

    ``forward(img1 (B, 1, H, W), img2 (B, 1, H, W))`` gives what the
    pipeline gives on the same stacked batch, (B, ...) leaves.
    """

    def __init__(self, pipeline: nn.Module, chunk: int | None):
        super().__init__()
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.pipeline = pipeline
        self.cfg = pipeline.cfg
        self.chunk = chunk

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        b = img1.shape[0]
        if self.chunk is None or b <= self.chunk:
            return self.pipeline(img1, img2)
        parts = [self.pipeline(img1[i:i + self.chunk], img2[i:i + self.chunk])
                 for i in range(0, b, self.chunk)]
        return tuple(torch.cat(leaves, dim=0) for leaves in zip(*parts))


def build_batched(name: str, cfg: MatcherConfig | None = None, chunk: int | None = None, *,
                  device: str | torch.device, **overrides) -> Batched:
    """``build(name)`` for serving B pairs per call (``parallel.stream_map_chunked``).

    The port's two-image matchers already take B stacked pairs, so this is
    the pipeline itself; with ``chunk``, a batch of more than ``chunk``
    pairs runs as sequential sub-batches. The JAX package's vmap over
    single pairs, and its default chunk of 6, answer layouts of XLA on a
    TPU and are not copied: the default here is None (one call).
    Two-image pipelines and their ``_extraction`` forms only. The served
    form, JAX's jitted ``build_batched``, is ``models.jit`` of this module.
    """
    spec = get(name)
    if spec.takes_k_inv:
        raise ValueError(f"{name!r} takes a k_inv beside its two images; build_batched "
                         "serves pipelines of two (B, 1, H, W) images only")
    if spec.n_images != 2:
        raise ValueError(f"{name!r} takes {spec.n_images} images; build_batched serves "
                         "two-image pipelines only")
    return Batched(build(name, cfg, device=device, **overrides), chunk).eval()


class Standalone(nn.Module):
    """A registry entry without weights: ``forward(*inputs)`` is
    ``fn(*inputs, cfg)``, the inputs on the module's device (the ``akaze``
    head: one (B, 1, H, W) image -> (scores, orientations))."""

    def __init__(self, cfg: MatcherConfig, fn: Callable):
        super().__init__()
        self.cfg = cfg
        self.fn = fn
        # The empty buffer moves with .to() and names the device.
        self.register_buffer("anchor", torch.empty(0), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.anchor.device

    def forward(self, *inputs: torch.Tensor):
        _check_devices(self.device, *inputs)
        return self.fn(*inputs, self.cfg)


class TableHead(Standalone):
    """A single-image head that holds a BAD table as buffers:
    ``forward(image)`` is ``fn(image, cfg, table)``."""

    def __init__(self, cfg: MatcherConfig, fn: Callable):
        super().__init__(cfg, fn)
        self.table = BADTable(load_bad_params(cfg.num_pairs))

    def forward(self, *inputs: torch.Tensor):
        _check_devices(self.device, *inputs)
        return self.fn(*inputs, self.cfg, self.table)


def _dense_map(image, cfg: MatcherConfig, table: BADTable):
    return dense_bad(image, table, binarize=cfg.binarize,
                     soft_binarize=cfg.soft_binarize, temperature=cfg.temperature)


def essential_grid_side(cfg: MatcherConfig) -> int:
    """Side of the standalone estimator's pixel grid: sqrt(K)."""
    return max(2, math.isqrt(cfg.max_keypoints))


def _grid_essential(p, k_inv, cfg: MatcherConfig):
    """The standalone estimator on a sqrt(K) x sqrt(K) pixel grid."""
    side = essential_grid_side(cfg)
    return estimate_essential_matrix(p, k_inv, image_shape=(side, side))


_MATCHERS = [
    ("shi_tomasi_bad_sinkhorn", ShiTomasiBADSinkhorn, _CI.with_(block_size=3),
     "dense-descriptor two-image matcher"),
    ("shi_tomasi_sparse_bad_sinkhorn", ShiTomasiSparseBADSinkhorn,
     _CI.with_(block_size=3), "sparse unoriented matcher"),
    ("shi_tomasi_angle_sparse_bad_sinkhorn", ShiTomasiAngleSparseBADSinkhorn,
     _CI.with_(block_size=5), "rotation-invariant sparse matcher (flagship)"),
    ("shi_tomasi_angle_sparse_bad_sinkhorn_with_filters",
     ShiTomasiAngleSparseBADSinkhornWithFilters,
     _CI.with_(block_size=5, ratio_threshold=2.0, dustbin_margin=0.3),
     "flagship matcher + in-graph outlier filters"),
    ("akaze_sparse_bad_sinkhorn", AKAZESparseBADSinkhorn, _AKAZE,
     "AKAZE rotation-invariant sparse matcher"),
]
for _name, _cls, _defaults, _desc in _MATCHERS:
    register(PipelineSpec(_name, _cls, _defaults, _desc))
    register(PipelineSpec(
        _name + "_extraction",
        lambda cfg, cls=_cls: with_match_extraction(cls(cfg)), _defaults,
        _desc + " + mutual-NN match extraction"))

register(PipelineSpec(
    "shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix",
    ShiTomasiAngleSparseBADSinkhornEssential, _CI.with_(block_size=5),
    "flagship matcher + in-graph essential matrix", takes_k_inv=True))
register(PipelineSpec(
    "akaze_sparse_bad_sinkhorn_essential_matrix",
    AKAZESparseBADSinkhornEssential, _AKAZE,
    "AKAZE matcher + in-graph essential matrix", takes_k_inv=True))

register(PipelineSpec(
    "shi_tomasi",
    lambda cfg: Standalone(cfg, lambda img, c: shi_tomasi_score(img, block_size=c.block_size)),
    _BASE, "Shi-Tomasi corner score map", n_images=1))
register(PipelineSpec(
    "shi_tomasi_angle", lambda cfg: Standalone(cfg, shi_tomasi_with_angle),
    _BASE.with_(block_size=5), "Shi-Tomasi scores + orientation map", n_images=1))
register(PipelineSpec(
    "shi_tomasi_bad", lambda cfg: TableHead(cfg, shi_tomasi_bad_detect), _BASE,
    "Shi-Tomasi scores + dense BAD descriptor map", n_images=1))
register(PipelineSpec(
    "shi_tomasi_angle_sparse_bad",
    lambda cfg: TableHead(cfg, shi_tomasi_angle_sparse_bad_detect),
    _BASE.with_(block_size=5), "single-image keypoints + oriented descriptors", n_images=1,
    selects_keypoints=True))
register(PipelineSpec(
    "bad", lambda cfg: TableHead(cfg, _dense_map), _BASE,
    "dense BAD descriptor map (binarize / soft_binarize select none, soft or hard)", n_images=1))
register(PipelineSpec("akaze", lambda cfg: Standalone(cfg, akaze_detect_cfg), _BASE,
                      "AKAZE scores + orientation maps", n_images=1))
register(PipelineSpec(
    "sinkhorn", lambda cfg: Standalone(cfg, sinkhorn_cfg), _BASE,
    "standalone Sinkhorn matcher on (B, K, D) descriptor tensors", n_images=0,
    make_args=lambda cfg, h, w, b, rng: [
        rng.normal(size=(b, cfg.max_keypoints, cfg.num_pairs)) for _ in range(2)]))
register(PipelineSpec(
    "essential_matrix_estimator", lambda cfg: Standalone(cfg, _grid_essential),
    _BASE,
    "standalone grid-variant weighted-8-point E estimator on a Sinkhorn "
    "matrix and k_inv (feature index i maps to a sqrt(K) x sqrt(K) pixel grid)", n_images=0,
    make_args=lambda cfg, h, w, b, rng: [
        rng.uniform(0, 1, (essential_grid_side(cfg) ** 2 + 1,) * 2), k_inv_for(h, w)]))

# FAST / DoG heads: their hyperparameters come from the config's nested
# FASTConfig / DoGConfig, so overrides like fast_threshold=30 reach the op.
register(PipelineSpec(
    "fast", lambda cfg: Standalone(cfg, lambda img, c: fast_score(
        img, threshold=c.fast.threshold, use_nms=c.fast.use_nms,
        nms_radius=c.fast.nms_radius)),
    _BASE, "FAST-9 binary corner score map", n_images=1))


def _dog_kw(cfg: MatcherConfig) -> dict:
    d = cfg.dog
    return dict(num_scales=d.num_scales, sigma_base=d.sigma_base,
                sigma_ratio=d.sigma_ratio, kernel_size=d.kernel_size)


register(PipelineSpec(
    "dog", lambda cfg: Standalone(cfg, lambda img, c: dog_responses(img, **_dog_kw(c))),
    _BASE, "Difference-of-Gaussians band responses", n_images=1))
register(PipelineSpec(
    "dog_with_score", lambda cfg: Standalone(cfg, lambda img, c: dog_score(img, **_dog_kw(c))),
    _BASE, "DoG max-|response| score map", n_images=1))

# The JAX registry's deployment size of the standalone voxel export (its
# executables are specialized per N), the size of the static export's
# example; the port's module takes any N.
VOXEL_EXPORT_POINTS = 8192

register(PipelineSpec(
    "voxel_downsampling",
    lambda cfg: Standalone(cfg, lambda pts, leaf, c: voxel_downsampling(pts, leaf)),
    _BASE,
    "standalone voxel-grid downsampling: (N, 3) points + a 0-dim leaf size on the "
    "module's device -> (N, 3) centroids + validity mask", n_images=0,
    make_args=lambda cfg, h, w, b, rng: [rng.uniform(0, 2, (VOXEL_EXPORT_POINTS, 3)),
                                         np.float32(0.05)]))
