"""Pipeline registry of the port: name -> module on a device.

The ported matchers (flagship, its with-filters variant, the unoriented and
the dense-descriptor matchers, AKAZE, the two essential-matrix pipelines),
their ``_extraction`` wrappers, the single-image heads (``shi_tomasi``,
``shi_tomasi_angle``, ``shi_tomasi_bad``, ``shi_tomasi_angle_sparse_bad``,
``bad``, ``akaze``) and the standalone ``sinkhorn`` and
``essential_matrix_estimator``, each with the JAX registry's defaults: the
reference's export defaults (flagship: 512 hard-binarized pairs, eps 0.05,
nms radius 5, Shi-Tomasi block 5; AKAZE matcher: 512 unbinarized pairs,
1024 keypoints, eps 0.05, nms radius 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..core import MatcherConfig
from ..geometry import estimate_essential_matrix
from ..ops import BADTable, dense_bad, load_bad_params, shi_tomasi_score
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


def build(name: str, cfg: MatcherConfig | None = None, *,
          device: str | torch.device, **overrides) -> nn.Module:
    """The pipeline ``name`` as an eval-mode module on ``device``.

    ``cfg`` (else the registered defaults) with flat ``overrides`` folded
    in, as in the JAX registry. Call it with inputs on the same device:
    (B, 1, H, W) float32 images, and a (3, 3) ``k_inv`` where the spec
    ``takes_k_inv``.
    """
    spec = get(name)
    base = cfg or spec.defaults
    resolved = base.with_(**overrides) if overrides else base
    return spec.factory(resolved).to(torch.device(device)).eval()


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


def _grid_essential(p, k_inv, cfg: MatcherConfig):
    """The standalone estimator on a sqrt(K) x sqrt(K) pixel grid."""
    side = max(2, math.isqrt(cfg.max_keypoints))
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
    _BASE, "Shi-Tomasi corner score map"))
register(PipelineSpec(
    "shi_tomasi_angle", lambda cfg: Standalone(cfg, shi_tomasi_with_angle),
    _BASE.with_(block_size=5), "Shi-Tomasi scores + orientation map"))
register(PipelineSpec(
    "shi_tomasi_bad", lambda cfg: TableHead(cfg, shi_tomasi_bad_detect), _BASE,
    "Shi-Tomasi scores + dense BAD descriptor map"))
register(PipelineSpec(
    "shi_tomasi_angle_sparse_bad",
    lambda cfg: TableHead(cfg, shi_tomasi_angle_sparse_bad_detect),
    _BASE.with_(block_size=5), "single-image keypoints + oriented descriptors"))
register(PipelineSpec(
    "bad", lambda cfg: TableHead(cfg, _dense_map), _BASE,
    "dense BAD descriptor map (binarize / soft_binarize select none, soft or hard)"))
register(PipelineSpec("akaze", lambda cfg: Standalone(cfg, akaze_detect_cfg), _BASE,
                      "AKAZE scores + orientation maps"))
register(PipelineSpec(
    "sinkhorn", lambda cfg: Standalone(cfg, sinkhorn_cfg), _BASE,
    "standalone Sinkhorn matcher on (B, K, D) descriptor tensors"))
register(PipelineSpec(
    "essential_matrix_estimator", lambda cfg: Standalone(cfg, _grid_essential),
    _BASE,
    "standalone grid-variant weighted-8-point E estimator on a Sinkhorn "
    "matrix and k_inv (feature index i maps to a sqrt(K) x sqrt(K) pixel grid)"))
