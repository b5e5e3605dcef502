"""Pipeline registry of the port: name -> module on a device.

The flagship matcher and the AKAZE family, with the JAX registry's
defaults: the reference's export defaults (flagship: 512 hard-binarized
pairs, eps 0.05, nms radius 5, Shi-Tomasi block 5; AKAZE matcher: 512
unbinarized pairs, 1024 keypoints, eps 0.05, nms radius 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..core import MatcherConfig
from .akaze_family import AKAZEDetector, AKAZESparseBADSinkhorn
from .extraction import with_match_extraction
from .shi_tomasi_family import ShiTomasiAngleSparseBADSinkhorn


@dataclass(frozen=True)
class PipelineSpec:
    name: str
    factory: Callable[[MatcherConfig], nn.Module]
    defaults: MatcherConfig
    description: str = ""


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
    in, as in the JAX registry. Call it with (B, 1, H, W) float32 images on
    the same device.
    """
    spec = get(name)
    base = cfg or spec.defaults
    resolved = base.with_(**overrides) if overrides else base
    return spec.factory(resolved).to(torch.device(device)).eval()


register(PipelineSpec(
    "shi_tomasi_angle_sparse_bad_sinkhorn", ShiTomasiAngleSparseBADSinkhorn,
    _CI.with_(block_size=5), "rotation-invariant sparse matcher (flagship)"))
register(PipelineSpec(
    "shi_tomasi_angle_sparse_bad_sinkhorn_extraction",
    lambda cfg: with_match_extraction(ShiTomasiAngleSparseBADSinkhorn(cfg)),
    _CI.with_(block_size=5),
    "rotation-invariant sparse matcher (flagship) + mutual-NN match extraction"))

register(PipelineSpec("akaze", AKAZEDetector, _BASE,
                      "AKAZE scores + orientation maps"))
register(PipelineSpec(
    "akaze_sparse_bad_sinkhorn", AKAZESparseBADSinkhorn, _AKAZE,
    "AKAZE rotation-invariant sparse matcher"))
register(PipelineSpec(
    "akaze_sparse_bad_sinkhorn_extraction",
    lambda cfg: with_match_extraction(AKAZESparseBADSinkhorn(cfg)), _AKAZE,
    "AKAZE rotation-invariant sparse matcher + mutual-NN match extraction"))
