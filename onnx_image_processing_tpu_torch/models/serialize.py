"""Serialized artifacts of the port's pipelines: ``torch.export`` programs
(port of ``onnx_image_processing_tpu/models/serialize.py``).

The JAX package writes a ``jax.export`` artifact per pipeline; the port
writes a ``torch.export.ExportedProgram`` in a ``.pt2`` file: the pipeline
traced on a device at a static shape (or with symbolic dimensions, below),
with its weights (the BAD tables) and constants. Artifacts are per device,
as the JAX ones are per platform, and are named
``<pipeline>[.poly].<cuda|cpu>.pt2``. A CUDA artifact's graph holds the
port's custom ops (``oip::nms_select_blocks``, ``oip::box_sample``,
``oip::sinkhorn_core``, ``oip::detect_select``, ``oip::akaze_ladder``, ...),
whose CUDA implementations are the hand kernels; a CPU artifact holds the
same nodes, run by their plain versions.

The one difference from a ``.jaxexport``: those ops are implemented in this
package, so loading a ``.pt2`` that holds them needs the port on the import
path. :func:`load_exported` imports the kernel modules first. A program
records no global flag: its matrix products follow the calling process's
TF32 settings, full float32 by PyTorch's default (the eager modules set it
themselves, ``core.full_fp32``).

Shape polymorphism: :data:`POLYMORPHIC_EXPORTS` lists the pipelines that
export with ``torch.export.Dim`` dimensions, one artifact serving every
shape in the stated ranges. ``torch.export`` specializes sizes 0 and 1, so
a symbolic size starts at 2 where the JAX scope starts at 1; the eager
modules serve the smaller sizes.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch
from torch.export import Dim, ExportedProgram, ShapesCollection

from ..core import MatcherConfig
from . import registry

_SUFFIX = ".pt2"


def _export(module: torch.nn.Module, args: tuple, dims: dict | None = None) -> ExportedProgram:
    """``torch.export`` of ``module`` at ``args``; ``dims`` maps an input's
    position to its symbolic dimensions ({axis: Dim})."""
    dynamic = None
    if dims:
        shapes = ShapesCollection()
        for i, spec in dims.items():
            shapes[args[i]] = spec
        dynamic = shapes.dynamic_shapes(module, args)
    return torch.export.export(module, args, dynamic_shapes=dynamic, strict=False)


# ---------------------------------------------------------------------------
# Symbolic ("dynamic axes") exports: the JAX package's symbolic scopes
# (its serialize.py) in torch.export.Dim. Each entry gives example inputs
# (at sizes distinct from each other, so no two symbols merge) and the
# symbolic dimensions of each input.
# ---------------------------------------------------------------------------

def _random(rng, *shape) -> np.ndarray:
    return rng.uniform(0, 255, shape).astype(np.float32)


def _sym_sinkhorn(cfg: MatcherConfig, rng):
    b, n, m, d = Dim("b", min=1), Dim("n", min=2), Dim("m", min=2), Dim("d", min=2)
    args = (rng.normal(size=(2, 24, 3)), rng.normal(size=(2, 20, 3)))
    return args, {0: {0: b, 1: n, 2: d}, 1: {0: b, 1: m, 2: d}}


def _sym_essential(cfg: MatcherConfig, rng):
    # n, m >= 3: the bidirectional top-k needs top_k rows and columns;
    # n, m <= grid cells: every feature index maps onto the pixel grid.
    g = registry.essential_grid_side(cfg) ** 2
    n, m = Dim("n", min=3, max=g), Dim("m", min=3, max=g)
    args = (rng.uniform(0, 1, (min(7, g) + 1, min(5, g) + 1)), registry.k_inv_for(48, 64))
    return args, {0: {0: n + 1, 1: m + 1}}


def _sym_voxel(cfg: MatcherConfig, rng):
    return ((rng.uniform(0, 2, (100, 3)), np.float32(0.05)), {0: {0: Dim("n", min=2)}})


def _sym_image_head(cfg: MatcherConfig, rng):
    """Symbolic (B, 1, H, W) for the dense single-image heads: stencils,
    no top-k."""
    b, h, w = Dim("b", min=1), Dim("h", min=32), Dim("w", min=32)
    return (_random(rng, 2, 1, 40, 56),), {0: {0: b, 2: h, 3: w}}


def _matcher_shape(cfg: MatcherConfig) -> tuple[int, int]:
    """An example (H, W) >= 64 whose NMS block grid holds K blocks."""
    bs = cfg.nms_radius + 1
    side = max(64, bs * (1 + int(np.ceil(np.sqrt(cfg.max_keypoints)))))
    return side, side + 2 * bs


def _sym_matcher(cfg: MatcherConfig, rng):
    """Symbolic (1, 1, H, W) pair for the two-image matchers: K and the
    descriptor stay static, H and W are symbolic. The block grid must hold
    K blocks; the selection states that with ``torch._check``
    (``ops.block_route``), as the JAX scope does with its constraint."""
    h, w = Dim("h", min=64), Dim("w", min=64)
    hh, ww = _matcher_shape(cfg)
    args = (_random(rng, 1, 1, hh, ww), _random(rng, 1, 1, hh, ww))
    return args, {0: {2: h, 3: w}, 1: {2: h, 3: w}}


def _sym_matcher_k_inv(cfg: MatcherConfig, rng):
    args, dims = _sym_matcher(cfg, rng)
    return args + (registry.k_inv_for(*args[0].shape[2:]),), dims


def _sym_sparse_head(cfg: MatcherConfig, rng):
    args, dims = _sym_matcher(cfg, rng)
    return args[:1], {0: dims[0]}


#: pipelines exportable with symbolic dimensions -> example inputs and
#: their symbolic dimensions, as a function of (resolved config, numpy rng).
#: Each states its ranges: a size at the range's lower end (2, where the
#: JAX scope says 1) is served by the eager module, not the artifact.
POLYMORPHIC_EXPORTS: dict[str, Callable] = {
    "sinkhorn": _sym_sinkhorn,
    "essential_matrix_estimator": _sym_essential,
    "voxel_downsampling": _sym_voxel,
    "shi_tomasi": _sym_image_head,
    "fast": _sym_image_head,
    "dog": _sym_image_head,
    "dog_with_score": _sym_image_head,
    "bad": _sym_image_head,
    "shi_tomasi_angle": _sym_image_head,
    "shi_tomasi_bad": _sym_image_head,
    "akaze": _sym_image_head,
    "shi_tomasi_angle_sparse_bad": _sym_sparse_head,
    "shi_tomasi_bad_sinkhorn": _sym_matcher,
    "shi_tomasi_bad_sinkhorn_extraction": _sym_matcher,
    "shi_tomasi_sparse_bad_sinkhorn": _sym_matcher,
    "shi_tomasi_sparse_bad_sinkhorn_extraction": _sym_matcher,
    "shi_tomasi_angle_sparse_bad_sinkhorn": _sym_matcher,
    "shi_tomasi_angle_sparse_bad_sinkhorn_extraction": _sym_matcher,
    "shi_tomasi_angle_sparse_bad_sinkhorn_with_filters": _sym_matcher,
    "shi_tomasi_angle_sparse_bad_sinkhorn_with_filters_extraction": _sym_matcher,
    "shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix": _sym_matcher_k_inv,
    "akaze_sparse_bad_sinkhorn": _sym_matcher,
    "akaze_sparse_bad_sinkhorn_extraction": _sym_matcher,
    "akaze_sparse_bad_sinkhorn_essential_matrix": _sym_matcher_k_inv,
}


def polymorphic_example(name: str, cfg: MatcherConfig | None = None, *,
                        device: str | torch.device, seed: int = 0, **overrides):
    """The example inputs of ``name``'s symbolic export on ``device`` and
    their symbolic dimensions ({input position: {axis: Dim}})."""
    spec = registry.get(name)
    resolved = registry.resolve_config(spec, cfg, **overrides)
    arrays, dims = POLYMORPHIC_EXPORTS[name](resolved, np.random.default_rng(seed))
    args = tuple(torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device) for a in arrays)
    return args, dims


def export_model_polymorphic(name: str, cfg: MatcherConfig | None = None, *,
                             device: str | torch.device, **overrides) -> ExportedProgram:
    """Export a pipeline with symbolic input dimensions (dynamic-axes
    parity): keypoint and match counts stay static, the image's H and W
    (and B, for the dense heads) or the tensor input's sizes are symbolic,
    in the ranges :data:`POLYMORPHIC_EXPORTS` states."""
    if name not in POLYMORPHIC_EXPORTS:
        raise ValueError(f"{name!r} has no shape-polymorphic export; available: "
                         f"{sorted(POLYMORPHIC_EXPORTS)}")
    module = registry.build(name, cfg, device=device, **overrides)
    args, dims = polymorphic_example(name, cfg, device=device, **overrides)
    return _export(module, args, dims)


def export_model(name: str, height: int, width: int, batch: int = 1,
                 cfg: MatcherConfig | None = None, *, device: str | torch.device,
                 **overrides) -> ExportedProgram:
    """``models.build(name, ...)`` traced on ``device`` at a static shape
    (``registry.arg_specs``): an ``ExportedProgram`` whose kernel calls are
    the port's custom ops."""
    spec = registry.get(name)
    module = registry.build(name, cfg, device=device, **overrides)
    args = registry.arg_specs(spec, registry.resolve_config(spec, cfg, **overrides),
                              height, width, batch, device=device)
    return _export(module, args)


def export_streaming(name: str, height: int, width: int, batch: int = 1,
                     cfg: MatcherConfig | None = None, *, device: str | torch.device,
                     **overrides) -> tuple[ExportedProgram, ExportedProgram]:
    """The streaming split (``models/streaming.py``) as two programs:
    ``extract`` takes one (B, 1, H, W) image and gives (keypoints, scores,
    descriptors); ``match`` takes two such feature sets (and ``k_inv`` for
    the essential pipelines) and gives the matcher's outputs. Together they
    are the deployable form of the VO CLI's default serving mode."""
    from .streaming import build_streaming

    spec = registry.get(name.removesuffix("_extraction"))
    extract, match = build_streaming(name, cfg, device=device, **overrides)
    resolved = registry.resolve_config(spec, cfg, **overrides)
    rng = np.random.default_rng(0)
    k, p = resolved.max_keypoints, resolved.num_pairs

    def tensor(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

    def feats():
        return (tensor(rng.uniform(0, min(height, width) - 1, (batch, k, 2))),
                tensor(rng.uniform(0, 1, (batch, k))), tensor(rng.uniform(0, 1, (batch, k, p))))

    extra = (tensor(registry.k_inv_for(height, width)),) if spec.takes_k_inv else ()
    image = tensor(_random(rng, batch, 1, height, width))
    return _export(extract, (image,)), _export(match, (feats(), feats(), *extra))


def artifact_path(out_dir: str, name: str, device: str | torch.device,
                  polymorphic: bool = False) -> str:
    """``<out_dir>/<name>[.poly].<cuda|cpu>.pt2``."""
    tag = ".poly" if polymorphic else ""
    return os.path.join(out_dir, f"{name}{tag}.{torch.device(device).type}{_SUFFIX}")


def save_exported(exported: ExportedProgram, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(exported, path)
    return path


def export_to_dir(out_dir: str, names: Sequence[str] | None = None, height: int = 480,
                  width: int = 640, batch: int = 1, *, device: str | torch.device,
                  **overrides) -> list[str]:
    """Export every named pipeline (default: all) into ``out_dir`` on
    ``device``; returns the written paths."""
    return [save_exported(export_model(name, height, width, batch, device=device, **overrides),
                          artifact_path(out_dir, name, device))
            for name in (list(names) if names else registry.names())]


def load_exported(path: str) -> torch.nn.Module:
    """Load an artifact; returns a module that runs the pipeline on the
    device it was exported on. Imports the port's kernel modules first, so
    the graph's custom ops resolve."""
    from ..kernels import _register_all

    _register_all()
    return torch.export.load(path).module()
