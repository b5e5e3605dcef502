"""Streaming (feature-cached) matchers for sequential frames (port of
``onnx_image_processing_tpu/models/streaming.py``).

Every two-image matcher splits at its natural seam::

    extract(image)                          -> (keypoints, scores, descriptors)
    match(feats_prev, feats_curr[, k_inv])  -> the matcher's outputs

``extract`` runs once per new frame; the caller keeps the previous frame's
small feature set on the card instead of re-deriving it from its image. The
two halves are the two-image module's own ``features`` and ``tail``, and
every stage of ``features`` is batch-parallel, so ``match(extract(img1),
extract(img2))`` computes the same values as ``build(name)(img1, img2)``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import MatcherConfig
from .extraction import append_mutual_matches
from .shi_tomasi_family import _check_devices

_STREAMING = frozenset({
    "shi_tomasi_bad_sinkhorn",
    "shi_tomasi_sparse_bad_sinkhorn",
    "shi_tomasi_angle_sparse_bad_sinkhorn",
    "shi_tomasi_angle_sparse_bad_sinkhorn_with_filters",
    "shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix",
    "akaze_sparse_bad_sinkhorn",
    "akaze_sparse_bad_sinkhorn_essential_matrix",
})


def streaming_names() -> list[str]:
    """Pipelines with a streaming split (plus their ``_extraction`` variants)."""
    return sorted(_STREAMING)


def supports_streaming(name: str) -> bool:
    return name.removesuffix("_extraction") in _STREAMING


class StreamingExtract(nn.Module):
    """``forward(image (B, 1, H, W))`` -> (keypoints (B, K, 2), scores
    (B, K), descriptors (B, K, P)): the matcher's per-image frontend."""

    def __init__(self, matcher: nn.Module):
        super().__init__()
        self.matcher = matcher
        self.cfg = matcher.cfg

    @property
    def device(self) -> torch.device:
        return self.matcher.device

    def forward(self, image: torch.Tensor):
        _check_devices(self.device, image)
        return self.matcher.features(image)


class StreamingMatch(nn.Module):
    """``forward(feats1, feats2, *extra)`` -> what the two-image matcher
    returns for the two frames (``extra`` is ``k_inv`` for the essential
    pipelines); with ``with_extraction``, the mutual-NN match extraction
    of those outputs."""

    def __init__(self, matcher: nn.Module, with_extraction: bool):
        super().__init__()
        self.matcher = matcher
        self.cfg = matcher.cfg
        self.with_extraction = with_extraction

    @property
    def device(self) -> torch.device:
        return self.matcher.device

    def forward(self, feats1, feats2, *extra):
        out = self.matcher.tail(feats1, feats2, *extra)
        return append_mutual_matches(out, self.cfg) if self.with_extraction else out


def build_streaming(name: str, cfg: MatcherConfig | None = None, *,
                    device: str | torch.device, **overrides):
    """The streaming form of ``models.build(name)``: an (extract, match)
    pair of eval-mode modules on ``device`` that share one matcher. A
    ``*_extraction`` name appends the mutual-NN match extraction to
    ``match``'s outputs. JAX's ``build_streaming`` returns the two halves
    jitted; here that is ``models.jit`` of each, and ``match`` then takes
    the feature tuples as its graph's inputs.

    Sequential serving (what the VO CLI does by default)::

        extract, match = map(models.jit, models.build_streaming(name, device="cuda"))
        feats_ref = extract(frame0)
        for frame in frames[1:]:
            feats = extract(frame)
            out = match(feats_ref, feats)
            feats_ref = feats            # or keep it: reference aging
    """
    from .registry import build

    with_extraction = name.endswith("_extraction")
    base = name.removesuffix("_extraction")
    if base not in _STREAMING:
        raise KeyError(
            f"no streaming split for {name!r}; available: {streaming_names()} "
            "(+ their *_extraction variants)")
    matcher = build(base, cfg, device=device, **overrides)
    extract = StreamingExtract(matcher).eval()
    match = StreamingMatch(matcher, with_extraction).eval()
    # The names of the JAX package's two jitted halves.
    extract.pipeline_name = f"{base}_streaming_extract"
    match.pipeline_name = f"{name}_streaming_match"
    extract.capture_blocker = match.capture_blocker = matcher.capture_blocker
    return extract, match
