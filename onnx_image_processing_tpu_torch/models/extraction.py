"""Match-extraction wrapper (port of ``onnx_image_processing_tpu/models/extraction.py``)."""

from __future__ import annotations

from torch import nn

from ..core import MatcherConfig
from ..ops import extract_mutual_matches


def append_mutual_matches(outputs, cfg: MatcherConfig):
    """``(kpts1, kpts2, P, *extras)`` -> ``(matched_kpts1 (B, M, 2),
    matched_kpts2 (B, M, 2), match_scores (B, M), match_valid (B, M),
    *extras)`` with M = ``cfg.max_matches``."""
    kpts1, kpts2, probs, *extras = outputs
    mk1, mk2, scores, valid = extract_mutual_matches(
        probs, kpts1, kpts2, max_matches=cfg.max_matches,
        threshold=cfg.match_threshold)
    return (mk1, mk2, scores, valid, *extras)


class MatchExtraction(nn.Module):
    """A matcher post-composed with mutual-NN match extraction.

    ``forward(*inputs)`` passes every input through to the matcher (two
    images, and ``k_inv`` for the essential pipelines); the matcher returns
    ``(kpts1, kpts2, P, *extras)`` and this module returns
    :func:`append_mutual_matches` of that (extras such as the filters'
    valid mask or E pass through).
    """

    def __init__(self, matcher: nn.Module):
        super().__init__()
        self.matcher = matcher
        self.cfg = matcher.cfg

    @property
    def device(self):
        return self.matcher.device

    def forward(self, *inputs):
        return append_mutual_matches(self.matcher(*inputs), self.cfg)


def with_match_extraction(matcher: nn.Module) -> MatchExtraction:
    return MatchExtraction(matcher)
