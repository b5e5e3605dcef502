"""Match-extraction wrapper (port of ``onnx_image_processing_tpu/models/extraction.py``)."""

from __future__ import annotations

from torch import nn

from ..ops import extract_mutual_matches


class MatchExtraction(nn.Module):
    """A matcher post-composed with mutual-NN match extraction.

    ``matcher(image1, image2)`` returns ``(kpts1, kpts2, P, *extras)``; this
    module returns ``(matched_kpts1 (B, M, 2), matched_kpts2 (B, M, 2),
    match_scores (B, M), match_valid (B, M), *extras)`` with
    M = ``matcher.cfg.max_matches``.
    """

    def __init__(self, matcher: nn.Module):
        super().__init__()
        self.matcher = matcher
        self.cfg = matcher.cfg

    def forward(self, image1, image2):
        kpts1, kpts2, probs, *extras = self.matcher(image1, image2)
        mk1, mk2, scores, valid = extract_mutual_matches(
            probs, kpts1, kpts2, max_matches=self.cfg.max_matches,
            threshold=self.cfg.match_threshold)
        return (mk1, mk2, scores, valid, *extras)


def with_match_extraction(matcher: nn.Module) -> MatchExtraction:
    return MatchExtraction(matcher)
