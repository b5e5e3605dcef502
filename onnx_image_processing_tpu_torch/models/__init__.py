"""Pipelines of the port and their registry."""

from .registry import PipelineSpec, build, get, names
from .shi_tomasi_family import (ShiTomasiAngleSparseBADSinkhorn,
                                shi_tomasi_angle_sparse_bad_sinkhorn_match)
from .extraction import MatchExtraction, with_match_extraction
from .akaze_family import (AKAZEDetector, AKAZESparseBADSinkhorn,
                           akaze_sparse_bad_sinkhorn_match)

__all__ = ["PipelineSpec", "build", "get", "names",
           "ShiTomasiAngleSparseBADSinkhorn",
           "shi_tomasi_angle_sparse_bad_sinkhorn_match", "MatchExtraction",
           "with_match_extraction", "AKAZEDetector", "AKAZESparseBADSinkhorn",
           "akaze_sparse_bad_sinkhorn_match"]
