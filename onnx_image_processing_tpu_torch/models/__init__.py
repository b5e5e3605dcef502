"""Pipelines of the port, their registry and their streaming split."""

from .registry import PipelineSpec, Standalone, TableHead, build, get, names
from .shi_tomasi_family import (ShiTomasiAngleSparseBADSinkhorn,
                                ShiTomasiAngleSparseBADSinkhornWithFilters,
                                ShiTomasiBADSinkhorn, ShiTomasiSparseBADSinkhorn,
                                SparseMatcher, shi_tomasi_angle_sparse_bad_detect,
                                shi_tomasi_angle_sparse_bad_sinkhorn_match,
                                shi_tomasi_angle_sparse_bad_sinkhorn_match_with_filters,
                                shi_tomasi_bad_detect, shi_tomasi_bad_sinkhorn_match,
                                shi_tomasi_sparse_bad_sinkhorn_match,
                                shi_tomasi_with_angle)
from .extraction import MatchExtraction, with_match_extraction
from .akaze_family import AKAZESparseBADSinkhorn, akaze_sparse_bad_sinkhorn_match
from .essential_family import (AKAZESparseBADSinkhornEssential,
                               ShiTomasiAngleSparseBADSinkhornEssential,
                               essential_from_match)
from .streaming import build_streaming, streaming_names, supports_streaming

__all__ = ["PipelineSpec", "Standalone", "TableHead", "build", "get", "names",
           "SparseMatcher", "ShiTomasiAngleSparseBADSinkhorn", "ShiTomasiSparseBADSinkhorn",
           "ShiTomasiAngleSparseBADSinkhornWithFilters", "ShiTomasiBADSinkhorn",
           "shi_tomasi_with_angle", "shi_tomasi_bad_detect",
           "shi_tomasi_angle_sparse_bad_detect", "shi_tomasi_bad_sinkhorn_match",
           "shi_tomasi_angle_sparse_bad_sinkhorn_match",
           "shi_tomasi_angle_sparse_bad_sinkhorn_match_with_filters",
           "shi_tomasi_sparse_bad_sinkhorn_match", "MatchExtraction",
           "with_match_extraction", "AKAZESparseBADSinkhorn",
           "akaze_sparse_bad_sinkhorn_match", "AKAZESparseBADSinkhornEssential",
           "ShiTomasiAngleSparseBADSinkhornEssential", "essential_from_match",
           "build_streaming", "streaming_names", "supports_streaming"]
