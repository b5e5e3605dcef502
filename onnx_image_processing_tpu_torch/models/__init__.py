"""Pipelines of the port, their registry, their streaming split and their
serialized artifacts (``torch.export``). ``jit(build(...))`` is what the
JAX package's ``build`` returns: the pipeline as cached whole-call CUDA
graphs (``core/jit.py``)."""

from ..core.jit import Jitted, jit
from .registry import (VOXEL_EXPORT_POINTS, Batched, PipelineSpec, Standalone,
                       TableHead, arg_specs, build, build_batched, compile_model, get,
                       names, resolve_config)
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
from .serialize import (POLYMORPHIC_EXPORTS, artifact_path, export_model,
                        export_model_polymorphic, export_streaming, export_to_dir,
                        load_exported, save_exported)

__all__ = ["Jitted", "jit", "VOXEL_EXPORT_POINTS", "Batched", "PipelineSpec", "Standalone",
           "TableHead", "arg_specs", "build", "build_batched", "compile_model", "get", "names",
           "resolve_config",
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
           "build_streaming", "streaming_names", "supports_streaming",
           "POLYMORPHIC_EXPORTS", "export_model", "export_model_polymorphic",
           "export_streaming", "export_to_dir", "load_exported", "save_exported",
           "artifact_path"]
