"""Pipeline configuration dataclasses of the port.

A copy, field for field and default for default, of
``onnx_image_processing_tpu/core/config.py``, so the port needs nothing of
the JAX package and a config is interchangeable between the two packages
as a value (``tests/test_torch_self_contained.py`` holds the two copies
together). The JAX package's backend knobs (``use_pallas``,
``integer_image``, ``select_frontend``) are kept for that reason and have
no effect in the port, which picks kernel or plain version by the tensor's
device. Field names and defaults mirror the reference flags (README option
tables, `README.md:54-66,93-103,148-177`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace, fields


@dataclass(frozen=True)
class FASTConfig:
    """FAST-9 detector hyperparameters; defaults mirror the reference export
    flags (`onnx_export/export_fast.py:44-60`: threshold 20, NMS off,
    nms radius 3)."""

    threshold: float = 20.0
    use_nms: bool = False
    nms_radius: int = 3

    def with_(self, **kwargs) -> "FASTConfig":
        return replace(self, **kwargs)


@dataclass(frozen=True)
class DoGConfig:
    """Difference-of-Gaussians hyperparameters; defaults mirror
    `onnx_export/export_dog.py:46-70` (5 scales, sigma 1.6 * sqrt(2)^i,
    auto kernel size)."""

    num_scales: int = 5
    sigma_base: float = 1.6
    sigma_ratio: float = math.sqrt(2)
    kernel_size: int | None = None

    def with_(self, **kwargs) -> "DoGConfig":
        return replace(self, **kwargs)


@dataclass(frozen=True)
class AKAZEConfig:
    """AKAZE detector hyperparameters; defaults mirror the reference module
    constructor (`pytorch_model/detector/akaze.py:348-357`), which the export
    scripts also use (`onnx_export/export_akaze.py:50-86`)."""

    num_scales: int = 3
    diffusion_iterations: int = 3
    kappa: float = 0.05
    threshold: float = 0.001
    nms_size: int = 5
    orientation_patch_size: int = 15
    orientation_sigma: float = 2.5

    def with_(self, **kwargs) -> "AKAZEConfig":
        return replace(self, **kwargs)


@dataclass(frozen=True)
class MatcherConfig:
    """Configuration shared by every detector → descriptor → Sinkhorn pipeline.

    Defaults follow the reference matcher constructors
    (`shi_tomasi_angle_sparse_bad_sinkhorn.py:75-94`,
    `shi_tomasi_bad_sinkhorn.py:79-95`, `akaze_sparse_bad_sinkhorn.py`).
    ``border_margin=None`` means "descriptor max radius" for sparse pipelines
    and 0 for dense ones, matching `shi_tomasi_sparse_bad_sinkhorn.py:121-124`.
    """

    # Keypoint selection
    max_keypoints: int = 512
    nms_radius: int = 3
    score_threshold: float = 0.0
    border_margin: int | None = None
    # "block": block-reduced top-k (sort over per-(r+1)^2 block maxima — 16-36x
    # less sort work; collapses exact same-block score TIES to one keypoint
    # where the reference keeps every tied copy; see ops/keypoints.py).
    # "sort": reference-exact flat top-k over H*W.
    # "approx": block reduction + lax.approx_max_k (recall 0.95) — APPROXIMATE
    # on a TPU only (a few % of rank-boundary keypoints may swap with
    # near-ties; there the TopK custom call is 17% of the 1080p frame, and
    # this cuts it 5x; opt-in for hi-res throughput serving, BASELINE.md).
    # On every other backend lax.approx_max_k is the exact top-k, so the
    # port, on the CPU and on the card, selects exactly as "block".
    topk_mode: str = "block"

    # Shi-Tomasi detector
    block_size: int = 3
    sobel_size: int = 3

    # Orientation (angle) estimation
    patch_size: int = 15
    sigma: float = 2.5

    # BAD descriptor
    num_pairs: int = 256
    binarize: bool = False
    soft_binarize: bool = True
    temperature: float = 10.0
    normalize_descriptors: bool = True
    sampling_mode: str = "nearest"

    # Sinkhorn matcher
    sinkhorn_iterations: int = 20
    epsilon: float = 1.0
    unused_score: float = 1.0
    distance_type: str = "l2"

    # Outlier filters (WithFilters variants); None disables
    ratio_threshold: float | None = None
    dustbin_margin: float | None = None

    # Match extraction wrapper
    max_matches: int = 100
    match_threshold: float = 0.1

    # AKAZE detector (used by the AKAZE pipeline family only)
    akaze: AKAZEConfig = AKAZEConfig()

    # FAST / DoG standalone detectors (reference: export_fast.py, export_dog.py)
    fast: FASTConfig = FASTConfig()
    dog: DoGConfig = DoGConfig()

    # Pallas backend for the WINNING kernels — the descriptor sampler AND
    # (since the round-5 dynamic-axes work threaded it through every
    # pipeline) the VMEM-resident Sinkhorn sweeps: None = auto (kernels on
    # TPU, jnp on CPU); True/False force BOTH together. Set False when
    # running TPU-traced code on a CPU mesh (e.g. the multichip dry run) or
    # for cross-platform exports. A/B-ing one kernel in isolation means
    # calling its op directly (ops/bad.sparse_bad(use_pallas=...),
    # ops/sinkhorn.sinkhorn_match(use_pallas=...)), not this flag. The
    # measured-negative detect kernels ride fused_detect below instead.
    use_pallas: bool | None = None

    # Promise that input pixel values are integers (true for uint8-derived
    # images, i.e. everything the CLIs load). Routes the nearest-mode Pallas
    # descriptor sampler through an int8-digit MXU contraction whose box sums
    # are EXACT (zero rounding; the bf16x3 default is ~3e-5). Measured
    # 10-35% slower than the default at every production cell
    # (benchmarks/int8_sampler_ab.py; docs/KERNELS.md), so it is an
    # exactness option, not a perf one.
    integer_image: bool = False

    # Route the detect side through the hand-fused Pallas kernels: the
    # Shi-Tomasi front-end (kernels/detect_frontend.py) and the AKAZE ladder
    # (kernels/akaze_ladder.py). OFF by default: both measured SLOWER than
    # XLA's own fusion of the separable stencils on v5e (front-end 0.134 vs
    # 0.095 ms and it blocks cross-stage overlap, 1689 -> 1309 FPS; ladder
    # 0.31 vs 0.26 ms) — kept as an opt-in so the negative results stay
    # reproducible. Distinct from use_pallas, which selects the descriptor
    # SAMPLER backend (where the kernel wins and TPU defaults to it).
    fused_detect: bool = False

    # In-graph essential-matrix robustness (essential_family pipelines only):
    # 0 reproduces the reference's single soft-weighted LS solve
    # (`shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix.py:184-271`);
    # >0 adds that many fixed Cauchy-IRLS reweighting iterations on Sampson
    # error (geometry/essential_matrix.py) — a TPU-native extension the
    # reference's opset-14 graph cannot express.
    essential_irls_iters: int = 0
    # IRLS Cauchy scale as a pixel tolerance: tau = (px / fx)^2 in normalized
    # coordinates, computed from the runtime k_inv (camera-aware, like a
    # RANSAC threshold).
    essential_irls_px: float = 2.0
    # >0 switches the in-graph essential solve to fixed-shape vectorized
    # RANSAC (geometry/essential_matrix.py:essential_ransac_from_candidates):
    # that many Gumbel-top-k weighted minimal samples solved in one vmapped
    # batch, MSAC-scored over the mutual-best candidates, inlier refit +
    # essential_irls_iters Cauchy polish steps. Unlike IRLS (which descends
    # from the global soft fit and can entrench a wrong basin on ambiguous
    # scenes), RANSAC restarts from many minimal samples — RANSAC-grade
    # robustness with zero host-side geometry, still one static jit graph.
    essential_ransac_hypotheses: int = 0
    # RANSAC inlier threshold in pixels (tau = (px / fx)^2, camera-aware).
    # 0.75 is the measured accuracy optimum of the round-5 px x hypotheses
    # sweep on both VO scenes: it beats the host cv2-RANSAC stack on every
    # deep-scene metric (ATE 0.188 vs 0.279, t-dir 9.6 vs 9.9 deg) where the
    # old 2.0 trailed translation direction 14.3 vs 9.9 deg (BASELINE.md).
    essential_ransac_px: float = 0.75

    # Selection frontend backend: "auto" routes the NMS + block-reduce stage
    # through the fused Pallas kernel (kernels/select_frontend.py) whenever
    # the descriptor path is on Pallas (use_pallas semantics), "pallas"/"xla"
    # force it either way. Orthogonal to use_pallas so the two kernels can be
    # measured and deployed independently.
    select_frontend: str = "auto"

    def __post_init__(self):
        # Validate here (not in one selector helper) so every pipeline path —
        # including the fused front-end's _select_premasked, which would
        # otherwise silently degrade an unknown mode to flat-sort behavior —
        # fails loudly at construction.
        if self.topk_mode not in ("block", "sort", "approx"):
            raise ValueError(f"unknown topk_mode {self.topk_mode!r} "
                             "(expected 'block', 'sort', or 'approx')")
        if self.select_frontend not in ("auto", "pallas", "xla"):
            raise ValueError(
                f"unknown select_frontend {self.select_frontend!r} "
                "(expected 'auto', 'pallas', or 'xla')")

    def with_(self, **kwargs) -> "MatcherConfig":
        """Replace fields. Flat sub-config keys are accepted with their prefix:
        ``fast_threshold=30`` == ``fast=cfg.fast.with_(threshold=30)``; same for
        ``dog_*`` and ``akaze_*`` — the CLI-flag form of the nested configs."""
        return replace(self, **self._fold_nested(kwargs, self))

    @classmethod
    def from_kwargs(cls, **kwargs) -> "MatcherConfig":
        """Build from a flat kwarg dict, ignoring unknown keys and None values
        (CLI-friendly). Accepts prefixed sub-config keys like ``with_``."""
        base = cls()
        folded = cls._fold_nested(
            {k: v for k, v in kwargs.items() if v is not None}, base,
            ignore_unknown=True)
        return replace(base, **folded)

    @staticmethod
    def _fold_nested(kwargs: dict, base: "MatcherConfig",
                     ignore_unknown: bool = False) -> dict:
        sub = {"fast": FASTConfig, "dog": DoGConfig, "akaze": AKAZEConfig}
        names = {f.name for f in fields(MatcherConfig)}
        out, nested = {}, {}
        for k, v in kwargs.items():
            prefix = k.split("_", 1)[0]
            if prefix in sub and "_" in k and k not in names:
                field = k.split("_", 1)[1]
                if field in {f.name for f in fields(sub[prefix])}:
                    nested.setdefault(prefix, {})[field] = v
                    continue
            if k in names:
                out[k] = v
            elif not ignore_unknown:
                raise TypeError(f"unknown MatcherConfig field {k!r}")
        for prefix, vals in nested.items():
            current = out.get(prefix, getattr(base, prefix))
            out[prefix] = replace(current, **vals)
        return out


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics (fx, fy, cx, cy) used to build K / K^-1 for the
    essential-matrix pipelines (`onnx_export/
    export_shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix.py:268`)."""

    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0

    def matrix(self):
        import numpy as np

        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )
