"""The essential solve's three kernels: the 9x9 minimum eigenvector, the
projection onto the essential manifold and the RANSAC hypothesis solve.

None of them replaces a Pallas kernel: the JAX package runs these steps in
XLA inside its jit (``onnx_image_processing_tpu/geometry/essential_matrix.py``
``jnp.linalg.eigh`` at :101-102, ``jnp.linalg.svd`` at :222-223 and the
hypothesis ``vmap`` at :499-501). On a CUDA tensor each wrapper launches
``csrc/essential_solve.cu`` once, in place of ``torch.linalg.eigh`` and
``torch.linalg.svd`` (cuSOLVER copies a status to the host in every call,
so a solve could not be captured in a CUDA graph) and of the ~2,000 small
launches of the unrolled hypothesis solve. On a CPU tensor it runs the
plain version, the code that ran before the kernels. What bounds the
kernels on the card is latency: a call is a handful of CTAs running a
chain of dependent float64 (or, for the hypotheses, float32) operations.

Each wrapper goes through a ``torch.library`` custom op
(``oip::min_eigvec9``, ``oip::project_essential``,
``oip::essential_hypotheses``), which ``torch.export`` keeps as one node.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, _build, use_kernel
from ..geometry.essential_matrix import (_compose, _det3, _with_sign,
                                         essential_from_matched_points)

EIG_LAUNCHES = LaunchCounter("min_eigvec9")
PROJECT_LAUNCHES = LaunchCounter("project_essential")
HYPOTHESES_LAUNCHES = LaunchCounter("essential_hypotheses")

POINTS = 8   # points of a minimal sample (the hypothesis kernel's only size)
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
_HYPOTHESES_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(entry: str, argtypes: list, counter: LaunchCounter, inputs, out) -> torch.Tensor:
    """One launch of ``entry`` on ``out``'s device and current stream."""
    fn = _build.entry(entry, argtypes)
    with torch.cuda.device(out.device):
        err = fn(*(t.data_ptr() for t in inputs), out.data_ptr(), out.shape[0],
                 _build.stream(out))
    _build.check(err, entry)
    counter.count += 1
    return out


# ---- the 9x9 minimum eigenvector ------------------------------------------------

def min_eigvec9_plain(m: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.eigh`` in float64 (LAPACK reads the lower triangle):
    the unit eigenvector of the smallest eigenvalue, in ``m``'s dtype."""
    return torch.linalg.eigh(m.double())[1][..., :, 0].to(m.dtype)


def min_eigvec9(m: torch.Tensor) -> torch.Tensor:
    """Unit eigenvectors (..., 9) of the smallest eigenvalues of symmetric
    (..., 9, 9) matrices; sign as the solver leaves it. On a CUDA tensor
    (float32) one kernel launch: cyclic Jacobi in float64, on tied smallest
    eigenvalues the lowest index."""
    if m.shape[-2:] != (9, 9):
        raise ValueError(f"min_eigvec9: expected (..., 9, 9), got {tuple(m.shape)}")
    return min_eigvec9_op(m.reshape(-1, 9, 9).contiguous()).reshape(m.shape[:-1])


@torch.library.custom_op("oip::min_eigvec9", mutates_args=())
def min_eigvec9_op(m: torch.Tensor) -> torch.Tensor:
    """The op behind :func:`min_eigvec9`, on (B, 9, 9)."""
    if not use_kernel(m):
        return min_eigvec9_plain(m).contiguous()
    _check("m", m, (m.shape[0], 9, 9), m.device)
    out = torch.empty((m.shape[0], 9), dtype=torch.float32, device=m.device)
    return _launch("oip_min_eigvec9", _ARGTYPES, EIG_LAUNCHES, (m,), out)


@min_eigvec9_op.register_fake
def _(m):
    return m.new_empty(m.shape[:-1])


# ---- the projection onto the essential manifold -------------------------------

def project_essential_plain(e: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.svd`` with the det-sign correction of U and V, then
    U diag(s, s, 0) V^T with s the mean of the two largest singular values."""
    u, s, vt = torch.linalg.svd(e)
    v = vt.transpose(-1, -2)
    # The sign of the determinant of an orthogonal matrix: _det3 gives
    # the same sign as a general determinant.
    u = _with_sign((u[..., :, 0], u[..., :, 1], u[..., :, 2]), torch.sign(_det3(u)))
    v = _with_sign((v[..., :, 0], v[..., :, 1], v[..., :, 2]), torch.sign(_det3(v)))
    return _compose(u, (s[..., 0] + s[..., 1]) / 2.0, v)


def project_essential(e: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) matrices projected to singular values [s, s, 0]. On a
    CUDA tensor (float32) one kernel launch, in float64 inside: the third
    singular pair is multiplied by 0, so the result does not depend on the
    signs of the singular vectors."""
    if e.shape[-2:] != (3, 3):
        raise ValueError(f"project_essential: expected (..., 3, 3), got {tuple(e.shape)}")
    return project_essential_op(e.reshape(-1, 3, 3).contiguous()).reshape(e.shape)


@torch.library.custom_op("oip::project_essential", mutates_args=())
def project_essential_op(e: torch.Tensor) -> torch.Tensor:
    """The op behind :func:`project_essential`, on (B, 3, 3)."""
    if not use_kernel(e):
        return project_essential_plain(e)
    _check("e", e, (e.shape[0], 3, 3), e.device)
    out = torch.empty_like(e)
    return _launch("oip_project_essential", _ARGTYPES, PROJECT_LAUNCHES, (e,), out)


@project_essential_op.register_fake
def _(e):
    return e.new_empty(e.shape)


# ---- the RANSAC hypothesis solve ------------------------------------------------

def essential_hypotheses_plain(weights: torch.Tensor, pts1: torch.Tensor,
                               pts2: torch.Tensor) -> torch.Tensor:
    """The unrolled-Cholesky matched solve, without the projection."""
    return essential_from_matched_points(weights, pts1, pts2, method="fast", project=False)


def essential_hypotheses(weights: torch.Tensor, pts1: torch.Tensor,
                         pts2: torch.Tensor) -> torch.Tensor:
    """One essential matrix per minimal sample: (S, 8) weights and (S, 8, 2)
    normalized points of each side -> (S, 3, 3), ``x2^T E x1 = 0``, not
    projected. On a CUDA tensor (float32) one kernel launch, a thread per
    sample."""
    return essential_hypotheses_op(weights, pts1, pts2)


@torch.library.custom_op("oip::essential_hypotheses", mutates_args=())
def essential_hypotheses_op(weights: torch.Tensor, pts1: torch.Tensor,
                            pts2: torch.Tensor) -> torch.Tensor:
    """The op behind :func:`essential_hypotheses`."""
    if not use_kernel(weights):
        return essential_hypotheses_plain(weights, pts1, pts2).contiguous()
    s = weights.shape[0]
    _check("weights", weights, (s, POINTS), weights.device)
    _check("pts1", pts1, (s, POINTS, 2), weights.device)
    _check("pts2", pts2, (s, POINTS, 2), weights.device)
    out = torch.empty((s, 3, 3), dtype=torch.float32, device=weights.device)
    return _launch("oip_essential_hypotheses", _HYPOTHESES_ARGTYPES, HYPOTHESES_LAUNCHES,
                   (weights, pts1, pts2), out)


@essential_hypotheses_op.register_fake
def _(weights, pts1, pts2):
    return weights.new_empty((weights.shape[0], 3, 3))
