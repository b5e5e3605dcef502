"""Hand-written CUDA kernels for Hopper + the one rule that routes to them.

Every op with a kernel (select frontend, sparse sampler, Sinkhorn sweeps,
detect frontend, AKAZE ladder, and the essential solve's minimum
eigenvector, projection and hypothesis solve) asks :func:`use_kernel`
about the tensor it was given: a CUDA tensor goes to the kernel, a CPU
tensor to the kernel's plain PyTorch version. This is the
counterpart of the JAX package's ``use_pallas_default``, decided per tensor
instead of by a global platform. There is no fallback: on a CUDA tensor a
wrapper launches its kernel or raises.

Each wrapper counts its launches in a :class:`LaunchCounter`, so a run can
show that its main path went through the kernels.

Every kernel entry that a pipeline reaches is a ``torch.library`` custom op
in the ``oip`` namespace (``oip::nms_block_reduce``,
``oip::nms_select_blocks``, ``oip::box_sample``, ``oip::sinkhorn_core``,
``oip::detect_frontend``, ``oip::score_moments``, ``oip::detect_select``,
``oip::akaze_ladder``,
``oip::min_eigvec9``, ``oip::project_essential``,
``oip::essential_hypotheses``):
the public wrapper calls its op, and the op runs the plain version or
launches the kernel by :func:`use_kernel`. Each op has a fake
implementation that gives its output shapes from the inputs' (symbolic)
sizes, so ``torch.export`` keeps it as one node of a graph without calling
it; an exported program runs the hand kernels on the card. The sampler's
stage ablation, reached only by a tool, stays a direct call.

The C entries read the current device (``cudaGetDevice``) to set their
per-device attributes, and launch on PyTorch's current stream of the
tensor's device, so each op makes its tensor's device current around its
launch: a tensor on a second card never launches on the first card's
context.
"""

from __future__ import annotations

import torch


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain version)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


class LaunchCounter:
    """Launch count of one kernel; its wrapper adds one per launch."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        _COUNTERS[name] = self


_COUNTERS: dict[str, LaunchCounter] = {}


def _register_all() -> None:
    """Import every kernel module, so each counter exists before it is read."""
    from . import (akaze_ladder, detect_frontend, essential_solve,  # noqa: F401
                   select_frontend, sinkhorn_kernel, sparse_sampler)


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    _register_all()
    return {name: c.count for name, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    _register_all()
    for c in _COUNTERS.values():
        c.count = 0
