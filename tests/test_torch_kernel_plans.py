"""The host-side work plans of the port's CUDA kernels, and their C bindings.

The Sinkhorn kernel's launch layout (``sinkhorn_plan``) and the sampler's
work plan (``sampler_plan``) are plain Python that needs no card, so their
invariants are held here; so are the ctypes types of the entries these
wrappers call, against the ``extern "C"`` signatures in ``csrc/``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from onnx_image_processing_tpu_torch import ops
from onnx_image_processing_tpu_torch.kernels import _build, sinkhorn_kernel, sparse_sampler

CSRC = Path(sinkhorn_kernel.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n1,m1", [(65, 129), (513, 513), (1025, 1025), (2049, 2049),
                                   (4097, 4097)])
def test_sinkhorn_plan(n1, m1, sms, batch):
    plan = sinkhorn_kernel.sinkhorn_plan(n1, m1, sms, batch)
    assert 1 <= plan.groups <= min(batch, sms)
    assert plan.ctas * plan.groups <= sms   # the cooperative launch fits one CTA per SM
    for size in (n1, m1):   # every row, and every column, owned by exactly one CTA
        owned = sorted(i for band in plan.bands(size) for i in band)
        assert owned == list(range(size))
        assert max(len(band) for band in plan.bands(size)) == plan.lines
    assert plan.smem_bytes <= sinkhorn_kernel.SMEM_LIMIT
    assert 0 <= plan.res_cols <= plan.res_rows <= plan.lines
    assert plan.smem_bytes == 4 * (plan.res_rows * m1 + plan.res_cols * n1 + max(n1, m1)
                                   + 2 * 16 + plan.lines)
    if max(n1, m1) <= 1025 or plan.groups > 1:   # bands keep every line in shared memory
        assert plan.res_rows == plan.res_cols == plan.lines
    if plan.groups > 1:   # and take a CTA's lines in one pass of its 16 warps
        assert plan.lines <= 16
    if n1 == 4097:   # rows only partly resident, columns read from device memory
        assert 0 < plan.res_rows < plan.lines and plan.res_cols == 0


@pytest.mark.parametrize("n1,batch,groups", [(65, 8, 8), (513, 2, 2), (513, 8, 4),
                                               (1025, 2, 2), (1025, 8, 2), (4097, 2, 1)])
def test_sinkhorn_plan_bands(n1, batch, groups):
    """Entries side by side while their bands keep every line in shared
    memory and at most 16 lines a CTA (132 SMs), the rest in turn."""
    assert sinkhorn_kernel.sinkhorn_plan(n1, n1, 132, batch).groups == groups


def test_sinkhorn_plan_rejects_what_cannot_run():
    with pytest.raises(ValueError):
        sinkhorn_kernel.sinkhorn_plan(0, 5)
    with pytest.raises(ValueError):
        sinkhorn_kernel.sinkhorn_plan(5, 5, batch=0)
    with pytest.raises(ValueError):   # the vectors alone exceed shared memory
        sinkhorn_kernel.sinkhorn_plan(10, 60_000)


def _table_groups(pairs):
    return ops.BADTable(ops.load_bad_params(pairs)).groups


@pytest.mark.parametrize("pairs", [256, 512])
def test_sampler_plan(pairs):
    """Each sample once, each task within one radius group and one warp's
    32 lanes, and the warps' loads within one task of each other (the
    longest-first greedy deal)."""
    groups = _table_groups(pairs)
    warps = sparse_sampler.WARPS
    plan = sparse_sampler.sampler_plan(groups)
    assert plan.dtype == np.int32
    offsets, tasks = plan[:warps + 1], plan[warps + 1:].reshape(-1, 3)
    assert offsets[0] == 0 and offsets[-1] == len(tasks) and (np.diff(offsets) >= 0).all()
    radius_of = {j: r for (r, lo, hi) in groups for j in range(lo, hi)}
    seen = []
    for r, lo, n in tasks:
        assert 1 <= n <= 32
        assert all(radius_of[j] == r for j in range(lo, lo + n))
        seen += range(lo, lo + n)
    assert sorted(seen) == list(range(groups[-1][2]))
    loads = [sum((2 * r + 1) ** 2 for r, _, _ in tasks[offsets[w]:offsets[w + 1]])
             for w in range(warps)]
    assert max(loads) - min(loads) <= max((2 * r + 1) ** 2 for r, _, _ in tasks)


def test_sampler_plan_rejects_groups_that_do_not_tile():
    with pytest.raises(ValueError):
        sparse_sampler._device_plan(((1, 0, 4), (2, 5, 9)), 9, torch.device("cpu"))
    with pytest.raises(ValueError):
        sparse_sampler._device_plan(((1, 0, 4),), 9, torch.device("cpu"))


def _c_params(source: str, name: str) -> list[str]:
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, f"{name} not in {source}"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("source,name,argtypes", [
    ("sinkhorn.cu", "oip_sinkhorn", sinkhorn_kernel._ARGTYPES),
    ("sparse_sampler.cu", "oip_sparse_sampler", sparse_sampler._ARGTYPES),
    ("sparse_sampler.cu", "oip_sparse_sampler_ablate", sparse_sampler._ABLATE_ARGTYPES)])
def test_wrapper_argtypes_match_c_entries(source, name, argtypes):
    """A pointer is passed as c_void_p, an int as c_int, a float as c_float,
    one for one: ctypes would otherwise cut pointers or shift arguments."""
    params = _c_params(source, name)
    assert len(params) == len(argtypes)
    for param, t in zip(params, argtypes):
        want = (ctypes.c_void_p if "*" in param else
                ctypes.c_float if param.startswith("float") else ctypes.c_int)
        assert t is want, (param, t)


def test_entry_is_typed_once(monkeypatch):
    """The ctypes entry is typed at first use and the same function object
    is returned after; asking it with other types is an error."""
    monkeypatch.setattr(_build, "library", lambda: ctypes.CDLL(None))
    monkeypatch.setattr(_build, "_entries", {})
    first = _build.entry("abs", [ctypes.c_int])
    assert first.restype is ctypes.c_int and first(-3) == 3
    assert _build.entry("abs", [ctypes.c_int]) is first
    with pytest.raises(TypeError):
        _build.entry("abs", [ctypes.c_long])
