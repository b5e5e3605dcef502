"""The host-side work plans of the port's CUDA kernels, and their C bindings.

The Sinkhorn kernel's launch layout (``sinkhorn_plan``), the sampler's work
plan (``sampler_plan``), the AKAZE ladder's route and tiles (``ladder_plan``)
and the detect kernel's tiles (``detect_plan``) are plain Python that needs
no card, so their invariants are held here; so are the ctypes types of the
entries the wrappers call, against the ``extern "C"`` signatures in
``csrc/``, and the build's digest of the sources and headers.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from onnx_image_processing_tpu_torch import ops
from onnx_image_processing_tpu_torch.kernels import (_build, akaze_ladder, detect_frontend,
                                                     essential_solve, select_frontend,
                                                     sinkhorn_kernel, sparse_sampler)

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


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("b,h,w", [(2, 480, 640), (1, 480, 640), (1, 720, 1280),
                                   (2, 96, 128), (3, 5, 300), (1, 3, 9), (2, 40, 40)])
@pytest.mark.parametrize("nms_radius,half", [(2, 7), (3, 4), (1, 15)])
def test_ladder_plan_tiles(b, h, w, sms, nms_radius, half):
    """Resident: the tiles cover every pixel of an image once, every tile
    but a sole one along its axis is at least the halo deep (its halo lies
    in its 8 neighbours), the CTAs fit one per SM, and the shared memory is
    what the kernel computes, within the limit."""
    plan = akaze_ladder.ladder_plan(b, h, w, sms, akaze_ladder.SMEM_LIMIT, nms_radius, half)
    assert plan.route == "resident"
    assert plan.halo == max(2, nms_radius + 1, half)
    assert b * plan.ny * plan.nx <= sms
    tiles = plan.tiles(h, w)
    covered = np.zeros((h, w), dtype=int)
    for y0, y1, x0, x1 in tiles:
        covered[y0:y1, x0:x1] += 1
        assert plan.ny == 1 or y1 - y0 >= plan.halo
        assert plan.nx == 1 or x1 - x0 >= plan.halo
    assert (covered == 1).all()
    th, tw = -(-h // plan.ny), -(-w // plan.nx)
    assert max(y1 - y0 for y0, y1, _, _ in tiles) == th
    assert 1 <= plan.out_rows <= th
    assert plan.smem_bytes == 4 * akaze_ladder._resident_floats(th, tw, nms_radius, half,
                                                                plan.out_rows)
    assert plan.smem_bytes <= akaze_ladder.SMEM_LIMIT


@pytest.mark.parametrize("b,h,w,tiles,chunk", [(2, 480, 640, (6, 11), 80),
                                               (1, 480, 640, (12, 11), 40),
                                               (1, 1080, 1920, (12, 11), 50)])
def test_ladder_plan_path_shapes(b, h, w, tiles, chunk):
    """The pair and the VO frame: every SM's worth of tiles (132 CTAs), the
    scale outputs in one chunk per tile; a 1080p frame in chunks."""
    plan = akaze_ladder.ladder_plan(b, h, w)
    assert (plan.ny, plan.nx) == tiles and b * plan.ny * plan.nx == 132
    assert plan.out_rows == chunk


@pytest.mark.parametrize("b,h,w", [(2, 1080, 1920), (1, 2160, 3840), (8, 480, 640),
                                   (200, 32, 32)])
def test_ladder_plan_global_route(b, h, w):
    """A state past what the card's shared memory holds in tiles of one CTA
    per SM, or more images than SMs, takes the per-step launches."""
    plan = akaze_ladder.ladder_plan(b, h, w)
    assert plan.route == "global" and plan.ny == plan.nx == 0
    # L and the two flux maps (12 bytes a pixel) past ~90% of 132 SMs' shared memory.
    assert 12 * b * h * w > 0.9 * 132 * akaze_ladder.SMEM_LIMIT or b > 132


def test_ladder_plan_rejects_what_cannot_run():
    with pytest.raises(ValueError):
        akaze_ladder.ladder_plan(0, 480, 640)
    with pytest.raises(ValueError):
        akaze_ladder.ladder_plan(1, 0, 640)
    with pytest.raises(ValueError):
        akaze_ladder.ladder_plan(1, 480, 640, nms_radius=16)
    with pytest.raises(ValueError):
        akaze_ladder.ladder_plan(1, 480, 640, half=16)


@pytest.mark.parametrize("b,h,w", [(2, 480, 640), (1, 480, 640), (1, 1080, 1920),
                                   (8, 480, 640), (2, 5, 300), (2, 97, 131), (1, 3, 9)])
@pytest.mark.parametrize("rb,rn,half", [(2, 5, 7), (1, 5, 7), (1, 3, 7), (0, 0, 0),
                                        (15, 15, 15), (3, 1, 4), (2, 0, 7), (2, 0, 0)])
def test_detect_plan_tiles(b, h, w, rb, rn, half):
    """Tiles of whole (rn+1)^2 NMS blocks that cover the image, a halo as
    deep as the Sobel, box and NMS windows and the moments reach, and the
    shared memory the kernel computes, within two CTAs per SM."""
    plan = detect_frontend.detect_plan(b, h, w, rb, rn, half)
    bs = rn + 1
    assert plan.th % bs == 0 and plan.tw % bs == 0 and plan.th >= bs and plan.tw >= bs
    assert plan.halo >= max(1 + rb + rn, half) and plan.halo == max(1 + rb + rn, half)
    assert plan.ny == -(-h // plan.th) and plan.nx == -(-w // plan.tw)
    assert (plan.ny - 1) * plan.th < h and (plan.nx - 1) * plan.tw < w   # no empty tile
    assert plan.smem_bytes == 4 * detect_frontend._smem_floats(rb, rn, half, plan.th, plan.tw)
    assert plan.smem_bytes <= detect_frontend.SMEM_TWO_CTAS <= detect_frontend.SMEM_LIMIT


def test_detect_plan_fits_every_radius():
    """The smallest tile (one NMS block) of every radius set up to 15 fits
    two CTAs per SM, so the plan always finds a tile."""
    for rb in range(16):
        for rn in range(16):
            for half in range(16):
                bs = rn + 1
                smem = 4 * detect_frontend._smem_floats(rb, rn, half, bs, bs)
                assert smem <= detect_frontend.SMEM_TWO_CTAS, (rb, rn, half)


@pytest.mark.parametrize("rb", [1, 2])
def test_detect_plan_fills_the_card(rb):
    """The pair at the flagship's radii: CTAs for every one of 132 SMs, in
    one wave of two CTAs per SM, on tiles larger than 32 x 32."""
    plan = detect_frontend.detect_plan(2, 480, 640, rb, 5, 7, sms=132)
    ctas = 2 * plan.ny * plan.nx
    assert 132 <= ctas <= 2 * 132
    assert plan.th * plan.tw > 32 * 32


@pytest.mark.parametrize("b,half", [(2, 7), (16, 7), (16, 0)])
def test_score_moments_plan_fills_the_card(b, half):
    """The unmasked pass (NMS radius 0) of the pair and of a served chunk
    of 8 pairs: at least one wave of two CTAs per SM, on tiles larger than
    32 x 32; without the moments the halo is the Sobel's and the box's."""
    plan = detect_frontend.detect_plan(b, 480, 640, 2, 0, half, sms=132)
    assert b * plan.ny * plan.nx >= 2 * 132
    assert plan.th * plan.tw > 32 * 32
    assert plan.halo == max(3, half)


def test_detect_plan_rejects_what_cannot_run():
    for args in ((0, 480, 640, 2, 5, 7), (1, 0, 640, 2, 5, 7), (1, 480, 640, 16, 5, 7),
                 (1, 480, 640, 2, 16, 7), (1, 480, 640, 2, 5, 16), (1, 480, 640, -1, 5, 7)):
        with pytest.raises(ValueError):
            detect_frontend.detect_plan(*args)


def test_build_digest_covers_headers(tmp_path, monkeypatch):
    """Editing a header that the sources include (select_topk.cuh) changes
    the library's name, so the library is rebuilt, not loaded stale."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._digest()
    assert _build._digest() == before
    header = csrc / "select_topk.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build._digest() != before


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
    ("sparse_sampler.cu", "oip_sparse_sampler_ablate", sparse_sampler._ABLATE_ARGTYPES),
    ("select_frontend.cu", "oip_select_frontend", select_frontend._ARGTYPES),
    ("select_frontend.cu", "oip_select_topk", select_frontend._TOPK_ARGTYPES),
    ("akaze_ladder.cu", "oip_akaze_ladder", akaze_ladder._ARGTYPES),
    ("akaze_ladder.cu", "oip_akaze_ladder_resident", akaze_ladder._RESIDENT_ARGTYPES),
    ("detect_frontend.cu", "oip_detect_frontend", detect_frontend._ARGTYPES),
    ("detect_frontend.cu", "oip_detect_select", detect_frontend._SELECT_ARGTYPES),
    ("essential_solve.cu", "oip_min_eigvec9", essential_solve._ARGTYPES),
    ("essential_solve.cu", "oip_project_essential", essential_solve._ARGTYPES),
    ("essential_solve.cu", "oip_essential_hypotheses", essential_solve._HYPOTHESES_ARGTYPES)])
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
