"""The port's soak (``tools/soak.py`` of the port) on the CPU: its copy of
the JAX soak's ``_p_common_diff`` gives the JAX soak's verdicts, its draws
are deterministic and stay inside the JAX soak's ranges, one small draw of
each family passes CPU against CPU, and ``main`` refuses to run without a
card."""

import numpy as np
import pytest
import torch

from onnx_image_processing_tpu_torch.tools import soak
from tools import soak as jsoak


def _outputs(rng, k):
    """(k1, k2, P) of one pair: distinct integer keypoints, a random P."""
    pts = rng.permutation(200 * 200)[:2 * k]
    k1 = np.stack([pts[:k] // 200, pts[:k] % 200], -1).astype(np.float32)[None]
    k2 = np.stack([pts[k:] // 200, pts[k:] % 200], -1).astype(np.float32)[None]
    return [k1, k2, rng.random((1, k + 1, k + 1)).astype(np.float32)]


def _permuted(out, rng):
    """The same outputs with keypoint rows permuted (P's rows and columns too)."""
    k = out[0].shape[1]
    p1, p2 = rng.permutation(k), rng.permutation(k)
    i1, i2 = np.r_[p1, k], np.r_[p2, k]
    return [out[0][:, p1], out[1][:, p2], out[2][:, i1][:, :, i2]]


def _case(name, rng, k=48):
    a = _outputs(rng, k)
    b = [x.copy() for x in _permuted(a, rng)]
    if name in ("one_swap", "five_swaps"):
        for j in range(1 if name == "one_swap" else 5):
            b[0][0, j] = (1000 + j, 1000 + j)
    elif name == "p_perturbed":
        b[2][0, :6, :6] += 0.6
    elif name == "p_slightly_perturbed":
        b[2][0, :2, :2] += 0.6
    return a, b


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("name", ["permuted", "one_swap", "five_swaps", "p_perturbed",
                                  "p_slightly_perturbed"])
def test_p_common_diff_gives_the_jax_soaks_verdict(name, hard):
    a, b = _case(name, np.random.default_rng(len(name)))
    k = a[0].shape[1]
    ours, theirs = [], []
    got = soak._p_common_diff(a, b, k, hard, "x", ours)
    want = jsoak._p_common_diff(a, b, k, hard, "x", theirs)
    assert got == want
    assert ours == theirs
    expect_errors = {"permuted": False, "one_swap": False, "five_swaps": True,
                     "p_perturbed": True, "p_slightly_perturbed": not hard}
    assert bool(ours) == expect_errors[name], ours


def _support(fn, n=600):
    """Every value each field of ``fn``'s draws took over ``n`` draws."""
    rng = np.random.default_rng(0)
    values = {}
    for i in range(n):
        for key, v in fn(rng, i).items():
            values.setdefault(key, set()).add(v)
    return values


def _inside(draw, *supports, skip=("idx", "seed", "family", "hires", "streaming",
                                   "fused_detect", "topk_mode")):
    """Each field of ``draw`` lies in one support: in its set of strings and
    flags, within its range of numbers."""
    for key, v in draw.items():
        if key in skip:
            continue
        ok = False
        for sup in supports:
            if key not in sup:
                continue
            vals = sup[key]
            if isinstance(v, (bool, str)):
                ok |= v in vals
            else:
                ok |= min(vals) <= v <= max(vals)
        assert ok, (key, v, draw)


def test_draws_are_deterministic_and_inside_the_jax_ranges():
    a, b = soak.draws(7, 60), soak.draws(7, 60)
    assert a == b and soak.draws(8, 60) != a
    assert [d["family"] for d in a[:5]] == list(soak.FAMILIES)
    small, tpu = _support(jsoak._one_draw), _support(jsoak._one_tpu_draw)
    akaze, ties = _support(jsoak._one_akaze_draw), _support(jsoak._one_ties_draw)
    for key in ("num_scales", "diffusion_iterations", "kappa"):   # the config's flat names
        akaze["akaze_" + key] = akaze.pop(key)
    # The JAX hi-res AKAZE lattice.
    lattice = {"h": {s[0] for s in jsoak._AKAZE_HIRES_SHAPES},
               "w": {s[1] for s in jsoak._AKAZE_HIRES_SHAPES},
               "max_keypoints": {512, 1024}, "nms_radius": {5}}
    seen = set()
    for d in soak.draws(3, 400):
        f = d["family"]
        if f == "flagship":
            _inside(d, tpu if d["hires"] else small)
            assert d["topk_mode"] in tpu["topk_mode"]
        elif f == "akaze":
            _inside(d, lattice, tpu if d["hires"] else akaze)
        elif f == "essential":
            _inside(d, tpu)
            assert d["essential_ransac"] in tpu["essential_ransac"]
        elif f == "ties":
            _inside(d, ties)
            assert d["topk_mode"] in ("block", "sort")
        else:
            assert 2 <= d["n"] <= 1100 and 2 <= d["m"] <= 1100 and 1 <= d["b"] <= 8
            assert 0.05 <= d["epsilon"] <= 1.0
        seen.add((f, d.get("hires")))
    assert {("flagship", True), ("flagship", False), ("akaze", True),
            ("akaze", False)} <= seen
    with pytest.raises(ValueError, match="unknown family"):
        soak.draws(0, 3, ("flagship", "dense"))


SMALL_DRAWS = {
    "flagship": dict(hires=False, h=97, w=131, max_keypoints=40, num_pairs=256,
                     sampling_mode="bilinear", binarize=True, soft_binarize=False,
                     with_angle=True, nms_radius=7, topk_mode="block", fused_detect=True,
                     streaming=True),
    "akaze": dict(hires=False, h=101, w=139, max_keypoints=24, num_pairs=256,
                  sampling_mode="nearest", binarize=False, soft_binarize=True, nms_radius=3,
                  topk_mode="block", akaze_num_scales=2, akaze_diffusion_iterations=3,
                  akaze_kappa=0.05, akaze_threshold=0.0005, akaze_nms_size=3,
                  streaming=True),
    "essential": dict(hires=True, h=121, w=163, max_keypoints=64, num_pairs=512,
                      sampling_mode="nearest", binarize=True, soft_binarize=True,
                      nms_radius=3, topk_mode="sort", essential_ransac=128, streaming=True),
    "ties": dict(tile_h=4, tile_w=3, reps_y=24, reps_x=36, quant_levels=8,
                 max_keypoints=64, nms_radius=3, topk_mode="block"),
    "sinkhorn": dict(b=4, n=37, m=101, dim=256, epsilon=0.05, bits=True),
}


@pytest.mark.parametrize("family", soak.FAMILIES)
def test_one_small_draw_per_family_cpu_against_cpu(family):
    draw = {"idx": 0, "family": family, "seed": 11, **SMALL_DRAWS[family]}
    errors, counts = soak.run_draw(draw, "cpu", "cpu")
    assert errors == []
    assert not any(counts.values())


def test_compare_catches_a_differing_device():
    """A perturbed side fails: keypoints of a ties draw, P of a Sinkhorn draw."""
    draw = {"idx": 0, "family": "ties", "seed": 2, **SMALL_DRAWS["ties"]}
    a, b = soak.run_on(draw, "cpu"), soak.run_on(draw, "cpu")
    b["outputs"][0] = b["outputs"][0].copy()
    b["outputs"][0][0, [0, 1]] = b["outputs"][0][0, [1, 0]]
    assert any("keypoints differ" in e for e in soak.compare(draw, a, b))
    draw = {"idx": 0, "family": "sinkhorn", "seed": 2, **SMALL_DRAWS["sinkhorn"]}
    a, b = soak.run_on(draw, "cpu"), soak.run_on(draw, "cpu")
    b["outputs"][0] = b["outputs"][0] + np.float32(3e-5)
    assert any("P differs" in e for e in soak.compare(draw, a, b))


# Draw 53 of seed 0 in ``chip_smoke.py`` phase 12: Gaussian descriptors at
# epsilon 0.073, where the kernel's dustbin corner parted from the plain
# version's by 5.7e-6 relative on an H100.
DRAW_53 = {"idx": 53, "family": "sinkhorn", "b": 7, "n": 484, "m": 678, "dim": 512,
           "epsilon": 0.07322631786859037, "bits": False, "seed": 1559338366}


def test_sinkhorn_corner_arbiter():
    """Past 2e-6 relative, the corner is arbitrated by float64: a side as
    close to float64 as float32 holds passes though the plain float32
    version is 3.5e-6 from it; a side 3e-5 off (over 5 float32 ulps of the
    log-domain scale, ~39 here) fails."""
    from onnx_image_processing_tpu_torch.kernels.sinkhorn_kernel import sinkhorn_core_plain
    from onnx_image_processing_tpu_torch.ops.sinkhorn import sinkhorn_inputs

    plain = soak.run_on(DRAW_53, "cpu")
    d1, d2 = (torch.from_numpy(x) for x in soak.sinkhorn_inputs(DRAW_53))
    inputs = [x.double() for x in sinkhorn_inputs(d1, d2, DRAW_53["epsilon"])]
    exact = {"outputs": [sinkhorn_core_plain(*inputs, 20).float().numpy()]}
    corner = np.abs(exact["outputs"][0] - plain["outputs"][0])[:, -1, -1]
    assert corner.max() / exact["outputs"][0][0, -1, -1] > soak.SINKHORN_CORNER_RTOL
    assert soak.compare(DRAW_53, exact, plain) == []
    off = {"outputs": [plain["outputs"][0].copy()]}
    off["outputs"][0][:, -1, -1] *= np.float32(1 + 3e-5)
    assert any("dustbin corner" in e for e in soak.compare(DRAW_53, off, plain))


def test_plain_sinkhorn_corner_within_half_the_arbiter_bound():
    """The arbiter's margin: on 12 Sinkhorn draws (seed 5) the plain
    float32 version's corner lies within half of CORNER_ULPS of float64
    (0.816 ulps at most when this was written)."""
    worst = max(soak.corner_ulps(d, soak.run_on(d, "cpu")["outputs"][0]).max()
                for d in soak.draws(5, 12, ("sinkhorn",)))
    assert worst <= soak.CORNER_ULPS / 2, worst


def test_expected_kernels_follow_the_routes():
    base = {"idx": 0, "seed": 0}
    fused = {**base, "family": "flagship", **SMALL_DRAWS["flagship"]}
    assert soak.expected_kernels(fused) == {"detect_frontend", "sparse_sampler", "sinkhorn"}
    unfused = {**fused, "fused_detect": False}
    assert soak.expected_kernels(unfused) == {"score_moments", "select_frontend",
                                              "sparse_sampler", "sinkhorn"}
    assert soak.expected_kernels({**unfused, "topk_mode": "sort"}) == {"score_moments",
                                                                      "sparse_sampler",
                                                                      "sinkhorn"}
    # K past the block grid takes the flat top-k.
    assert "select_frontend" not in soak.expected_kernels({**unfused, "max_keypoints": 5000})
    akaze = {**base, "family": "akaze", **SMALL_DRAWS["akaze"]}
    assert soak.expected_kernels(akaze) == {"akaze_ladder", "select_frontend",
                                            "sparse_sampler", "sinkhorn"}
    assert soak.expected_kernels({**base, "family": "sinkhorn"}) == {"sinkhorn"}


@pytest.mark.parametrize("ransac", [0, 128])
def test_expected_kernels_of_the_essential_family(ransac):
    """An essential draw's card run launches the solve's kernels: the
    minimum eigenvector and the projection, and with RANSAC the hypotheses."""
    draw = {"idx": 0, "seed": 0, "family": "essential", **SMALL_DRAWS["essential"],
            "essential_ransac": ransac}
    solve = {"min_eigvec9", "project_essential"} | ({"essential_hypotheses"} if ransac else set())
    assert solve <= soak.expected_kernels(draw)
    assert {"sparse_sampler", "sinkhorn"} <= soak.expected_kernels(draw)


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        soak.main(["--iters", "1"])
