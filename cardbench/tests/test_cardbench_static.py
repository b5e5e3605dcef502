"""What the benchmark is made of: the work counts, its imports, its inputs,
and that a metric is added by adding a file and an entry."""

import ast
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from cardbench import bench, compare, inputs, peaks
from cardbench.run import Run, run_cell
from cardbench.work import ladder, sinkhorn

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "onnx_image_processing_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative imports
    as ``.``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".", 1)[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {".", "__future__", "contextlib", "dataclasses", "math",
                              "pathlib", "numpy", "torch"}


def test_sinkhorn_work_by_hand():
    # B=1, n=m=1024, 20 sweeps: 1025^2 entries, each 20*2*4 + 2 operations;
    # S and P of 1025^2 floats, two marginals of 1025.
    ops, nbytes = sinkhorn.work(1, 1024, 1024, 20)
    assert ops == 1025 * 1025 * 162
    assert nbytes == 4 * (2 * 1025 * 1025 + 2 * 1025)
    # B=8, n=512, m=300, 3 sweeps.
    ops, nbytes = sinkhorn.work(8, 512, 300, 3)
    assert ops == 8 * 513 * 301 * 26
    assert nbytes == 4 * (2 * 8 * 513 * 301 + 8 * 513 + 8 * 301)


def test_ladder_work_by_hand():
    # One 480x640 image, 3 scales of 3 FED steps, NMS 5, a 15-tap patch:
    # 3 * (75 + 13 + 10 + 120) operations a pixel; the image and 9 maps.
    ops, nbytes = ladder.work(1, 480, 640, 3, 3, 5, 15)
    assert ops == 480 * 640 * 3 * 218
    assert nbytes == 4 * 480 * 640 * 10
    ops, nbytes = ladder.work(2, 60, 80, 2, 1, 3, 7)
    assert ops == 2 * 60 * 80 * 2 * (25 + 13 + 6 + 56)
    assert nbytes == 4 * 2 * 60 * 80 * 7


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(67e12, 1) == pytest.approx(1.0)
    assert peaks.least_seconds(134e12, 3.35e12) == pytest.approx(2.0)


CAM = {"fx": 64.0, "fy": 64.0, "cx": 40.0, "cy": 32.0}
SCENE = json.loads((HERE / "traffic" / "vo_stream.json").read_text())["scene"]


@pytest.mark.parametrize("make", [
    lambda s: [a for p in inputs.texture_pairs(s, 3, 64, 80, 4, 12) for a in p],
    lambda s: [f for walk in inputs.scene_walks(s, 2, 4, 64, 80, CAM, SCENE) for f in walk]])
def test_inputs_repeat_for_a_seed_and_differ_across_seeds(make):
    big = 2 ** 40 + 123
    a, b, c = make(big), make(big), make(big + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert all(x.dtype == np.float32 and x.shape == (1, 1, 64, 80) for x in a)
    assert all(0 <= x.min() and x.max() <= 255 for x in a)


def test_every_seed_gets_the_same_shifts():
    def shifts(seed):
        out = []
        for a, b in inputs.texture_pairs(seed, 9, 64, 80, 4, 12, noise=0.0):
            out.append(next(s for s in range(4, 13)
                            if np.abs(np.roll(a[0, 0], s, 1) - b[0, 0]).max() < 1e-3))
        return out

    one, two = shifts(1), shifts(2)
    assert sorted(one) == sorted(two) == list(range(4, 13))


@pytest.mark.parametrize("motion", SCENE["motions"])
def test_every_walk_takes_the_same_steps_and_turns(motion):
    for seed in (3, 2 ** 33 + 1):
        _, centres, rotations = inputs.scene_sequence(seed, 0, 5, 64, 80, CAM, SCENE, motion)
        for (c0, r0), (c1, r1) in zip(zip(centres, rotations), zip(centres[1:], rotations[1:])):
            assert np.linalg.norm(c1 - c0) == pytest.approx(SCENE["step_m"])
            turn = np.degrees(np.arccos(np.clip((np.trace(r0.T @ r1) - 1) / 2, -1, 1)))
            assert turn == pytest.approx(SCENE["turn_deg"], rel=1e-6)


def test_a_sweep_never_jumps():
    order = inputs.sweep(5)
    assert order == [0, 1, 2, 3, 4, 3, 2, 1]
    cycle = order + order[:1]
    assert all(abs(a - b) == 1 for a, b in zip(cycle, cycle[1:]))


def test_a_metric_is_added_by_a_file_and_an_entry(tmp_path, cells):
    """A throwaway per-layer metric: its reader file beside the others and
    its entry in BENCHMARK.json; nothing else changes."""
    metrics = tmp_path / "metrics"
    shutil.copytree(HERE / "metrics", metrics)
    (metrics / "zz_requests.pairs.py").write_text(
        "MOVES = 'pairs_per_s'\n\n\ndef read(run):\n    return float(run.completed())\n")
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "zz_requests.pairs", "unit": "pairs", "better": "higher",
                              "source": "host_clock", "layer": "Serving (parallel/throughput.py)",
                              "moves": "pairs_per_s", "workloads": ["flagship.single"]})
    res = run_cell(cells["flagship.single"], 7, 3.0, True, "cpu", time.time(),
                   bench_json=spec, metrics_dir=metrics)
    assert res["metrics"]["zz_requests.pairs"]["value"] >= 1
    assert "zz_requests.pairs" not in run_cell(cells["flagship.single"], 7, 1.0, True, "cpu",
                                               time.time())["metrics"]


def test_every_metric_has_a_reader_and_every_cell_its_files(bench_json):
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        assert callable(bench.reader(m["name"]))
    for w in bench_json["workloads"]:
        cell = bench.cell(bench_json, w["name"])
        assert cell.chips == 1
        assert bench.traffic_kind(cell.traffic["kind"]).build
        assert set(cell.limits) <= set(compare.NUMBERS)


def test_readers_give_nothing_without_a_trace(cells):
    from cardbench.run import Log

    run = Run(cells["flagship.single"], Log(), 0, 10 ** 9, 1.0, "pairs", 1)
    for name in ("device_ms_per_pair", "roofline_pct.sinkhorn.pairs", "device_idle_pct.pairs",
                 "jit_host_ms.pairs"):
        assert bench.reader(name)(run) is None
