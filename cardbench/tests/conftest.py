"""Tests of the benchmark's harness. They run on the CPU at small sizes,
through the port's CPU path; none needs the card."""

import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small(cell):
    """``cell`` at a size the CPU runs in a second: 96x128 images, 64
    keypoints, 12 pairs or 6 frames, the camera scaled to the image."""
    cfg = json.loads(json.dumps(cell.config))
    cfg["height"], cfg["width"] = 96, 128
    cfg["settings"]["max_keypoints"] = 64
    if "camera" in cfg:
        cfg["camera"] = {"fx": 102.4, "fy": 102.4, "cx": 64.0, "cy": 48.0}
    mix = dict(cell.traffic)
    if "pool" in mix:
        mix["pool"] = 12
    if "frames" in mix:
        mix["frames"] = 6
    return dataclasses.replace(cell, config=cfg, traffic=mix)


@pytest.fixture(scope="session")
def bench_json():
    from cardbench import bench

    return bench.load()


@pytest.fixture(scope="session")
def cells(bench_json):
    from cardbench import bench

    return {w["name"]: small(bench.cell(bench_json, w["name"])) for w in bench_json["workloads"]}
