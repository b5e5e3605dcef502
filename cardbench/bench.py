"""``BENCHMARK.json`` and the files it names: a cell's configuration,
traffic mix and limits, and the reader of each of its metrics.

Everything is found by name, so a later change adds a configuration, a
traffic mix, a metric or a cell by adding files and entries only:
``configs/<config>.json`` (the file its ``configs`` entry names),
``traffic/<traffic>.json`` (whose ``kind`` names ``traffic/<kind>.py``),
``limits/<cell>.json`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["Cell", "HERE", "ROOT", "load", "cell", "metrics_of", "reader", "traffic_kind"]


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict    # the configuration's file
    traffic: dict   # the traffic mix's file
    limits: dict    # {number: limit} of the comparison that decides ``correct``


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def cell(bench: dict, name: str) -> Cell:
    """The cell ``name`` of ``bench`` with its files read."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r}; have {[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(name, int(entry["chips"]),
                json.loads((ROOT / conf["file"]).read_text()),
                json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
                json.loads((HERE / "limits" / f"{name}.json").read_text()))


def metrics_of(bench: dict, section: str, cell_name: str) -> list[dict]:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[section] if cell_name in m.get("workloads", [cell_name])]


def _module(path: Path):
    name = "cardbench_file_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, directory: Path = HERE / "metrics"):
    """``read(run)`` of the metric ``name`` (``metrics/<name>.py``): its
    value, or None where the run has nothing to read it from."""
    return _module(directory / f"{name}.py").read


def traffic_kind(kind: str):
    """The traffic module ``traffic/<kind>.py``."""
    return _module(HERE / "traffic" / f"{kind}.py")
