"""Each cell's traffic drives a short window through the port's CPU path
and yields a result with the contract's keys; the command refuses to run
without a card."""

import json
import subprocess
import sys
import time

import pytest

from cardbench import bench
from cardbench.run import run_cell

from .conftest import ROOT

CELLS = [w["name"] for w in bench.load()["workloads"]]
# Long enough that a loaded CPU still answers a chunk of 8 small pairs inside it.
WINDOW_S = 4.0


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_short_window_on_the_cpu(cells, bench_json, name, trace, capsys):
    res = run_cell(cells[name], 2 ** 40 + 17, WINDOW_S, bool(trace), "cpu", time.time())
    print(json.dumps(res))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench.metrics_of(bench_json, section, name)}
    assert set(line["metrics"]) <= names
    if not trace:
        # Every end-to-end metric is measured on the host; a CPU run has them all.
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]


def test_the_command_refuses_without_a_card():
    p = subprocess.run([sys.executable, "cardbench/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
