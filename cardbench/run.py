"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 cardbench/run.py --workload flagship.serve --seed 7 --seconds 15 --trace 0

Set-up (process start to the first timed request: imports, the kernels'
build or load from ``build/kernels/``, the program's modules, the seeded
input pool, the capture and warm-up of the cell's own shapes) is
``setup_s``. Then the cell's traffic runs closed-loop for ``--seconds``;
requests still in flight when the window closes are answered before the
traffic returns, and judged, but only those answered inside it count. With ``--trace 1`` the harness
records its spans around its calls into the program over the whole window
and traces the card over a fixed sub-window, and prints the per-layer
metrics; with ``--trace 0`` the end-to-end metrics. After the window the
program is dropped and the plain reference answers the same requests on the
card; the comparison's numbers and limits are printed last on standard
error, and under ``checks`` last in the result line. The last line of
standard output is the result, one JSON object.

Exits non-zero, printing no result, without a CUDA device (or fewer than the
cell asks for), or when the JAX package, JAX or Flax is loaded at the end.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))


def configure_process() -> None:
    """One process with few host threads, and every cache inside the
    checkout: compiled bytecode too (the first run in a checkout writes it,
    ~45 MB; it halves the import and first-call time of every later run).
    Called before anything imports numpy or torch."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(_ROOT / "build" / "pycache")
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "onnx_image_processing_tpu")


def process_start() -> float:
    """``time.time()`` at which this process started (from /proc; the
    import of this module where /proc is absent)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


class Log:
    """The requests of a run: each key handed to the program, when, and the
    answer and when it came (``perf_counter_ns``). ``spans`` is a
    :class:`trace.Spans` in a traced run, else None; ``tick`` lets the
    harness start and stop the device trace between requests."""

    def __init__(self, spans=None, tick=None):
        self.keys: list = []
        self.handed: list[int] = []
        self.done: list[int | None] = []
        self.answers: list = []
        self.spans = spans
        self.tick = tick or (lambda: None)

    def hand(self, key) -> int:
        self.keys.append(key)
        self.handed.append(time.perf_counter_ns())
        self.done.append(None)
        self.answers.append(None)
        return len(self.keys) - 1

    def answer(self, rid: int, answer) -> None:
        self.done[rid] = time.perf_counter_ns()
        self.answers[rid] = answer


class Run:
    """What the metric readers read: the window, the requests, set-up, the
    traffic's unit and batch, the configuration, and in a traced run the
    spans, the device events and the traced sub-window."""

    def __init__(self, cell, log: Log, t0: int, t1: int, setup_s: float, unit: str,
                 pairs_per_call: int, device_trace=None):
        self.config = cell.config
        self.log = log
        self.t0, self.t1 = t0, t1
        self.seconds = (t1 - t0) / 1e9
        self.setup_s = setup_s
        self.unit = unit
        self.pairs_per_call = pairs_per_call
        self.spans = log.spans
        self.events = device_trace.events if device_trace is not None else []
        self.traced = device_trace.window if device_trace is not None else None

    def latencies_ms(self, lo: int | None = None, hi: int | None = None) -> list[float]:
        """Latency of every request answered in [lo, hi] (default: the window)."""
        lo = self.t0 if lo is None else lo
        hi = self.t1 if hi is None else hi
        return [(d - h) / 1e6 for h, d in zip(self.log.handed, self.log.done)
                if d is not None and lo <= d <= hi]

    def completed(self, lo: int | None = None, hi: int | None = None) -> int:
        return len(self.latencies_ms(lo, hi))


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, wrap=None, bench_json: dict | None = None,
             metrics_dir: Path | None = None) -> dict:
    """One run of ``cell`` on ``device``; returns the result object.
    ``wrap``, for tests, takes the traffic object after its build and may
    replace what it calls; ``bench_json`` and ``metrics_dir`` stand in for
    ``BENCHMARK.json`` and ``metrics/``."""
    import torch

    from cardbench import bench, compare
    from cardbench import trace as tracing

    kind = bench.traffic_kind(cell.traffic["kind"])
    traffic = kind.build(cell, seed, device)
    if wrap is not None:
        wrap(traffic)
    traffic.warm()
    if device != "cpu":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()

    spans = tracing.Spans() if trace else None
    dev_trace = tracing.DeviceTrace() if trace and device != "cpu" else None
    window_ns = int(seconds * 1e9)
    t0 = time.perf_counter_ns()
    setup_s = time.time() - t_start
    t1 = t0 + window_ns
    trace_at = t0 + int(min(1.0, 0.25 * seconds) * 1e9)
    trace_until = trace_at + int(min(2.0, 0.5 * seconds) * 1e9)
    state = {"on": False, "done": False}

    def tick():
        if dev_trace is None or state["done"]:
            return
        now = time.perf_counter_ns()
        if not state["on"] and now >= trace_at:
            dev_trace.start()
            state["on"] = True
        elif state["on"] and now >= trace_until:
            dev_trace.stop()
            state["on"], state["done"] = False, True

    log = Log(spans, tick)
    traffic.serve(t1, log)
    if state["on"]:
        dev_trace.stop()
    if device != "cpu":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    run = Run(cell, log, t0, t1, setup_s, traffic.unit, traffic.pairs_per_call,
              dev_trace if dev_trace is not None and dev_trace.window else None)
    attempted = sum(1 for h in log.handed if h < t1)
    missing = sum(1 for d in log.done if d is None)
    answered = [(k, a) for k, a in zip(log.keys, log.answers) if a is not None]

    traffic.close()
    gc.unfreeze()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    by_key = compare.distinct(answered)
    values = compare.numbers(by_key, traffic.reference(set(by_key), "fp32"), missing)
    correct, checks = compare.judge(values, cell.limits)

    bench_json = bench.load() if bench_json is None else bench_json
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics_of(bench_json, section, cell.name):
        v = bench.reader(m["name"], metrics_dir or bench.HERE / "metrics")(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if device == "cpu":
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
               "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": missing,
              "metrics": metrics, "device": dev}
    if run.traced is not None:
        lo, hi = run.traced
        dev["busy_s"] = tracing.busy_ns(run.events, lo, hi) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        dev["power_limit"] = _power_limit()
        result["breakdown"] = tracing.breakdown(run.events, spans, lo, hi)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_start = process_start()
    configure_process()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from cardbench import bench

    cell = bench.cell(bench.load(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cardbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    loaded = sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"cardbench: the process holds {loaded}; the benchmark measures the PyTorch "
              "port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
