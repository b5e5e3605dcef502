"""What the metric readers take from the program's own trace
(``onnx_image_processing_tpu_torch/core/trace.py``): its spans and counts,
recorded while the harness's device trace is on, windowed to the traced
sub-window (or to the whole window where there is none) and put per
request answered there. A program without that module, or a run with no
such record in the window, reads None.

    python3 cardbench/program_spans.py --workload flagship.single --seed 7 --seconds 6

runs one traced run of a cell on the card and prints, as one JSON line, its
per-layer metrics and the device's idle time split first by the harness's
innermost span (``breakdown``'s rule) and then by the program's.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cardbench import trace  # noqa: E402


def records() -> list | None:
    """The program's records, or None where the program keeps none."""
    try:
        from onnx_image_processing_tpu_torch.core import trace as program_trace
    except ImportError:
        return None
    return program_trace.records()


def window(run) -> tuple[int, int]:
    return run.traced if run.traced is not None else (run.t0, run.t1)


def _in_window(run, names) -> list:
    recs = records()
    if not recs:
        return []
    lo, hi = window(run)
    return [r for r in recs if r.name in names and lo <= r.start < hi]


def ms_per_request(run, *names: str) -> float | None:
    """Summed host ms of the ``names`` spans that start in the window, per
    request answered in it."""
    recs = _in_window(run, names)
    n = run.completed(*window(run))
    if not recs or not n:
        return None
    return sum(r.end - r.start for r in recs) / 1e6 / n


def count_per_request(run, name: str) -> float | None:
    """Summed ``name`` counts in the window, per request answered in it."""
    recs = _in_window(run, (name,))
    n = run.completed(*window(run))
    if not recs or not n:
        return None
    return sum(r.n for r in recs) / n


def _labelled_idle(run, spans) -> list[tuple[str, int]]:
    """(innermost of ``spans`` at its middle, length) of each idle gap of the
    traced sub-window: the rule of ``trace.breakdown``."""
    lo, hi = run.traced
    starts, labels = trace._innermost(spans)
    out = []
    for s, e in trace.idle_gaps(run.events, lo, hi):
        i = bisect.bisect_right(starts, (s + e) // 2) - 1
        out.append((labels[i] if i >= 0 else "harness", e - s))
    return out


def _program_spans(run) -> list[tuple[str, int, int]]:
    lo, hi = run.traced
    return [(r.name, r.start, r.end) for r in records() or []
            if r.end > r.start and r.end > lo and r.start < hi]


def idle_ms_per_request(run, prefix: str) -> float | None:
    """Device idle ms per request answered in the traced sub-window, in the
    gaps whose middle falls where the innermost open program span's name
    starts with ``prefix``; None without a device trace or such a span."""
    if run.traced is None:
        return None
    spans = _program_spans(run)
    n = run.completed(*run.traced)
    if not n or not any(name.startswith(prefix) for name, _, _ in spans):
        return None
    return sum(ns for label, ns in _labelled_idle(run, spans)
               if label.startswith(prefix)) / 1e6 / n


def idle_split(run) -> dict:
    """Idle seconds of the traced sub-window by the harness's innermost span,
    then by the program's: {harness label: {program label: s}}."""
    both = zip(_labelled_idle(run, run.spans.items),
               _labelled_idle(run, _program_spans(run)))
    out: dict = defaultdict(lambda: defaultdict(int))
    for (outer, ns), (inner, _) in both:
        out[outer]["outside program spans" if inner == "harness" else inner] += ns
    return {k: {p: ns / 1e9 for p, ns in sorted(v.items(), key=lambda kv: -kv[1])}
            for k, v in sorted(out.items(), key=lambda kv: -sum(kv[1].values()))}


def main(argv=None) -> int:
    import argparse
    import json

    from cardbench import bench, run as runner

    t_start = runner.process_start()
    runner.configure_process()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    spec = bench.load()
    spec["per_layer"].append({"name": "zz_split", "workloads": [args.workload]})
    seen = {}
    real = bench.reader

    def reader(name, directory=bench.HERE / "metrics"):
        if name != "zz_split":
            return real(name, directory)

        def keep(run):
            seen["run"] = run
        return keep

    bench.reader = reader
    result = runner.run_cell(bench.cell(spec, args.workload), args.seed, args.seconds, True,
                             "cuda", t_start, bench_json=spec)
    run = seen["run"]
    lo, hi = window(run)
    n = run.completed(lo, hi)
    harness = {name: run.spans.total_ns(name, lo, hi) / 1e6 / n
               for name in sorted({name for name, _, _ in run.spans.items})}
    program = {name: ms_per_request(run, name)
               for name in sorted({r.name for r in records() or [] if r.end > r.start})}
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": result["correct"], "metrics": result["metrics"],
                      "device": result["device"], "answered_traced": n,
                      "answered": run.completed(), "harness_ms_traced": harness,
                      "program_ms_traced": program,
                      "idle_split": idle_split(run) if run.traced else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
