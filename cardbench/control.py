"""The control of a cell's comparison: the plain reference computed with
TF32 products (the precision below the configurations' float32 with TF32
off) put in the program's place. It answers the requests a short closed-loop
run of the program answered, and is held to the cell's numbers and limits
against the float32 reference; it has to come out not correct. The same
run's program readings are printed beside it.

    python3 cardbench/control.py --workload akaze_vo.stream --seeds 11,12,13 --seconds 3

One JSON line per seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def control(cell, seed: int, seconds: float, device: str) -> dict:
    """The program's and the control's numbers on one seed's requests, each
    judged against the cell's limits."""
    from cardbench import bench, compare
    from cardbench.run import Log

    traffic = bench.traffic_kind(cell.traffic["kind"]).build(cell, seed, device)
    traffic.warm()
    log = Log()
    traffic.serve(time.perf_counter_ns() + int(seconds * 1e9), log)
    answered = [(k, a) for k, a in zip(log.keys, log.answers) if a is not None]
    traffic.close()
    by_key = compare.distinct(answered)
    low = {k: [w.answer] for k, w in traffic.reference(set(by_key), "tf32")}
    wants = list(traffic.reference(set(by_key), "fp32"))
    program = compare.numbers(by_key, wants)
    ctl = compare.numbers(low, wants)
    return {"cell": cell.name, "seed": seed, "requests": len(answered), "keys": len(by_key),
            "program": program, "program_correct": compare.judge(program, cell.limits)[0],
            "control": ctl, "control_correct": compare.judge(ctl, cell.limits)[0]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from cardbench.run import configure_process

    configure_process()
    import torch

    from cardbench import bench

    if not torch.cuda.is_available():
        print("cardbench control: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.cell(bench.load(), args.workload)
    for seed in args.seeds.split(","):
        print(json.dumps(control(cell, int(seed), args.seconds, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
