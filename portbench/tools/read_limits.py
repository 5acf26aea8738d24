"""Read the two ends of each limit of a cell on the card, in one process:
the program's numbers over many seeds (short windows at the cell's own
load: the numbers compared do not depend on the window's length), the
control's over a few, and optionally a training fault's.

    python3 portbench/tools/read_limits.py --workload <cell> --seconds 10 \\
        --seeds 11 12 ... --control-seeds 21 22 23 [--fault half_batch]

One JSON line a reading on standard output and in
``chiprun_out/readings/<cell>.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path[:0] = [str(HERE.parent), str(ROOT / "src")]


def main(argv=None) -> int:
    import torch

    from yardstick import control, faults, runner, spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    out_dir = ROOT / "chiprun_out" / "readings"
    out_dir.mkdir(parents=True, exist_ok=True)
    sink = (out_dir / f"{cell.name}.jsonl").open("a")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    for seed in args.seeds:
        t = time.perf_counter()
        result = runner.run_cell(cell, seed, args.seconds, False, dev, t)
        emit({"side": "program", "seed": seed, "checks": result["checks"],
              "metrics": result["metrics"], "attempted": result["attempted"],
              "memory_peak_bytes": result["device"]["memory_peak_bytes"]})
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        numbers = control.CONTROLS[cell.traffic["kind"]](cell, seed, dev)
        emit({"side": "control", "seed": seed, "numbers": numbers})
        torch.cuda.empty_cache()
    for seed in args.fault_seeds:
        with getattr(faults, args.fault)():
            t = time.perf_counter()
            result = runner.run_cell(cell, seed, args.seconds, False, dev, t)
        emit({"side": f"fault:{args.fault}", "seed": seed, "checks": result["checks"]})
        torch.cuda.empty_cache()
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
