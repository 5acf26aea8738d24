"""Tune a configuration's prefill contractions on the card, once, and
commit the schedules into the configuration's file.

    python3 portbench/tools/make_schedules.py --workload <prefill cell> --budget-s 90

runs the port's own tuner, ``python -m repro_torch.launch.tune --full``,
at the cell's batch (clients), prompt length and cache length, and writes
the records of the cell's prefill keys (block, grid order, tuned GFLOPS,
the action trace) into ``schedules`` of the cell's configuration file,
with the command, the card, its power limit and the date.  The benchmark
serves these schedules as data: a later tuner change shows in the tune
cell, a later kernel change in the prefill cells.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def main(argv=None) -> int:
    from yardstick import counting as N
    from yardstick import spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--budget-s", type=float, default=90.0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    t = cell.traffic
    arch = cell.model["name"]
    with tempfile.TemporaryDirectory() as tmp:
        reg_path = os.path.join(tmp, "registry.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.tune", "--arch", arch, "--full",
               "--registry", reg_path, "--batch", str(t["clients"]),
               "--prompt-len", str(t["prompt_len"]), "--max-len", str(t["max_len"]),
               "--budget-s", str(args.budget_s), "--journal", "off", "--kernel-cache", "off"]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        subprocess.run(cmd, check=True, cwd=ROOT, env=env)
        table = json.loads(Path(reg_path).read_text())["entries"]
    needed = N.dense_keys(cell.model, t["clients"] * t["prompt_len"])
    entries = []
    for key, e in sorted(table.items()):
        m, k, n = map(int, e["structure_key"].split(":")[1].split("x"))
        dt = e["structure_key"].split(":")[2]
        if (m, k, n, dt) in needed:
            entries.append({"m": m, "k": k, "n": n, "dtype": dt, "block": e["block"],
                            "grid_order": e["grid_order"], "gflops": e["gflops"],
                            "actions": e["actions"]})
    missing = set(needed) - {(e["m"], e["k"], e["n"], e["dtype"]) for e in entries}
    if missing:
        raise SystemExit(f"the tune run left keys without a schedule: {sorted(missing)}")
    path = ROOT / next(c["file"] for c in spec.load_benchmark()["configs"]
                       if c["name"] == arch)
    config = json.loads(path.read_text())
    shown = ["python", "-m", "repro_torch.launch.tune"] + cmd[3:]
    shown[shown.index(reg_path)] = "<registry>"
    config["schedules"] = {
        "command": " ".join(shown), "card": card(),
        "date": datetime.date.today().isoformat(), "entries": entries}
    path.write_text(json.dumps(config, indent=1) + "\n")
    print(json.dumps(config["schedules"], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
