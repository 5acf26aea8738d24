"""musicgen-large's six f32 contractions tuned and timed on one CUDA card, as
``chip_smoke.py``'s tune and timing phases do, for each checkout given.

    python3 benchmarks/port/f32_tune.py [ROOT ...]

For each ROOT (default: this checkout), in the order given and each in a
process of its own, it imports that checkout's ``chip_smoke.py`` (and so its
``repro_torch`` and its kernels, built into ROOT/build), tunes the six
contractions with ``LoopTuner(policy="search", backend="torch")`` (every
reward a timed launch of the tiled-matmul kernel on f32 operands, the SIMT
route) and times each at its tuned block and at 128^3 against
``torch.matmul`` and the bound.  To compare two commits on one card, unpack
the older one with ``git archive`` into a directory that ``.gitignore``
lists and give both as OLD NEW NEW OLD.  Prints that checkout's
``tune_entry``, ``tune``, ``timing_entry`` and ``timing`` lines, each with
its ``root``, then the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def one(root: Path) -> None:
    """Tune and time in this process, from ``root``'s checkout."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as cs

    cs.reset_launches()
    registry, _ = cs.phase_tune(lambda: cs.read_launches()["tiled_matmul"])
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cs.phase_timing(registry, torch.cuda.get_device_name(0), g)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(Path(sys.argv[2]).resolve())
        return 0
    roots = [Path(a).resolve() for a in sys.argv[1:]] or [Path(__file__).resolve().parents[2]]
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"root": str(root), **json.loads(line)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
