"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cells' cards.  The cell
is found by name in ``BENCHMARK.json``; its configuration, traffic, limits
and per-layer metric readers are files under ``portbench/`` (see
``yardstick/spec.py``).  The run makes its weights and inputs from
``--seed`` on the card, warms up the cell's own shapes (set-up, reported
as ``setup_s`` from the start of this process), measures for ``--seconds``
with tracing off, then, with ``--trace 1``, traces a few more steps of the
same traffic.  It prints each number ``correct`` compares beside its limit
on standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` (traced runs) and ``checks``.

It exits with another code than 0, printing no result, where there is no
card or fewer than the cell asks for, and where the process holds a module
of JAX or of the JAX package (``repro``) once the window has closed.  Every
build and kernel cache stays inside the checkout (``build/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]

#: top-level module names the run may not hold (JAX and the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    nothing that would load JAX."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "portbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "portbench" / "torch_extensions")
    os.environ.pop("REPRO_TORCH_BUILD_DIR", None)    # the kernels build in build/kernels
    os.environ.pop("LOOPTUNE_KERNEL_CACHE", None)    # no kernel store outside the checkout
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_environment()

    import torch

    from yardstick import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run holds modules it may not load: {found}", file=sys.stderr)
        return 3
    for line in runner.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
