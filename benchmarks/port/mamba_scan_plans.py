"""The Mamba scan's design against the previous one and a variant, on one
CUDA card.

    python3 benchmarks/port/mamba_scan_plans.py

Three forms of ``looptune_mamba_scan``, each through the same wrapper and the
same plan (``launch_plan``):

* ``previous``: ``benchmarks/port/mamba_scan_previous.cu``, one thread a
  channel walking the tokens, each tile staged through registers between
  two barriers;
* ``current``: ``csrc/mamba_scan.cu``, two lanes a channel (N / 2 states
  each), a two-stage cp.async ring, one ex2.approx a term;
* ``four_lanes``: a copy of the current kernel with four lanes a channel
  (N / 4 states each, twice the warps, two shuffles a token).

At jamba's prefill shape ((B, S, C, N) = (4, 1024, 8192, 16), bf16 x, dt, B
and C, B and C strided views, a carried state) each form is held against
the plain version (2e-4) at the model's block (64, 128), then timed at that
block and at chip_smoke.py's MAMBA_SWEEP blocks: CUDA events, the median of
20 calls each after overwriting 512 MiB, and at the model's block the
profiler's mean device time over 10 calls.  The forms run in turns,
previous, current, four_lanes, four_lanes, current, previous, and each
form's two passes are both printed.  Last, the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmarks" / "port"))

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)
from mamba_scan_phases import BLOCK, LIMIT, SHAPE, inputs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

MS = importlib.import_module("repro_torch.kernels.mamba_scan")
LANES_LINE = "constexpr int kLanes = 2;"
LANES = {"previous": 1, "current": 2, "four_lanes": 4}  # threads a channel


def declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.looptune_mamba_scan.argtypes = [p] * 8 + [i] * 6 + [ll] * 8 + [i, p]
    lib.looptune_mamba_scan.restype = i


def sources() -> dict:
    src = (_build.CSRC / "mamba_scan.cu").read_text()
    if src.count(LANES_LINE) != 1:
        raise SystemExit(f"mamba_scan.cu: {LANES_LINE!r} is not found once")
    four = ROOT / "build" / "mamba_plans" / "mamba_scan.cu"
    four.parent.mkdir(parents=True, exist_ok=True)
    four.write_text(src.replace(LANES_LINE, "constexpr int kLanes = 4;"))
    return {"previous": ROOT / "benchmarks" / "port" / "mamba_scan_previous.cu",
            "current": _build.CSRC / "mamba_scan.cu", "four_lanes": four}


def main() -> int:
    if not torch.cuda.is_available():
        print("mamba_scan_plans: no CUDA device", file=sys.stderr)
        return 1
    paths = sources()
    _build.build_all(list(paths.values()))
    x, dt, a, bm, cm, h0 = inputs()
    flush = CS.flush_buffer()
    want = MS.mamba_scan_plain_model(x, dt, a, bm, cm,
                                     chunk=MS.launch_plan(SHAPE[1], SHAPE[2], *BLOCK)["l"], h0=h0)

    def call(block):
        return lambda: MS.mamba_scan(x, dt, a, bm, cm, chunk=block[0], bd=block[1], h0=h0)

    def plan(name, block):  # launch_plan's tile and channels; the form's own threads
        p = MS.launch_plan(SHAPE[1], SHAPE[2], *block)
        return {**p, "threads": p["cc"] * LANES[name]}

    for name in ("previous", "current", "four_lanes", "four_lanes", "current", "previous"):
        with _build.substitute("mamba_scan", paths[name], declare):
            y, h = call(BLOCK)()
            torch.cuda.synchronize()
            ratio = max(((o - p).abs() / (LIMIT + LIMIT * p.abs())).max().item()
                        for o, p in ((y, want[0]), (h, want[1])))
            if not ratio <= 1.0:
                raise SystemExit(f"{name}: outside the {LIMIT} limit ({ratio})")
            row = {"form": name, "bscn": list(SHAPE), "block": list(BLOCK),
                   "plan": plan(name, BLOCK), "ratio_to_limit": ratio,
                   "ms": CS.time_ms(call(BLOCK), flush, 20),
                   **dict(zip(("device_ms", "device_ms_source"),
                              CS.kernel_device_ms(call(BLOCK), "mamba_scan"))),
                   "sweep": [{"block": list(blk), "plan": plan(name, blk),
                              "ms": CS.time_ms(call(blk), flush, 20)} for blk in CS.MAMBA_SWEEP]}
        print(json.dumps(row), flush=True)
    print(CS.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
