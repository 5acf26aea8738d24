"""chip_smoke.py's two sources of a kernel's device time, side by side, on
one CUDA card.

    python3 benchmarks/port/device_time_sources.py [--traces N]

``chip_smoke.kernel_device_ms`` reads a kernel's device time from a
``torch.profiler`` trace and, after three traces without the kernel's rows,
from CUDA events around the call behind a spin kernel
(``events_device_ms``).  This script, for flash attention at the models'
four timing rows (bf16 and f32, musicgen-large's and jamba's prefill shapes)
and the tiled matmul at musicgen-large's six contractions in bf16 at block
128^3:

* each source's device ms (10 back-to-back calls) and their ratio;
* that a name no kernel has falls back (source ``cuda_events``);
* then ``--traces`` profiler sessions of 10 flash calls at musicgen-large's
  shape in one process, counting those that hold no flash_fwd row.

One JSON line each, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402

FA = importlib.import_module("repro_torch.kernels.flash_attention")
MM = importlib.import_module("repro_torch.kernels.matmul")


def trace_rows(fn, name: str, reps: int = 10) -> int:
    """The number of rows of ``name`` in one profiler trace of ``reps`` calls."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "source_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return sum(e.get("ph") == "X" and str(e.get("cat", "")).lower() in CS.DEVICE_CATS
               and name in e.get("name", "") for e in events)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("device_time_sources: no CUDA device", file=sys.stderr)
        return 1
    (ROOT / "build").mkdir(exist_ok=True)
    _build.build_all(["matmul", "flash_attention"])
    g = torch.Generator(device="cuda").manual_seed(CS.SEED)
    b, s, h, d = CS.FA_SHAPE
    calls = []
    for dt in (torch.bfloat16, torch.float32):
        for shape in ((b, s, h, h, d), CS.FA_JAMBA_SHAPE):
            bb, ss, hh, hkv, dd = shape
            q = torch.randn(bb, ss, hh, dd, generator=g, device="cuda").to(dt)
            k, v = (torch.randn(bb, ss, hkv, dd, generator=g, device="cuda").to(dt)
                    for _ in range(2))
            calls.append(({"kernel": "flash_attention", "bshkd": list(shape),
                           "dtype": str(dt).removeprefix("torch.")}, "flash_fwd",
                          lambda q=q, k=k, v=v: FA.flash_attention(q, k, v, causal=True)))
    for m, k, n in CS.CONTRACTIONS:
        a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        w = torch.randn(k, n, generator=g, device="cuda").bfloat16()
        calls.append(({"kernel": "tiled_matmul", "mkn": [m, k, n], "dtype": "bfloat16"},
                      "tc_matmul", lambda a=a, w=w: MM.matmul(a, w, bm=128, bk=128, bn=128)))
    for key, name, fn in calls:
        trace_ms, src = CS.kernel_device_ms(fn, name)
        events_ms = CS.events_device_ms(fn)
        print(json.dumps({**key, "trace_ms": trace_ms, "trace_source": src,
                          "events_ms": events_ms, "events_over_trace": events_ms / trace_ms}),
              flush=True)
    key, _, fn = calls[0]
    t = time.perf_counter()
    ms, src = CS.kernel_device_ms(fn, "no_such_kernel")
    print(json.dumps({"fallback": {**key, "device_ms": ms, "source": src,
                                   "seconds": time.perf_counter() - t}}), flush=True)
    if src != "cuda_events":
        raise SystemExit("a name no kernel has did not fall back to CUDA events")
    t = time.perf_counter()
    empty = sum(trace_rows(fn, "flash_fwd") == 0 for _ in range(args.traces))
    print(json.dumps({"traces": args.traces, "traces_without_flash_fwd": empty,
                      "seconds": time.perf_counter() - t}), flush=True)
    print(CS.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
