"""Where the RWKV-6 scan's time goes, phase by phase, on one CUDA card.

    python3 benchmarks/port/rwkv6_scan_phases.py

Builds a copy of ``csrc/rwkv6_scan.cu`` in which thread 0 of every CTA reads
``clock64()`` after each barrier that closes a phase and adds the cycles
since the previous one to a device counter, runs it at rwkv6-7b's prefill
shape ((B, S, H, N) = (4, 1024, 64, 64), bf16 r/k/v, chunk 128, a carried
state) and prints the mean SM cycles a pass-1 CTA spends in each phase
(staging, the sub-chunk cumsum, the pairs' products, the decays, r_dec's
store and v's widening, the walk over the sub-chunks) and a pass-2 CTA in each
chunk's phases, with the card's SM clock and its name and power limit.  A
phase's cycles include waiting at its closing barrier for the slowest warp.
The copy's output is held against the plain version (2e-4); the stamps add
barriers and atomics, so its time is not the kernel's (``chip_smoke.py``
and ``rwkv6_scan_passes.py`` time that).
"""
from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

RW = importlib.import_module("repro_torch.kernels.rwkv6_scan")
SHAPE, CHUNK, LIMIT = (4, 1024, 64, 64), 128, 2e-4

# (phase, the line that closes it, where its stamp goes)
PASS1 = [("staging", "  cp_async_wait<1>();  // logw, r and k landed (this thread's copies)\n"
                     "  __syncthreads();\n", "after"),
         ("cumsum", "  sub_cumsum<N>(C, GX, n_sub, tid);\n\n  // A[t][j]", "cumsum"),
         ("pairs", "  __syncthreads();  // raw r and k are read: their f32 rows may now be "
                   "overwritten\n", "after"),
         ("decay", "  cp_async_wait<0>();  // v landed\n  __syncthreads();\n", "after"),
         ("r_dec_v_widen", "  if constexpr (BF16) widen_rows<N>(V, LT, tid);\n\n  // The walk", "widen"),
         ("walk", "  // the chunk's increment, against its last row", "before")]
PASS2 = [("wait_r_dec", "    // every thread's copies landed, and the previous state update is done\n"
                        "    __syncthreads();\n", "after"),
         ("product", "    // ... every thread's, and every read of r_dec and of S_{c-1} is done\n"
                     "    __syncthreads();\n", "after"),
         ("store_y_and_state", "      SS[n * SP + j] = fmaf(DC[n], SS[n * SP + j], DS[n * SP + j]);\n"
                               "    }\n", "sync_after")]
P1_START = ("  const int tid = threadIdx.x;\n"
            "  const long long y_row = (long long)a.H * N;  // y and r_dec are (B, S, H, N) f32\n")
P2_START = "  float* const yb = y + (long long)b * a.S * y_row + h * N + j0;\n"


def stamp(k: int) -> str:
    return (f"  if (tid == 0) {{ const unsigned long long now = clock64(); "
            f"atomicAdd(&g_phase[{k}], now - t_prev); t_prev = now; }}\n")


def instrumented(out_dir: Path) -> Path:
    src = (_build.CSRC / "rwkv6_scan.cu").read_text()
    for anchor in [a for _, a, _ in PASS1 + PASS2] + [P1_START, P2_START]:
        if src.count(anchor) != 1:
            raise SystemExit(f"rwkv6_scan.cu: {anchor[:60]!r} is not found once")
    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long g_phase[16];\n", 1)
    for start in (P1_START, P2_START):
        src = src.replace(start, start + "  unsigned long long t_prev = clock64();\n")
    for k, (_, anchor, where) in enumerate(PASS1 + PASS2):
        if where == "after":
            new = anchor + stamp(k)
        elif where == "before":
            new = "  __syncthreads();\n" + stamp(k) + anchor
        elif where == "sync_after":
            new = anchor + "    __syncthreads();\n" + stamp(k)
        elif where == "cumsum":
            new = anchor.replace("\n\n", "\n" + stamp(k) + "\n", 1)
        else:  # "widen": the phase ends after the widening's own barrier
            new = anchor.replace("\n\n", "\n  __syncthreads();\n" + stamp(k) + "\n", 1)
        src = src.replace(anchor, new)
    src = src.replace('extern "C" {\n', 'extern "C" {\n'
                      "int looptune_phases(unsigned long long* out, int zero) {\n"
                      "  if (zero) { unsigned long long z[16] = {};\n"
                      "    return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z)); }\n"
                      "  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n", 1)
    path = out_dir / "phases" / "rwkv6_scan.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return path


def main() -> int:
    if not torch.cuda.is_available():
        print("rwkv6_scan_phases: no CUDA device", file=sys.stderr)
        return 1
    path = instrumented(ROOT / "build" / "rwkv6_phases")
    b, s, h, n = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = ((0.5 * torch.randn(b, s, h, n, generator=g, device="cuda")).bfloat16()
               for _ in range(3))
    logw = -torch.exp(torch.randn(b, s, h, n, generator=g, device="cuda") - 2.0)
    u = 0.3 * torch.randn(h, n, generator=g, device="cuda")
    s0 = 0.1 * torch.randn(b, h, n, n, generator=g, device="cuda")
    plan = RW.launch_plan(s, CHUNK, b=b, h=h, n=n, dtype=torch.bfloat16)
    with _build.substitute("rwkv6_scan", path, RW._declare) as lib:
        lib.looptune_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        y, st = RW.rwkv6_chunk_scan(r, k, v, logw, u, chunk=CHUNK, s0=s0)  # warm
        torch.cuda.synchronize()
        lib.looptune_phases(None, 1)
        y, st = RW.rwkv6_chunk_scan(r, k, v, logw, u, chunk=CHUNK, s0=s0)
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 16)()
        lib.looptune_phases(ctypes.cast(out, ctypes.c_void_p), 0)
    want_y, want_s = RW.rwkv6_chunk_scan_plain_heads(r, k, v, logw, u, chunk=CHUNK, s0=s0)
    ratio = max(((x - p).abs() / (LIMIT + LIMIT * p.abs())).max().item()
                for x, p in ((y, want_y), (st, want_s)))
    if not ratio <= 1.0:
        raise SystemExit(f"the instrumented copy is outside the {LIMIT} limit ({ratio})")
    n1, n2 = plan["pass1_ctas"], plan["pass2_ctas"] * plan["n_chunks"]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.split()[0]
    print(json.dumps({
        "bshn": list(SHAPE), "chunk": CHUNK, "plan": plan, "max_sm_clock_mhz": float(clock),
        "pass1_cycles_per_cta": {name: out[i] / n1 for i, (name, _, _) in enumerate(PASS1)},
        "pass2_cycles_per_cta_chunk": {name: out[len(PASS1) + i] / n2
                                       for i, (name, _, _) in enumerate(PASS2)},
        "ratio_to_limit": ratio}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
