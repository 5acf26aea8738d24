"""Where the Mamba scan's time goes, phase by phase, on one CUDA card.

    python3 benchmarks/port/mamba_scan_phases.py

Builds copies of the current kernel (``csrc/mamba_scan.cu``) and of the
previous design (``benchmarks/port/mamba_scan_previous.cu``: one thread a
channel, tiles staged through registers between two barriers) in which
thread 0 of every CTA reads ``clock64()`` at the end of each phase of a tile
and adds the cycles since its previous stamp to a device counter.  Each runs
at jamba's prefill shape ((B, S, C, N) = (4, 1024, 8192, 16), bf16 x, dt, B
and C, B and C as strided views, a carried state, the model's block (64,
128)) and the script prints the mean SM cycles a CTA spends in each phase
over the whole scan:

* previous: ``staging`` (the tile's global loads and shared stores, through
  the barrier that ends them) and ``recurrence`` (the token loop with its y
  stores);
* current: ``wait`` (tile j's copies landing, and the barrier), ``issue``
  (tile j+1's cp.async copies), ``widen`` (B and C to f32, and its barrier)
  and ``recurrence`` (the token loop, which stores y in blocks of 8 tokens).

A second copy of each keeps the y stores out of the token loop (a running
sum, stored once): the difference of the two ``recurrence`` columns is the
stores' share.  A stamp is thread 0's view, so waiting for the other warps
shows in the phase that ends at a barrier.  The stamped copies (with their
stores) are held against the plain version (2e-4); the stamps add atomics,
so their times are not the kernel's (``mamba_scan_plans.py`` and
``chip_smoke.py`` time that).  Prints one JSON line per kernel and the card's
name and power limit.
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

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402

MS = importlib.import_module("repro_torch.kernels.mamba_scan")

SHAPE, BLOCK, LIMIT = CS.MAMBA_SHAPE, (CS.MAMBA_CHUNK, CS.MAMBA_BD), CS.MAMBA_LIMIT
OUT = ROOT / "build" / "mamba_phases"

# per kernel: where the clock starts (between A and B), each phase's end
# (between A and B), the y store and what replaces it, and where the
# replacement's sum is stored once
FORMS = {
    "previous": {
        "path": ROOT / "benchmarks" / "port" / "mamba_scan_previous.cu",
        "start": ("  float* yb = y + (long long)b * p.S * p.C + ch;\n",
                  "\n  for (int t0 = 0; t0 < p.S; t0 += L) {"),
        "phases": [("staging", "    __syncthreads();\n", "    if (live) {\n      for (int i"),
                   ("recurrence", "        yb[(long long)(t0 + i) * p.C] = acc;\n      }\n    }\n",
                    "  }\n  if (live) {")],
        "store": [("        yb[(long long)(t0 + i) * p.C] = acc;", "        ysum += acc;")],
        "final": "    for (int n = 0; n < N; ++n) h_out[((long long)b * p.C + ch) * N + n] = h[n];\n",
        "final_store": "    yb[0] = ysum;\n",
    },
    "current": {
        "path": _build.CSRC / "mamba_scan.cu",
        "start": ("  stage_rows_of(0, 0, min(L, p.S));\n  cp_async_commit();\n",
                  "  for (int j = 0; j < n_tiles; ++j) {"),
        "phases": [("wait", "    __syncthreads();\n", "\n    const T* const X"),
                   ("issue", "      stage_rows_of(j + 1, 0, min(L, p.S - t0 - L));\n"
                             "    cp_async_commit();\n", "    const float* Bf;"),
                   ("widen", "      __syncthreads();\n", "      Bf = BCf;"),
                   ("recurrence", "    if (len % 8) store_y(t0 + len - len % 8, len % 8);\n",
                    "  }\n  cp_async_wait<0>();")],
        "store": [("      if (g == 0) Yw[(i % 8) * kCPW + cl % kCPW] = acc;", "      ysum += acc;"),
                  ("      if (i % 8 == 7) store_y(t0 + i - 7, 8);\n", ""),
                  ("    if (len % 8) store_y(t0 + len - len % 8, len % 8);\n", "")],
        "final": "    for (int n = 0; n < NS; ++n) h_out[((long long)b * p.C + ch) * N + n0 + n] = h[n];\n",
        "final_store": "    if (g == 0) yb[0] = ysum;\n",
    },
}


def stamp(k: int) -> str:
    return (f"  if (threadIdx.x == 0) {{ const unsigned long long now = clock64(); "
            f"atomicAdd(&g_phase[{k}], now - t_prev); t_prev = now; }}\n")


def between(src: str, a: str, b: str, text: str) -> str:
    if src.count(a + b) != 1:
        raise SystemExit(f"{a.strip()[:50]!r} + {b.strip()[:30]!r} is not found once")
    return src.replace(a + b, a + text + b)


def instrumented(name: str, form: dict, stores: bool) -> Path:
    src = form["path"].read_text()
    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long g_phase[8];\n", 1)
    src = between(src, *form["start"], "  unsigned long long t_prev = clock64();\n"
                                        "  float ysum = 0.f;\n")
    for k, (_, a, b) in enumerate(form["phases"]):
        src = between(src, a, b, stamp(k))
    if not stores:
        for old, new in form["store"]:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: {old.strip()!r} is not found once")
            src = src.replace(old, new)
        src = between(src, form["final"], "", form["final_store"])
    src = src.replace('extern "C" {\n', 'extern "C" {\n'
                      "int looptune_phases(unsigned long long* out, int zero) {\n"
                      "  if (zero) { unsigned long long z[8] = {};\n"
                      "    return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z)); }\n"
                      "  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n", 1)
    path = OUT / f"{name}_{'stores' if stores else 'no_stores'}" / "mamba_scan.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return path


def declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.looptune_mamba_scan.argtypes = [p] * 8 + [i] * 6 + [ll] * 8 + [i, p]
    lib.looptune_mamba_scan.restype = i
    lib.looptune_phases.argtypes = [p, i]
    lib.looptune_phases.restype = i


def inputs(seed: int = 0) -> tuple:
    """chip_smoke.py's inputs at jamba's prefill shape: bf16 x, dt, B and C
    (B and C strided views of one projection), f32 a and a carried state."""
    return CS.mamba_inputs((*SHAPE, *BLOCK, torch.bfloat16, True), seed)


def main() -> int:
    if not torch.cuda.is_available():
        print("mamba_scan_phases: no CUDA device", file=sys.stderr)
        return 1
    paths = {(name, stores): instrumented(name, form, stores)
             for name, form in FORMS.items() for stores in (True, False)}
    _build.build_all(list(paths.values()))
    x, dt, a, bm, cm, h0 = inputs()
    plan = MS.launch_plan(SHAPE[1], SHAPE[2], *BLOCK)
    n_ctas = plan["n_ctas"] * SHAPE[0]
    want = MS.mamba_scan_plain_model(x, dt, a, bm, cm, chunk=plan["l"], h0=h0)
    clock = CS.nvidia_smi_line("clocks.max.sm").split()[0]
    for name, form in FORMS.items():
        row = {"kernel": name, "bscn": list(SHAPE), "block": list(BLOCK), "plan": plan,
               "ctas": n_ctas, "max_sm_clock_mhz": float(clock)}
        for stores in (True, False):
            with _build.substitute("mamba_scan", paths[(name, stores)], declare) as lib:
                MS.mamba_scan(x, dt, a, bm, cm, chunk=BLOCK[0], bd=BLOCK[1], h0=h0)  # warm
                torch.cuda.synchronize()
                lib.looptune_phases(None, 1)
                y, h = MS.mamba_scan(x, dt, a, bm, cm, chunk=BLOCK[0], bd=BLOCK[1], h0=h0)
                torch.cuda.synchronize()
                out = (ctypes.c_ulonglong * 8)()
                lib.looptune_phases(ctypes.cast(out, ctypes.c_void_p), 0)
            key = "cycles_per_cta" if stores else "cycles_per_cta_no_y_stores"
            row[key] = {ph: out[k] / n_ctas for k, (ph, _, _) in enumerate(form["phases"])}
            if stores:
                row["ratio_to_limit"] = max(
                    ((o - p).abs() / (LIMIT + LIMIT * p.abs())).max().item()
                    for o, p in ((y, want[0]), (h, want[1])))
                if not row["ratio_to_limit"] <= 1.0:
                    raise SystemExit(f"{name}: the stamped copy is outside the {LIMIT} limit")
        row["y_store_cycles_per_cta"] = (row["cycles_per_cta"]["recurrence"]
                                         - row["cycles_per_cta_no_y_stores"]["recurrence"])
        print(json.dumps(row), flush=True)
    print(CS.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
