"""The tiled matmul's small-M (decode) plans, against the plans they were
chosen over, on one CUDA card.

    python3 benchmarks/port/matmul_decode_plans.py

Tensor-core route (bf16).  For M <= 64 the kernel splits K over
``k_split`` warpgroups of a CTA (2 at an n tile <= 128), each multiplying
its own 64-value chunk of a ring stage, and sums the partial tiles in
shared memory.  This script builds copies of ``csrc/matmul.cu`` with that
rule changed (1: one warpgroup walks K through a deep ring of one-chunk
stages; 4: four warpgroups at n tile 64) and times each at musicgen-large's
decode contractions (M = 4, bf16, both B layouts) at n tiles 64 and 128.

SIMT route (f32).  For M <= 16 the kernel splits K over ``1024 / tn``
thread groups of a CTA and sums their partial tiles in shared memory, at the
n tile the block's ``bn`` asks for (16-128) as long as 128 CTAs remain.  The
copy ``simt_no_cta_floor`` takes the n tile ``bn`` asks for whatever the CTA
count; ``simt_no_split`` takes the prefill plan instead (a 64-row tile, K
walked by the whole CTA).  All three are timed at the same f32 contractions
at blocks asking for n tiles 16, 32, 64 and 128.

Every case runs through the same wrapper, against ``torch.matmul`` on the
same operands (a yardstick only) and the byte bound (B read once at 3.35
TB/s).  Prints one JSON line per case and the card's name and power limit;
every launch is held against ``matmul_plain`` (1e-2 at bf16 out, 1e-5 at
f32).
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

MM = importlib.import_module("repro_torch.kernels.matmul")
RULE = "p.ks = M <= 64 && p.tn <= 128 ? 2 : 1;"
CASE2 = "    case 64 * 8 + 2: return launch_tc<64, 64, TB, 2>(p, a, s);\n"
CASE4 = "    case 64 * 8 + 4: return launch_tc<64, 64, TB, 4>(p, a, s);\n"
SIMT_RULE = "  if (M <= kDecodeM) {  // one m tile; K split over ks groups of tn / 4 threads"
SIMT_FLOOR = "cdiv(N, 2 * p.tn) >= kDecodeCtas"
# (M, K, N, B as (N, K)): wq/wk/wv/wo, gate/up, down, the logits
SHAPES = [(4, 2048, 2048, False), (4, 2048, 8192, False), (4, 8192, 2048, False),
          (4, 2048, 2048, True)]
BLOCKS = [(4, 64, 64), (4, 128, 128)]
F32_BLOCKS = [(1, 2048, 1), (4, 64, 32), (4, 64, 64), (4, 128, 128)]  # SIMT n tiles 16-128
HBM_BYTES_PER_S = 3.35e12


def variant_sources(out_dir: Path) -> dict:
    src = (_build.CSRC / "matmul.cu").read_text()
    if any(src.count(x) != 1 for x in (RULE, CASE2, SIMT_RULE, SIMT_FLOOR)):
        raise SystemExit("matmul.cu: a small-M rule or its launch case is not found once")
    texts = {"k_split_2": src, "k_split_1": src.replace(RULE, "p.ks = 1;"),
             "k_split_4": src.replace(RULE, "p.ks = M <= 64 ? (p.tn == 64 ? 4 : 2) : 1;")
                             .replace(CASE2, CASE2 + CASE4),
             "simt_no_split": src.replace(SIMT_RULE, "  if (false) {"),
             "simt_no_cta_floor": src.replace(SIMT_FLOOR, "true")}
    paths = {}
    for name, text in texts.items():
        paths[name] = out_dir / name / "matmul.cu"
        paths[name].parent.mkdir(parents=True, exist_ok=True)
        paths[name].write_text(text)
    return paths


def time_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("matmul_decode_plans: no CUDA device", file=sys.stderr)
        return 1
    paths = variant_sources(ROOT / "build" / "decode_plans")
    _build.build_all(list(paths.values()))
    flush = torch.empty(512 * 1024 * 1024 // 4, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    operands, f32_operands = [], []
    for (m, k, n, trans_b) in SHAPES:
        a = torch.randn(m, k, generator=g, device="cuda")
        b = torch.randn(*((n, k) if trans_b else (k, n)), generator=g, device="cuda")
        f32_operands.append((m, k, n, trans_b, a, b))
        operands.append((m, k, n, trans_b, a.bfloat16(), b.bfloat16()))
    for (m, k, n, trans_b, a, b) in operands + f32_operands:
        bt = b.t() if trans_b else b
        print(json.dumps({"mkn": [m, k, n], "trans_b": trans_b, "dtype": str(a.dtype),
                          "library_ms": time_ms(lambda: torch.matmul(a, bt), flush),
                          "bound_ms": (k * n + m * k + m * n) * a.element_size()
                          / HBM_BYTES_PER_S * 1e3}), flush=True)
    runs = [(name, path, operands, BLOCKS, 1e-2) for name, path in paths.items()
            if not name.startswith("simt")]
    runs += [(name, paths[src], f32_operands, F32_BLOCKS, 1e-5)
             for name, src in (("simt_split", "k_split_2"), ("simt_no_cta_floor", "simt_no_cta_floor"),
                               ("simt_no_split", "simt_no_split"))]
    for name, path, ops, blocks, limit in runs:
        with _build.substitute("matmul", path, MM._declare):
            for (m, k, n, trans_b, a, b) in ops:
                for bm, bk, bn in blocks:
                    kw = dict(bm=bm, bk=bk, bn=bn, trans_b=trans_b)
                    out = MM.matmul(a, b, **kw).float()
                    ref = MM.matmul_plain(a, b, **kw).float()
                    torch.cuda.synchronize()
                    err = ((out - ref).abs().max() / ref.abs().max()).item()
                    if not err <= limit:
                        raise SystemExit(f"{name} {(m, k, n)} {kw}: rel err {err}")
                    print(json.dumps({
                        "plan_rule": name, "mkn": [m, k, n], "trans_b": trans_b,
                        "dtype": str(a.dtype), "block": [bm, bk, bn],
                        "plan": MM.kernel_plan(m, k, n, bm, bk, bn, dtype=a.dtype),
                        "ms": time_ms(lambda: MM.matmul(a, b, **kw), flush),
                        "rel_err": err}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
