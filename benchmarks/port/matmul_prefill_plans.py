"""The tiled matmul's bf16 prefill launches (M > 64): the persistent,
warp-specialised kernel against its previous design, on one CUDA card.

    python3 benchmarks/port/matmul_prefill_plans.py           # checks, then timings
    python3 benchmarks/port/matmul_prefill_plans.py --check   # checks only

Two forms of the matmul library, each through the same wrapper:

* ``previous``: ``benchmarks/port/matmul_previous.cu``, the library before
  ``tc_matmul_ws``: every bf16 launch on ``tc_matmul`` (one CTA a tile, one
  warpgroup a 64-row tile, every thread issuing cp.async loads, a 4-stage
  ring and a barrier a k step);
* ``current``: ``csrc/matmul.cu``.

Cases, each at its model's form (B as (K, N) with bf16 out; the logits as
(N, K) with f32 out):

* the prefill schedules committed in ``portbench/configs/`` (M = 8,192),
  and the logits at musicgen-large's and phi3-mini's heads;
* the tune cell's 12 contractions (``portbench/traffic/tune-prefill.json``:
  m 1,024-8,192 by musicgen-large's three (k, n)) at the schedules a search
  picks for them on this card (``LoopTuner``, policy "search", as the cell
  tunes them; the search times the current kernel);
* the probe: 128 x 256 tiles (block (128, 256, 256); the plan lowers its
  four k chunks a stage to one, since three stages of four would not fit)
  and 128 x 128 tiles (block 128^3) at the committed shapes.

First both forms are built (one ``nvcc`` each, at once) and every case of
each is checked against ``matmul_plain`` (one f32 product: 1e-2 with bf16
out, 3e-5 with f32 out, the route's limits).  Then each case is timed in
turns: previous, current, current, previous; a pass is the median of 20
launches, each after overwriting 512 MiB (CUDA events).  Beside each case:
the bound (max of 2mkn / 989 TFLOP/s and the bytes of A and B read once and
C written once / 3.35 TB/s), TFLOP/s, and ``torch.matmul`` on the same
operands as the yardstick only (it is no part of the port).  Every line is
printed and appended to ``chiprun_out/matmul_prefill_plans.jsonl``; last,
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

MM = importlib.import_module("repro_torch.kernels.matmul")
PREVIOUS = ROOT / "benchmarks" / "port" / "matmul_previous.cu"
CONFIGS = ROOT / "portbench" / "configs"
TUNE_TRAFFIC = ROOT / "portbench" / "traffic" / "tune-prefill.json"
OUT = ROOT / "chiprun_out" / "matmul_prefill_plans.jsonl"
PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
PROBES = {"probe_128x256": (128, 256, 256), "probe_128x128": (128, 128, 128)}
LIMITS = {torch.bfloat16: 1e-2, torch.float32: 3e-5}


def emit(row: dict) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def committed_cases() -> list:
    """(name, (m, k, n), block, grid order, trans_b, out dtype): each
    committed schedule as a dense site, and the logits' form where the
    schedule's (k, n) is the model's (d_model, vocab)."""
    from repro_torch.kernels.ops import _entry_schedule

    cases = []
    for name in ("musicgen-large", "phi3-mini-3.8b"):
        cfg = json.loads((CONFIGS / f"{name}.json").read_text())
        model = cfg["model"]
        for e in cfg["schedules"]["entries"]:
            block, order = _entry_schedule(e)
            mkn, blk = (e["m"], e["k"], e["n"]), (block["m"], block["k"], block["n"])
            cases.append((f"{name} dense", mkn, blk, order, False, torch.bfloat16))
            if (e["k"], e["n"]) == (model["d_model"], model["vocab"]):
                cases.append((f"{name} logits", mkn, blk, order, True, torch.float32))
    return cases


def tune_cases() -> list:
    """The tune cell's contractions at the blocks a search picks on this
    card, as the cell tunes them."""
    from repro_torch.core.backend import make_backend
    from repro_torch.core.loop_ir import matmul_benchmark
    from repro_torch.core.registry import ScheduleRegistry
    from repro_torch.core.tuner import LoopTuner
    from repro_torch.kernels.ops import _entry_schedule

    traffic = json.loads(TUNE_TRAFFIC.read_text())
    backend = make_backend("torch", device=torch.device("cuda"), seed=0)
    cases = []
    for m in traffic["m"]:
        for k, n in traffic["kn"]:
            reg = ScheduleRegistry()
            LoopTuner(backend=backend, registry=reg, policy="search").tune(
                matmul_benchmark(m, k, n), "mm", dtype=traffic["dtype"],
                budget_s=traffic["budget_s"], max_evals=traffic["max_evals"])
            block, order = _entry_schedule(reg.get("mm", (m, k, n), dtype=traffic["dtype"]))
            cases.append(("tune", (m, k, n), (block["m"], block["k"], block["n"]), order, False,
                          torch.bfloat16))
    return cases


def probe_cases(committed: list) -> list:
    return [(f"{probe} {name}", mkn, blk, order, trans_b, odt)
            for (name, mkn, _, order, trans_b, odt) in committed
            for probe, blk in PROBES.items()]


def operands(mkn, trans_b, seed: int):
    m, k, n = mkn
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
    b = torch.randn(*((n, k) if trans_b else (k, n)), generator=g, device="cuda").bfloat16()
    return a, b


def launch(case, a, b):
    _, _, (bm, bk, bn), order, trans_b, odt = case
    return MM.matmul(a, b, bm=bm, bk=bk, bn=bn, grid_order=order, out_dtype=odt,
                     trans_b=trans_b)


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
    return statistics.median(times)


def bound_ms(mkn, odt) -> float:
    m, k, n = mkn
    byts = (m * k + k * n) * 2 + m * n * (4 if odt == torch.float32 else 2)
    return max(2 * m * k * n / PEAK_FLOPS, byts / HBM_BYTES_PER_S) * 1e3


def check(forms: dict, cases: list) -> None:
    """Every case of every form against the plain version."""
    for i, case in enumerate(cases):
        a, b = operands(case[1], case[4], i)
        ref = MM.matmul_plain(a, b, bk=case[1][1], out_dtype=torch.float32, trans_b=case[4])
        for form, path in forms.items():
            with _build.substitute("matmul", path, MM._declare):
                out = launch(case, a, b)
                torch.cuda.synchronize()
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            row = {"check": form, "case": case[0], "mkn": list(case[1]), "block": list(case[2]),
                   "order": case[3], "trans_b": case[4], "out": str(case[5]), "rel_err": err,
                   "limit": LIMITS[case[5]]}
            if form == "current":
                row["plan"] = MM.kernel_plan(*case[1], *case[2], case[3], dtype=torch.bfloat16)
            emit(row)
            if not err <= LIMITS[case[5]]:
                raise SystemExit(f"{form} {case}: rel err {err} over {LIMITS[case[5]]}")


def timings(forms: dict, cases: list) -> None:
    flush = torch.empty(512 * 1024 * 1024 // 4, device="cuda")
    turns = ["previous", "current", "current", "previous"]
    for i, case in enumerate(cases):
        a, b = operands(case[1], case[4], i)
        bt = b.t() if case[4] else b
        lib_ms = time_ms(lambda: torch.matmul(a, bt).to(case[5]), flush)
        ms = {form: [] for form in forms}
        for form in turns:
            with _build.substitute("matmul", forms[form], MM._declare):
                ms[form].append(time_ms(lambda: launch(case, a, b), flush))
        m, k, n = case[1]
        med = {form: statistics.median(v) for form, v in ms.items()}
        emit({"case": case[0], "mkn": [m, k, n], "block": list(case[2]), "order": case[3],
              "trans_b": case[4], "out": str(case[5]),
              "plan": MM.launch_plan(m, k, n, *case[2], case[3], dtype=torch.bfloat16),
              "ms": med, "passes_ms": ms, "bound_ms": bound_ms(case[1], case[5]),
              "tflops": {f: 2 * m * k * n / (v * 1e-3) / 1e12 for f, v in med.items()},
              "roofline_pct": {f: 100 * bound_ms(case[1], case[5]) / v for f, v in med.items()},
              "library_ms": lib_ms})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true", help="build and check only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("matmul_prefill_plans: no CUDA device", file=sys.stderr)
        return 1
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("")
    forms = {"previous": PREVIOUS, "current": _build.CSRC / "matmul.cu"}
    _build.build_all(list(forms.values()))
    committed = committed_cases()
    cases = committed + probe_cases(committed)
    check(forms, cases)
    if args.check:
        return 0
    tuned = tune_cases()
    check(forms, tuned)
    timings(forms, committed + tuned + probe_cases(committed))
    emit({"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True).stdout.strip().splitlines()[0]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
