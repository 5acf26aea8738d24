"""Does ``chip_smoke.py``'s policy phase slow the musicgen-large serve that
follows it?  One process, one CUDA card:

    python3 benchmarks/port/policy_host_state.py

Builds the tiled-matmul and flash kernels, tunes the six contractions as
bf16 records (as phase ``model`` does), and serves musicgen-large at full
width with ``chip_smoke.SERVE``'s traffic in turns: twice before the
policy phase, once right after it, then twice after ``gc.collect()`` and
``torch.cuda.empty_cache()``.  Each ``serve`` line has the turn, the
host-timed prefill ms of each wave, the decode step p50, and the number of
objects the collector tracks; the last line is the card's name and power
limit.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def serve(turn: str, cfg, registry) -> None:
    from repro_torch.launch import serve as SV

    t0 = time.perf_counter()
    summary = SV.serve_once(cfg, seed=cs.SEED, registry=registry, device="cuda", **cs.SERVE)
    print(json.dumps({"phase": "serve", "turn": turn,
                      "prefill_ms_per_wave": summary["prefill_ms"],
                      "decode_step_p50_ms": summary["decode_step_p50_ms"],
                      "gc_tracked": len(gc.get_objects()),
                      "seconds": time.perf_counter() - t0}), flush=True)
    del summary
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("policy_host_state: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import LoopTuner, matmul_benchmark
    from repro_torch.kernels import _build

    _build.build_all(["matmul", "flash_attention"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    cfg = get_config("musicgen-large")
    n = len(cs.CONTRACTIONS)
    model_tuner = LoopTuner(policy="search", backend="torch", surrogate="off")
    model_tuner.tune_many([matmul_benchmark(*mkn) for mkn in cs.CONTRACTIONS],
                          dtypes=["bfloat16"] * n, weights=[1.0] * n,
                          budget_s=cs.TUNE_BUDGET_S * n, eval_budget=cs.TUNE_MAX_EVALS * n)
    registry = model_tuner.registry
    serve("before_1", cfg, registry)
    serve("before_2", cfg, registry)
    _, tune_rows = cs.phase_tune(lambda: cs.read_launches()["tiled_matmul"])
    cs.phase_policy(out_dir, tune_rows, torch.Generator(device="cuda").manual_seed(cs.SEED))
    serve("after_policy", cfg, registry)
    gc.collect()
    torch.cuda.empty_cache()
    serve("after_collect_1", cfg, registry)
    serve("after_collect_2", cfg, registry)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
