"""Read the two ends of each limit of an RWKV-6 prefill cell on the card, in
one process, as ``read_limits.py`` reads a decoder's: the program's numbers
over many seeds (short windows at the cell's own load: the numbers compared
do not depend on the window's length), both controls' over a few
(``yardstick.rwkv6.control``: fp8 products; logw and the WKV state in bf16),
the program's with each planted fault (``yardstick.rwkv6.dropped``:
ddlerp's LoRA term, the decay's LoRA), and, layer by layer on one sampled
wave of a seed, the program's errors as served and with its weights and
activations widened to f32 (:func:`layer_readings`).

    python3 portbench/tools/read_limits_rwkv6.py --workload rwkv6-7b.prefill-4x4096 \\
        --seconds 10 --seeds 11 12 ... --control-seeds 21 22 23 --fault-seeds 31 \\
        --layer-seeds 41

One JSON line a reading on standard output and in
``chiprun_out/readings/<cell>.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path[:0] = [str(HERE.parent), str(ROOT / "src")]


def layer_readings(cell, seed: int, dev, widen: bool) -> dict:
    """The program's prefill of the seed's first sampled wave against the
    reference, layer by layer: each scan against the reference's recurrence
    on the scan's own inputs (``scan``), the final WKV state (``s``) and the
    two carries (``xt``, ``xc``); then the last logits.  ``widen``: the same
    weights widened to f32 and the model run in f32 with no registry (plain
    products, TF32 off), which tells bf16 rounding from a fault of one
    site."""
    from repro_torch.models import steps as S
    from yardstick import compare as C
    from yardstick import port as P
    from yardstick import rwkv6 as R
    from yardstick import weights as W

    model, traffic = cell.model, cell.traffic
    B, L = traffic["clients"], traffic["prompt_len"]
    ref = cell.reference()
    ref.no_tf32()
    w = R.make(model, seed, dev)
    inputs = W.prompt(model, seed, R.sampled_waves(traffic, seed)[0], B, L, dev)
    if widen:
        run_model, registry = dict(model, dtype="float32"), None
        run_w = {k: t.float() for k, t in w.items()}
    else:
        run_model, run_w = model, w
        registry = P.schedule_registry(cell.config["schedules"], R.dense_keys(model, B * L),
                                       cell.name)
    params = R.port_params(run_w, run_model)
    prefill = S.make_prefill_step(R.model_config(run_model), traffic["max_len"],
                                  registry=registry)
    each = []
    with R.scan_checked(ref, {}, each):
        last, caches, _ = prefill(params, inputs)
    del params, prefill, run_w
    rows = []

    def on_state(l, s, xt, xc):
        c = caches[0]
        rows.append({"layer": l, "scan": each[l], "s": C.rel_err(c["s"][l], s),
                     "xt": C.rel_err(c["xt"][l], xt), "xc": C.rel_err(c["xc"][l], xc)})

    want = ref.prefill(model, w, inputs, on_state=on_state)
    return {"logits_rel": R.worst(*(C.rel_err(last[r], want[r]) for r in range(B))),
            "layers": rows}


def main(argv=None) -> int:
    import torch

    from yardstick import rwkv6 as R
    from yardstick import runner, spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--layer-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    out_dir = ROOT / "chiprun_out" / "readings"
    out_dir.mkdir(parents=True, exist_ok=True)

    with (out_dir / f"{cell.name}.jsonl").open("a") as sink:
        def emit(row):
            line = json.dumps(row)
            print(line, flush=True)
            sink.write(line + "\n")
            sink.flush()

        def program(seed):
            result = runner.run_cell(cell, seed, args.seconds, False, dev, time.perf_counter())
            torch.cuda.empty_cache()
            return result

        for seed in args.seeds:
            result = program(seed)
            emit({"side": "program", "seed": seed, "checks": result["checks"],
                  "metrics": result["metrics"], "attempted": result["attempted"],
                  "memory_peak_bytes": result["device"]["memory_peak_bytes"]})
        for seed in args.layer_seeds:
            for widen in (False, True):
                emit({"side": "layers:f32" if widen else "layers:program", "seed": seed,
                      **layer_readings(cell, seed, dev, widen)})
                torch.cuda.empty_cache()
        for seed in args.control_seeds:
            for lowered in R.CONTROLS:
                emit({"side": f"control:{lowered}", "seed": seed,
                      "numbers": R.control(cell, seed, dev, lowered)})
                torch.cuda.empty_cache()
        for seed in args.fault_seeds:
            for term in ("ddlerp", "decay_lora"):
                with R.dropped(term):
                    result = program(seed)
                emit({"side": f"fault:{term}", "seed": seed, "checks": result["checks"],
                      "correct": result["correct"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
