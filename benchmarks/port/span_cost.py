"""What the port's spans (``repro_torch.tracing``) cost, and what they read,
on one CUDA card.

    python3 benchmarks/port/span_cost.py [--phase cost,tune,train] [--pairs 6]

* ``cost``: microseconds a span on the host, off (nothing recording), on
  inside ``recording()`` (host only, and ``device=True`` with its two CUDA
  events) and on under ``torch.profiler`` (with ``record_function``),
  beside a bare ``with`` of a null context.
* ``tune``: the tune cell's traced window (its 12 bf16 contractions, 320
  evaluations a search) in turns, three times over: with nothing
  recording, under the profiler with the tuner's spans switched off (the
  window the parent commit traces), under the profiler, and inside
  ``recording()``.  Each turn's wall a measurement; under the recorders the
  ``measure.reward`` spans against the executor's measurements, and
  ``measure_ms_per_eval.tune`` and ``search_host_ms_per_eval.tune`` as the
  benchmark's readers compute them.
* ``train``: musicgen-large's training step at 8 x 1,024 as the train cell
  builds it: the wall of untraced steps, then ``--pairs`` times over the
  device and host seconds of each span a step inside ``recording()``
  without a profiler and under the profiler, the pair's order alternating,
  with ``adamw_roofline.train`` from each; last, each pair's ratio of
  ``optim.adamw``'s device time under the profiler to that without it
  (the profiler's inflation) and their median.

One JSON line a reading, also written to ``chiprun_out/span_cost.jsonl``,
then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src")]

from repro_torch import tracing  # noqa: E402
from yardstick import spec  # noqa: E402

OUT = ROOT / "chiprun_out" / "span_cost.jsonl"
ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def emit(**row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    with OUT.open("a") as f:
        f.write(line + "\n")


def reader(name: str):
    path = spec.BENCH_DIR / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def per_span_us(n: int, device: bool = False) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with tracing.span("cost", device=device):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def phase_cost() -> None:
    torch.zeros(1, device="cuda")
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with contextlib.nullcontext():
            pass
    bare = (time.perf_counter() - t0) / n * 1e6
    off = per_span_us(n)
    with tracing.recording():
        host = per_span_us(20_000)
        dev = per_span_us(5_000, device=True)
    tracing.spans()
    with profile(activities=ACTS):
        prof_host = per_span_us(5_000)
        prof_dev = per_span_us(2_000, device=True)
    tracing.spans()
    emit(phase="cost", us_null_with=bare, us_off=off, us_recording=host,
         us_recording_device=dev, us_profiler=prof_host, us_profiler_device=prof_dev)


def phase_tune() -> None:
    from repro_torch.core import measure as CM
    from repro_torch.core import torch_backend as CB
    from repro_torch.core import tuner as CT
    from repro_torch.core.backend import make_backend
    from repro_torch.core.loop_ir import matmul_benchmark
    from repro_torch.core.registry import ScheduleRegistry
    from repro_torch.core.tuner import LoopTuner

    cell = spec.load_cell("musicgen-large.tune-prefill")
    t = cell.traffic
    mkns = [(m, k, n) for m in t["m"] for k, n in t["kn"]]
    backend = make_backend("torch", device=torch.device("cuda", 0), seed=7)
    for mkn in mkns:
        LoopTuner(backend=backend, registry=ScheduleRegistry(), policy="default").tune(
            matmul_benchmark(*mkn), "mm", dtype=t["dtype"])
    torch.cuda.synchronize()
    measure, search = reader("measure_ms_per_eval.tune"), reader("search_host_ms_per_eval.tune")

    def window():
        n0, t0 = backend.n_measurements, time.perf_counter()
        for mkn in mkns:
            LoopTuner(backend=backend, registry=ScheduleRegistry(), policy="search").tune(
                matmul_benchmark(*mkn), "mm", dtype=t["dtype"], budget_s=t["budget_s"],
                max_evals=t["max_evals"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, backend.n_measurements - n0

    def spans_on(on: bool) -> None:
        """The tuner's spans, or in their place what a span is while
        nothing records."""
        for mod in (CM, CB, CT):
            mod.span = tracing.span if on else (lambda *a, **k: tracing._OFF)

    for turn in ("off", "profiler_no_spans", "profiler", "recording") * 3:
        spans_on(turn != "profiler_no_spans")
        ctx = (contextlib.nullcontext() if turn == "off" else tracing.recording()
               if turn == "recording" else profile(activities=ACTS))
        with ctx:
            wall, n = window()
        spans_on(True)
        row = {"phase": "tune", "turn": turn, "wall_s": wall, "measurements": n,
               "ms_per_eval": 1e3 * wall / n}
        if turn in ("profiler", "recording"):
            recs = tracing.spans()
            row.update(reward_spans=sum(r.name == "measure.reward" for r in recs),
                       lower_spans=sum(r.name == "backend.lower" for r in recs),
                       dropped=tracing.dropped(),
                       measure_ms_per_eval=measure.value(recs),
                       search_host_ms_per_eval=search.value(recs))
        emit(**row)


def phase_train(pairs: int) -> None:
    from repro_torch.models import steps as S
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedules import constant
    from yardstick import port as P
    from yardstick import weights as W
    from yardstick.kinds import train as TK

    cell = spec.load_cell("musicgen-large.train-8x1024")
    model, traffic, opt = cell.model, cell.traffic, cell.config["optimizer"]
    dev = torch.device("cuda", 0)
    params = W.port_params(W.make(model, 11, dev), model, trainable=True)
    state = adamw_init(dict(params.named_parameters()), keep_master=model["dtype"] != "float32")
    step = S.make_train_step(P.model_config(model), constant(opt["lr"]),
                             weight_decay=opt["weight_decay"],
                             max_grad_norm=opt["max_grad_norm"])
    roofline = reader("adamw_roofline.train")
    i = 0

    def one() -> float:
        nonlocal params, state, i
        feed = TK.batch(model, traffic, 11, i, dev)
        i += 1
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, feed)
        float(metrics["loss"])
        return time.perf_counter() - t0

    for _ in range(3):
        one()
    walls = [one() for _ in range(5)]
    emit(phase="train", turn="off", step_wall_s=walls)
    ratios = []
    for k in range(pairs):
        adamw = {}
        order = ("recording", "profiler") if k % 2 == 0 else ("profiler", "recording")
        for turn in order:
            ctx = tracing.recording() if turn == "recording" else profile(activities=ACTS)
            with ctx:
                walls = [one() for _ in range(traffic["traced_steps"])]
                torch.cuda.synchronize()
            recs = tracing.spans()
            by = {}
            for r in recs:
                d = by.setdefault(r.name, {"count": 0, "device_s": 0.0, "host_s": 0.0})
                d["count"] += 1
                d["device_s"] += r.device_s or 0.0
                d["host_s"] += r.host_s
            adamw[turn] = by["optim.adamw"]["device_s"]
            emit(phase="train", pair=k, turn=turn, step_wall_s=walls, spans=by,
                 adamw_roofline=roofline.value(recs, model))
        ratios.append(adamw["profiler"] / adamw["recording"])
    emit(phase="train_adamw_inflation", ratios=ratios,
         median=statistics.median(ratios))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", default="cost,tune,train")
    ap.add_argument("--pairs", type=int, default=6,
                    help="train: turns with and without the profiler")
    args = ap.parse_args()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    phases = {"cost": phase_cost, "tune": phase_tune,
              "train": lambda: phase_train(args.pairs)}
    for name in args.phase.split(","):
        t0 = time.perf_counter()
        phases[name]()
        emit(phase=f"{name}_done", seconds=time.perf_counter() - t0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    emit(phase="card", card=card.stdout.strip(), torch=torch.__version__)
    return 0


if __name__ == "__main__":
    sys.exit(main())
