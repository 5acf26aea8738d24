"""LoopTune retuning a model's contractions for several batch buckets.

The traffic is one cycle of contractions, ``m`` x ``kn`` pairs in
``dtype``, repeated in an order drawn from the seed for each cycle: every
seed tunes the same set.  Each contraction is tuned by a fresh
``LoopTuner`` (search: greedy, then beam, ``max_evals`` evaluations each,
on the card executor) with a fresh evaluation cache; the one executor
keeps the operands, which set-up made for every contraction.  The window
closes at the end of the first whole cycle that ends after ``--seconds``.

End to end: ``tune_s``, the window over the contractions tuned.

Correct: after the window, every schedule chosen is served through
``kernels.ops.tuned_einsum`` on operands drawn from the seed, and compared
with their f32 product (``served_rel``, the worst over the schedules); each
must launch the tiled matmul once on the card.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import torch

from .. import compare as C
from .. import weights as W
from ..measure import Run, profile_steps, span


def contractions(traffic: Dict) -> List[Tuple[int, int, int]]:
    return [(m, k, n) for m in traffic["m"] for k, n in traffic["kn"]]


def order(traffic: Dict, seed: int, cycle: int) -> List[Tuple[int, int, int]]:
    cs = contractions(traffic)
    random.Random(W.sub_seed(seed, 4000, cycle)).shuffle(cs)
    return cs


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        mark_window) -> Dict:
    from repro_torch.core.backend import make_backend
    from repro_torch.core.loop_ir import matmul_benchmark
    from repro_torch.core.registry import ScheduleRegistry
    from repro_torch.core.tuner import LoopTuner

    traffic = cell.traffic
    dtype = traffic["dtype"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    backend = make_backend("torch", device=device, seed=W.sub_seed(seed, 4100) % 2 ** 32)
    chosen = ScheduleRegistry()

    def tune(mkn, registry) -> None:
        with span("portbench.tune"):
            LoopTuner(backend=backend, registry=registry, policy="search").tune(
                matmul_benchmark(*mkn), "mm", dtype=dtype, budget_s=traffic["budget_s"],
                max_evals=traffic["max_evals"])

    # set-up: every contraction's operands, the kernel library and the
    # untuned schedule's launch, tuned by nothing
    for mkn in contractions(traffic):
        LoopTuner(backend=backend, registry=ScheduleRegistry(), policy="default").tune(
            matmul_benchmark(*mkn), "mm", dtype=dtype)
    sync()

    m0 = backend.n_measurements
    mark_window()
    t0 = time.perf_counter()
    done, cycle = 0, 0
    while True:
        for mkn in order(traffic, seed, cycle):
            tune(mkn, chosen)
            done += 1
        cycle += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window = time.perf_counter() - t0
    measurements = backend.n_measurements - m0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    run_rec = Run("tune", cell.model, traffic, window, done,
                  counters={"measurements": measurements})
    if trace:
        n = traffic["traced_contractions"]
        traced = order(traffic, seed, cycle)[:n]
        run_rec.trace = profile_steps(lambda j: tune(traced[j], ScheduleRegistry()), n, sync,
                                      cell.name)
        run_rec.traced_steps = n
    numbers = check(chosen, traffic, seed, device)
    return {"e2e": {"tune_s": window / done}, "attempted": done, "failed": 0,
            "numbers": numbers, "memory_peak_bytes": peak, "run": run_rec}


def check(chosen, traffic: Dict, seed: int, device: torch.device) -> Dict[str, float]:
    """Each chosen schedule served through ``tuned_einsum``, against the f32
    product of the same operands."""
    from repro_torch.kernels import ops as K

    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, traffic["dtype"])
    worst = 0.0
    for i, (m, k, n) in enumerate(contractions(traffic)):
        g = W.generator(device, seed, 5000, i)
        a = torch.randn((m, k), generator=g, device=device).to(dt)
        b = torch.randn((k, n), generator=g, device=device).to(dt)
        K.reset_serving_stats()
        with K.serving(chosen):
            out = K.tuned_einsum("mk,kn->mn", a, b)
        stats = K.serving_stats(reset=True)
        if stats["hits"] != 1 or stats["routed"] != int(device.type == "cuda"):
            return {"served_rel": float("nan")}
        worst = max(worst, C.rel_err(out, a.float() @ b.float()))
    return {"served_rel": worst}
