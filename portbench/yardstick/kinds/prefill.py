"""Tuned prefill served to clients in a closed loop.

``clients`` clients each send a prompt of ``prompt_len`` positions and wait
for its first token; the server prefills every waiting prompt in one wave
(``models.steps.make_prefill_step`` under the configuration's tuned
schedules) and returns each first token (the greedy argmax of the last
logits) to the host.  A client sends its next prompt as soon as its token
is back, so every wave serves all clients.  Each prompt is drawn from the
seed and the wave's index.

End to end: ``prefill_tokens_per_s``, every prompt position prefilled in
the window over the window; ``ttft_ms_p95``, the 95th percentile over every
request of the window of send-to-first-token-on-the-host.

Correct: after the window, the waves at ``sampled`` indices drawn from the
seed among the first ``sample_from`` are run again by the plain reference
in f32 from the same weights and prompts; compared are every sampled
request's last logits (``logits_rel``), every layer's cached k and v
(``kv_rel``), and the reference logit gap of each served first token
(``token_gap``).  Every dense site must hit the registry and, on the card,
launch the tiled matmul: a miss, or a hit left to the library, fails the
run.
"""
from __future__ import annotations

import random
import time
from typing import Dict

import numpy as np
import torch

from .. import compare as C
from .. import counting as N
from .. import port as P
from .. import weights as W
from ..measure import Run, profile_steps, span


def _check_routing(stats: Dict, expected: Dict, waves: int, on_card: bool) -> None:
    """Every dense site a hit, each key hit ``count x waves`` times and, on
    the card, every hit launched on the tiled matmul."""
    if stats["misses"]:
        raise SystemExit(f"dense sites missed the registry: {stats['per_key']}")
    for (m, k, n, dt), count in expected.items():
        got = stats["per_key"].get(f"mm:{m}x{k}x{n}:{dt}", {})
        want_routed = count * waves if on_card else 0
        if got.get("hits") != count * waves or got.get("routed") != want_routed:
            raise SystemExit(f"key {(m, k, n, dt)}: {got}, expected {count * waves} hits "
                             f"and {want_routed} on the tiled matmul")
    extra = set(stats["per_key"]) - {f"mm:{m}x{k}x{n}:{dt}" for m, k, n, dt in expected}
    if extra:
        raise SystemExit(f"dense sites outside the configuration's: {sorted(extra)}")


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        mark_window) -> Dict:
    from repro_torch.kernels import ops as K
    from repro_torch.models import steps as S

    model, traffic = cell.model, cell.traffic
    B, L = traffic["clients"], traffic["prompt_len"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = P.model_config(model)
    expected = N.dense_keys(model, B * L)
    registry = P.schedule_registry(cell.config["schedules"], expected, cell.name)
    w = W.make(model, seed, device)
    params = W.port_params(w, model, trainable=False)
    prefill = S.make_prefill_step(cfg, traffic["max_len"], registry=registry)

    def wave(i: int):
        with span("portbench.client"):
            inputs = W.prompt(model, seed, i, B, L, device)
        t_send = time.perf_counter()
        with span("portbench.prefill"):
            last, caches, _ = prefill(params, inputs)
        with span("portbench.first_token"):
            first = last.argmax(dim=-1).cpu()
        return t_send, time.perf_counter(), last, caches, first

    K.reset_serving_stats()
    # the warm-up holds as many answers as the window will keep (its caches
    # and last logits), so the allocator has their blocks before the window
    held = [wave(-1 - i)[2:4] for i in range(traffic["warmup_waves"])]
    sync()
    del held
    _check_routing(K.serving_stats(reset=True), expected, traffic["warmup_waves"], on_card)

    rng = random.Random(W.sub_seed(seed, 3000))
    sampled = sorted(rng.sample(range(traffic["sample_from"]), traffic["sampled_waves"]))
    kept, ttft = {}, []
    mark_window()
    t0 = time.perf_counter()
    t_done, waves = t0, 0
    while t_done - t0 < seconds:
        t_send, t_done, last, caches, first = wave(waves)
        ttft += [t_done - t_send] * B
        if waves in sampled:   # its answers, for the check after the window
            kept[waves] = (caches, last, first)
        del caches, last
        waves += 1
    window = t_done - t0
    _check_routing(K.serving_stats(reset=True), expected, waves, on_card)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    run_rec = Run("prefill", model, traffic, window, waves, B, L)
    if trace:
        n = traffic["traced_waves"]
        run_rec.trace = profile_steps(lambda j: wave(waves + j), n, sync, cell.name)
        run_rec.traced_steps = n
        _check_routing(K.serving_stats(reset=True), expected, n, on_card)
    del params, prefill

    numbers = check(cell, seed, w, sampled, kept, device)
    e2e = {"prefill_tokens_per_s": waves * B * L / window,
           "ttft_ms_p95": float(np.percentile(np.asarray(ttft) * 1e3, 95))}
    return {"e2e": e2e, "attempted": waves * B, "failed": 0, "numbers": numbers,
            "memory_peak_bytes": peak, "run": run_rec}


def check(cell, seed, w, sampled, kept, device) -> Dict[str, float]:
    """The reference over each sampled wave; worst readings over them."""
    model, traffic = cell.model, cell.traffic
    B, L = traffic["clients"], traffic["prompt_len"]
    ref = cell.reference()
    ref.no_tf32()
    worst = {"logits_rel": 0.0, "kv_rel": 0.0, "token_gap": 0.0}
    for i in sampled:
        if i not in kept:   # the window ended before this wave
            return {k: float("nan") for k in worst}
        caches, got, first = kept.pop(i)
        k_cache, v_cache = caches[0]["k"], caches[0]["v"]

        def on_kv(l, k, v):
            worst["kv_rel"] = max(worst["kv_rel"], C.rel_err(k_cache[l, :, :L], k),
                                  C.rel_err(v_cache[l, :, :L], v))

        inputs = W.prompt(model, seed, i, B, L, device)
        want = ref.prefill(model, w, inputs, ref.ACT, on_kv=on_kv)
        for r in range(B):
            worst["logits_rel"] = max(worst["logits_rel"], C.rel_err(got[r], want[r]))
        worst["token_gap"] = max(worst["token_gap"], C.served_gap(want, first.to(device)))
        del caches, k_cache, v_cache, got
    return worst
