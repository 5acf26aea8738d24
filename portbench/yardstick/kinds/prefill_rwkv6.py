"""Tuned prefill of an RWKV-6 model served to clients in a closed loop.

The traffic of ``kinds/prefill.py`` (``clients`` clients, each a prompt of
``prompt_len`` token ids drawn from the seed and the wave's index, waiting
for its first token; one wave prefills every waiting prompt through
``models.steps.make_prefill_step`` under the configuration's tuned
schedules), on a model whose every layer is an RWKV-6 time-mix and
channel-mix (``yardstick/rwkv6.py``).  The same end-to-end metrics:
``prefill_tokens_per_s`` and ``ttft_ms_p95``.

Correct: after the window, the waves at ``sampled`` indices drawn from the
seed among the first ``sample_from`` are run again by the plain reference
in f32 from the same weights and prompts; compared are every sampled
request's last logits (``logits_rel``), every layer's final WKV state and
both token-shift carries in the prefill's cache (``state_rel``), and the
reference logit gap of each served first token (``token_gap``).  Then the
first sampled wave is prefilled once more with every scan held to the
reference's recurrence (f32) on the scan's own inputs: its output and final
state, layer by layer (``scan_rel``; ``yardstick.rwkv6.scan_checked``).  Every
full-width projection and the head must hit the registry and, on the card,
launch the tiled matmul, and every time-mix must launch the CUDA scan (the
scan wrapper's launch count): else the run fails.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import compare as C
from .. import port as P
from .. import rwkv6 as R
from .. import weights as W
from ..measure import Run, profile_steps, span
from .prefill import _check_routing

KIND = "prefill_rwkv6"


def _scan_launches() -> int:
    from repro_torch.kernels import rwkv6_scan

    return rwkv6_scan.rwkv6_chunk_scan.launches


def _check_scans(before: int, layers: int, waves: int, on_card: bool) -> int:
    """Every time-mix of ``waves`` waves launched the scan kernel once (none
    on the CPU, whose tensors run its plain version); the count now."""
    now = _scan_launches()
    want = layers * waves if on_card else 0
    if now - before != want:
        raise SystemExit(f"{now - before} scan kernel launches in {waves} waves, "
                         f"expected {want}")
    return now


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        mark_window) -> Dict:
    from repro_torch.kernels import ops as K
    from repro_torch.models import steps as S

    model, traffic = cell.model, cell.traffic
    B, L = traffic["clients"], traffic["prompt_len"]
    layers = model["n_layers"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = R.model_config(model)
    expected = R.dense_keys(model, B * L)
    registry = P.schedule_registry(cell.config["schedules"], expected, cell.name)
    w = R.make(model, seed, device)
    params = R.port_params(w, model)
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
    scans = _scan_launches()
    # the warm-up holds as many answers as the window will keep
    held = [wave(-1 - i)[2:4] for i in range(traffic["warmup_waves"])]
    sync()
    del held
    _check_routing(K.serving_stats(reset=True), expected, traffic["warmup_waves"], on_card)
    scans = _check_scans(scans, layers, traffic["warmup_waves"], on_card)

    sampled = R.sampled_waves(traffic, seed)
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
    scans = _check_scans(scans, layers, waves, on_card)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    run_rec = Run(KIND, model, traffic, window, waves, B, L)
    if trace:
        n = traffic["traced_waves"]
        run_rec.trace = profile_steps(lambda j: wave(waves + j), n, sync, cell.name)
        run_rec.traced_steps = n
        _check_routing(K.serving_stats(reset=True), expected, n, on_card)
        _check_scans(scans, layers, n, on_card)
    scan = {"scan_rel": 0.0}
    ref = cell.reference()
    ref.no_tf32()
    with R.scan_checked(ref, scan):
        wave(sampled[0])
    sync()
    del params, prefill

    numbers = dict(check(cell, seed, w, sampled, kept, device), **scan)
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
    out = {"logits_rel": 0.0, "state_rel": 0.0, "token_gap": 0.0}
    for i in sampled:
        if i not in kept:   # the window ended before this wave
            return {k: float("nan") for k in out}
        caches, got, first = kept.pop(i)

        def on_state(l, s, xt, xc):
            out["state_rel"] = R.worst(out["state_rel"], R.state_errors(caches, l, s, xt, xc))

        inputs = W.prompt(model, seed, i, B, L, device)
        want = ref.prefill(model, w, inputs, on_state=on_state)
        out["logits_rel"] = R.worst(out["logits_rel"],
                                    *(C.rel_err(got[r], want[r]) for r in range(B)))
        out["token_gap"] = R.worst(out["token_gap"], C.served_gap(want, first.to(device)))
        del caches, got
    return out
