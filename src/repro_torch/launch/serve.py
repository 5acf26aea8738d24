"""Batched serving launcher of the port: the continuous-batching decode loop.

A request pool feeds a fixed-size decode batch; finished requests are
retired and their slots refilled, prefill runs per admitted wave (its
attention is the flash-attention kernel, its RWKV-6 time-mix the
chunked-scan kernel, its Mamba mixer the selective-scan kernel), and every
decode step is the ``serve_step`` of ``models/steps.py``.

``--registry PATH`` serves tuned schedules: the prefill/decode step bodies
run under ``kernels.ops.serving``, so every dense site looks its workload
signature up in the tuned-schedule table, and a hit on the card launches
the tiled-matmul kernel at the tuned block.  The table comes from
:class:`~repro_torch.core.tuner.LoopTuner` (``tuner.save(path)``) or from
``launch/tune``; ``--tune --registry PATH`` runs that pre-pass first at
this run's own ``--batch``, ``--prompt-len`` and ``--max-len`` (so the
harvested keys are the ones served), with ``--tune-budget-s`` seconds in
all.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \\
        --full --requests 8 --batch 4 --prompt-len 256 --gen-len 16 \\
        --max-len 512 --registry /path/to/musicgen.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --full --requests 8 --batch 4 --prompt-len 1024 --gen-len 32 \\
        --max-len 1056

jamba-v0.1-52b's ``--full`` config (32 layers) needs ~103 GB of bf16
weights, more than one 80 GB card: on one card, serve a depth cut of it
through :func:`serve_once` (``dataclasses.replace(cfg, n_layers=16)``, two
whole periods, as ``chip_smoke.py`` does).  Runs on the card; ``--device
cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.registry import ScheduleRegistry
from repro_torch.kernels import ops as K
from repro_torch.models import steps as S
from repro_torch.models import transformer as T


class Request:
    def __init__(self, rid: int, prompt: np.ndarray, gen_len: int):
        self.rid = rid
        self.prompt = prompt
        self.gen_len = gen_len
        self.generated: List[int] = []
        self.t_submit = time.perf_counter()
        self.t_done: Optional[float] = None


def request_pool(cfg: ModelConfig, requests: int, prompt_len: int, gen_len: int,
                 seed: int) -> List[Request]:
    """The requests :func:`serve_once` serves for this seed, in order."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab, (prompt_len,)), gen_len)
            for i in range(requests)]


def init_model(cfg: ModelConfig, seed: int, device) -> T.ParamTree:
    """The random weights :func:`serve_once` serves for this seed."""
    return T.init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)


def input_fn(cfg: ModelConfig, device) -> Callable[[np.ndarray], Dict[str, torch.Tensor]]:
    """tokens (B, S) -> model inputs.  An ``embeds`` frontend (audio stub)
    looks each token up in a fixed frame-embedding table drawn from a
    generator seeded 1."""
    if cfg.frontend == "tokens":
        return lambda toks: {"tokens": torch.as_tensor(np.asarray(toks), dtype=torch.long,
                                                       device=device)}
    g = torch.Generator(device=device).manual_seed(1)
    table = torch.randn(cfg.vocab, cfg.d_model, generator=g, device=device)
    return lambda toks: {"embeds": table[torch.as_tensor(np.asarray(toks),
                                                         dtype=torch.long,
                                                         device=device)]}


def serve_once(
    cfg: ModelConfig,
    *,
    requests: int = 16,
    batch: int = 4,
    prompt_len: int = 32,
    gen_len: int = 32,
    max_len: int = 128,
    seed: int = 0,
    registry: Union[str, ScheduleRegistry, None] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Run the continuous-batching serve loop once; return the summary.

    ``registry``: tuned-schedule table (path or ScheduleRegistry) to serve
    with; the summary then grows a ``"registry"`` block with the
    per-contraction hit/miss/routed counters of this run.
    """
    device = torch.device(device)
    params = init_model(cfg, seed, device)
    if isinstance(registry, str):
        registry = ScheduleRegistry(registry)
    if registry is not None:
        K.reset_serving_stats()

    serve_step = S.make_decode_step(cfg, registry=registry)
    prefill_one = S.make_prefill_step(cfg, max_len=max_len, registry=registry)
    make_inputs = input_fn(cfg, device)

    pending = request_pool(cfg, requests, prompt_len, gen_len, seed)
    done: List[Request] = []
    b = batch
    caches = None
    slots: List[Optional[Request]] = [None] * b
    slot_len = np.zeros(b, np.int32)

    t0 = time.perf_counter()
    decode_steps = decode_tokens = 0
    step_times: List[float] = []
    prefill_times: List[float] = []
    finite = True
    # admission happens in waves (all slots share cache_len), which is exact
    # because prompts are equal-length; a production server tracks per-slot
    # cache lengths
    while pending or any(s is not None for s in slots):
        if all(s is None for s in slots) and pending:
            wave = [pending.pop(0) for _ in range(min(b, len(pending)))]
            prompts = np.stack([w.prompt for w in wave]
                               + [wave[-1].prompt] * (b - len(wave)))
            t_pre = time.perf_counter()
            last_logits, caches, cache_len = prefill_one(params, make_inputs(prompts))
            finite &= bool(torch.isfinite(last_logits).all())
            nxt = torch.argmax(last_logits, -1).cpu().numpy().astype(np.int32)
            prefill_times.append(time.perf_counter() - t_pre)
            for i, w in enumerate(wave):
                slots[i] = w
                w.generated.append(int(nxt[i]))
            slot_len[:] = cache_len
            cur = nxt
        one = make_inputs(cur[:, None])
        t_step = time.perf_counter()
        nxt, logits, caches = serve_step(params, one, caches, int(slot_len[0]))
        decode_steps += 1
        slot_len += 1
        finite &= bool(torch.isfinite(logits).all())
        nxt = nxt.cpu().numpy()  # device sync closes the step timer
        step_times.append(time.perf_counter() - t_step)
        decode_tokens += sum(r is not None for r in slots)
        for i, r in enumerate(slots):
            if r is None:
                continue
            r.generated.append(int(nxt[i]))
            if len(r.generated) >= r.gen_len:
                r.t_done = time.perf_counter()
                done.append(r)
                slots[i] = None
        cur = nxt

    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in done)
    lat = [r.t_done - r.t_submit for r in done]
    # step latency: median without the first step (which pays first-use
    # set-up, the kernels' build included); the decode rate counts every
    # step, so a stall anywhere lowers it
    steady = step_times[1:] if len(step_times) > 1 else step_times
    summary = {
        "arch": cfg.name,
        "device": str(device),
        "requests": len(done),
        "prefill_waves": len(prefill_times),
        "prefill_ms": [t * 1e3 for t in prefill_times],
        "decode_steps": decode_steps,
        "decode_tokens": decode_tokens,
        "tokens": total_tokens,
        "tokens_per_s": total_tokens / dt,
        "decode_step_p50_ms": float(np.percentile(steady, 50)) * 1e3,
        "decode_tokens_per_s": decode_tokens / sum(step_times),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p95_s": float(np.percentile(lat, 95)),
        "logits_finite": finite,
    }
    if registry is not None:
        summary["registry"] = {
            "path": registry.path,
            "size": len(registry),
            "serving": K.serving_stats(reset=True),
        }
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-large",
                    help="a ported architecture: musicgen-large, rwkv6-7b or "
                         "jamba-v0.1-52b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the smoke config)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--registry", default=None,
                    help="tuned-schedule registry JSON to serve with")
    ap.add_argument("--tune", action="store_true",
                    help="run the tuning pre-pass before serving "
                         "(requires --registry)")
    ap.add_argument("--tune-budget-s", type=float, default=4.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke()

    registry = None
    if args.registry:
        registry = ScheduleRegistry(args.registry)
        if args.tune:
            from repro_torch.launch.tune import tune_model
            report = tune_model(
                cfg, registry=registry, registry_path=args.registry,
                budget_s=args.tune_budget_s, smoke=False,  # cfg already set
                batch=args.batch, prompt_len=args.prompt_len,
                max_len=args.max_len, device=args.device)
            print("[serve] tuned:", json.dumps(
                {k: report[k] for k in ("n_harvested", "n_tuned",
                                        "flop_share_covered",
                                        "registry_size", "tune_time_s")}),
                flush=True)
    elif args.tune:
        ap.error("--tune requires --registry")

    summary = serve_once(
        cfg, requests=args.requests, batch=args.batch,
        prompt_len=args.prompt_len, gen_len=args.gen_len,
        max_len=args.max_len, seed=args.seed, registry=registry,
        device=args.device)
    print("[serve] done:", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
