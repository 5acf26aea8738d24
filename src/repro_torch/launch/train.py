"""End-to-end training launcher of the port.

Runs a training loop for any ``--arch`` (smoke-scaled by default; ``--full``
takes the published config) with the substrate of the JAX package's
``launch/train.py``: deterministic host-sharded data, AdamW with an f32
master copy for bf16 models, checkpoint/restart, the straggler watchdog,
optional failure injection, optional int8 gradient compression and
microbatched gradient accumulation.  The same flags and the same ``[train]
done: {...}`` summary keys; ``--device`` (default ``cuda``, which raises
without a card) picks the device, and ``--device cpu`` runs the kernels'
plain versions.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir build/ckpt

On the card every attention runs the flash kernel forward and backward,
every RWKV-6 time-mix and Mamba mixer its scan kernel forward (their
backward recomputes the plain scan).  Checkpoints are the JAX package's
layout and keys: one written here restores in ``repro.launch.train`` and
the reverse.  One device only: ``--mesh auto`` is that device, ``single``
and ``multi`` (the production meshes) raise until the sharding runtime is
ported (ROADMAP.md, A5).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import make_dataset
from repro_torch.models import steps as S
from repro_torch.models.convert import from_jax_layout, to_jax_layout
from repro_torch.optim import AdamWState
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.runtime.compress import compress_grads, ef_init
from repro_torch.runtime.ft import FailureInjector, FaultTolerantRunner, StragglerWatchdog


class TrainCheckpoints:
    """A :class:`CheckpointManager` over the live train state ``(params,
    opt)`` or ``(params, opt, ef)``: it saves and restores the JAX
    package's tree of that state (parameters, moments, master copy and
    error feedback stacked per period, ``models.convert.to_jax_layout``),
    and a restore copies the checkpoint's values into the live tensors."""

    def __init__(self, manager: CheckpointManager, cfg):
        self.manager = manager
        self.cfg = cfg

    def tree(self, state: Tuple) -> Tuple:
        params, opt, *ef = state
        layout = lambda d: None if d is None else to_jax_layout(d, self.cfg)  # noqa: E731
        opt_tree = AdamWState(opt.step, layout(opt.mu), layout(opt.nu), layout(opt.master))
        return (layout(dict(params.named_parameters())), opt_tree, *map(layout, ef))

    def save(self, step: int, state: Tuple, extras: Optional[dict] = None) -> str:
        return self.manager.save(step, self.tree(state), extras)

    def restore_latest(self, state: Tuple) -> Optional[Tuple[int, Tuple, dict]]:
        restored = self.manager.restore_latest(self.tree(state))
        if restored is None:
            return None
        step, tree, extras = restored
        params, opt, *ef = state
        live = (dict(params.named_parameters()), opt.mu, opt.nu, opt.master, *ef)
        saved = (tree[0], tree[1].mu, tree[1].nu, tree[1].master, *tree[2:])
        with torch.no_grad():
            for dst, src in zip(live, saved):
                if dst is None:
                    continue
                for name, t in from_jax_layout(src, self.cfg).items():
                    dst[name].copy_(t)
        opt = AdamWState(tree[1].step.to(opt.step.device), opt.mu, opt.nu, opt.master)
        return step, (params, opt, *ef), extras


def build(args, registry=None):
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke()
    lr_fn = cosine_with_warmup(args.lr, warmup=max(10, args.steps // 20), total=args.steps)
    step_fn = S.make_train_step(cfg, lr_fn, n_microbatches=args.microbatches,
                                weight_decay=args.weight_decay, registry=registry)
    return cfg, step_fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="published config (fleet scale); default smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--weight-decay", type=float, default=0.1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt under the "
                         "temporary directory)")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, nargs="*", default=None,
                    help="inject failures at these steps (FT demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default="auto",
                    help="'auto' (the one device) | 'single' | 'multi' (not ported: "
                         "ROADMAP.md A5)")
    ap.add_argument("--registry", default=None,
                    help="tuned-schedule registry JSON (dense sites consult it; default: "
                         "the plain @).  On the card a hit launches the tiled matmul, "
                         "which has no backward and raises under grad (ROADMAP.md §C 6); "
                         "on the CPU dense sites stay on the plain @")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    if args.mesh != "auto":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the production meshes need the sharding runtime, "
            f"not ported yet (ROADMAP.md, A5); --mesh auto trains on one device")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; --device cpu runs the kernels' "
                           "plain versions")

    registry = None
    if args.registry:
        from repro_torch.core.registry import ScheduleRegistry
        registry = ScheduleRegistry(args.registry)
    cfg, raw_step = build(args, registry=registry)
    ds = make_dataset(cfg, None, seed=args.seed, global_batch=args.batch, seq_len=args.seq)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, opt = S.init_train_state(cfg, gen, device)

    if args.compress_grads:
        ef_box = [ef_init(dict(params.named_parameters()))]

        def transform(grads):
            deq, ef_box[0] = compress_grads(grads, ef_box[0])
            return deq

        compressed_step = S.make_train_step(
            cfg, cosine_with_warmup(args.lr, 10, args.steps), weight_decay=args.weight_decay,
            max_grad_norm=1.0, grad_transform=transform, registry=registry)

        def step_fn(state, batch):
            params, opt, ef = state
            ef_box[0] = ef
            params, opt, metrics = compressed_step(params, opt, batch)
            return (params, opt, ef_box[0]), metrics

        state: Tuple[Any, ...] = (params, opt, ef_box[0])
    else:
        def step_fn(state, batch):
            params, opt, metrics = raw_step(state[0], state[1], batch)
            return (params, opt), metrics

        state = (params, opt)

    def batch_fn(step):
        return {k: torch.from_numpy(v).to(device) for k, v in ds.batch(step).items()}

    ckpt = TrainCheckpoints(CheckpointManager(
        args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"), keep_n=3),
        cfg)
    injector = FailureInjector(args.fail_at) if args.fail_at else None
    watchdog = StragglerWatchdog(n_hosts=1)
    runner = FaultTolerantRunner(
        step_fn, ckpt, save_every=args.save_every, injector=injector,
        extras_fn=lambda s: {"data_seed": args.seed, "arch": cfg.name})

    start = 0
    restored = ckpt.restore_latest(state)
    if restored is not None:
        start, state, _ = restored
        print(f"[train] resumed from step {start}", flush=True)

    t0 = time.time()
    losses = []

    def log_hook(step, m):
        losses.append(m["loss"])
        watchdog.record(step, np.array([m["step_time_s"]]))  # one host
        if step % args.log_every == 0:
            tput = args.batch * args.seq / m["step_time_s"]
            print(f"[train] step {step:5d} loss {m['loss']:.4f} "
                  f"ce {m.get('ce', float('nan')):.4f} "
                  f"gnorm {m['grad_norm']:.3f} tok/s {tput:,.0f}", flush=True)

    state, final_step, _ = runner.run(state, batch_fn, start, args.steps - start,
                                      hooks=[log_hook])
    dt = time.time() - t0
    summary = {
        "arch": cfg.name, "steps": final_step, "wall_s": round(dt, 1),
        "loss_first": losses[0] if losses else None,
        "loss_last": float(np.mean(losses[-5:])) if losses else None,
        "restarts": runner.restarts,
        "straggler_events": len(watchdog.events),
        "tokens_per_s": round(args.batch * args.seq * len(losses) / dt, 1),
    }
    print("[train] done:", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
