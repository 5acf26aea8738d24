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
the reverse, and at any world size.

Over more than one rank a run trains under a mesh
(``runtime/sharding.py``): parameters are DTensors placed by the
reference's FSDP rules, AdamW's state by its ZeRO rules, and each rank
builds the same global batch from the pipeline and places it on the batch
axes.  ``--mesh auto`` is ``(world, 1)`` over ``("data", "model")``, where
the world is the launcher's (``torchrun --nproc-per-node N``, one card a
rank) or 1 without one; at a world of 1 that mesh shards nothing, so the
run keeps plain tensors and starts no process group.  ``single`` and
``multi`` are the production meshes (16 x 16, 2 x 16 x 16) and raise
unless the world matches.  The straggler watchdog watches the data axis's
ranks.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --mesh auto --steps 50 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import make_dataset
from repro_torch.launch.mesh import (PRODUCTION_MULTI, PRODUCTION_SINGLE, init_process_group,
                                     make_mesh)
from repro_torch.models import steps as S
from repro_torch.models.convert import from_jax_layout, to_jax_layout
from repro_torch.optim import AdamWState
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.runtime import sharding as SH
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


def mesh_layout(mesh: str, world: int) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``--mesh``'s shape and axes for a process group of ``world`` ranks;
    raises where they differ in size (naming both)."""
    if mesh == "auto":
        return (world, 1), ("data", "model")
    if mesh not in ("single", "multi"):
        raise ValueError(f"--mesh {mesh!r}: auto | single | multi")
    shape, axes = PRODUCTION_SINGLE if mesh == "single" else PRODUCTION_MULTI
    size = int(np.prod(shape))
    if size != world:
        raise ValueError(f"--mesh {mesh} is {dict(zip(axes, shape))}, {size} ranks; the "
                         f"world size is {world}")
    return shape, axes


def _host_times(step_s: float, mesh, device) -> np.ndarray:
    """Every rank's step seconds, gathered; the slowest rank of each index
    of the data axis (the watchdog's hosts)."""
    t = torch.tensor([step_s], dtype=torch.float64, device=device)
    out = [torch.zeros_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    times = torch.cat(out).cpu().numpy().reshape(tuple(mesh.shape))
    names = list(mesh.mesh_dim_names)
    if "data" not in names:
        return np.array([times.max()])
    data = names.index("data")
    return times.max(axis=tuple(i for i in range(times.ndim) if i != data))


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
                    help="'auto' (every rank on the data axis) | 'single' (16 x 16) | "
                         "'multi' (2 x 16 x 16)")
    ap.add_argument("--registry", default=None,
                    help="tuned-schedule registry JSON (dense sites consult it; default: "
                         "the plain @).  On the card a hit launches the tiled matmul, "
                         "which has no backward and raises under grad (ROADMAP.md §C 6); "
                         "on the CPU dense sites stay on the plain @")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; --device cpu runs the kernels' "
                           "plain versions")
    own_group = not dist.is_initialized()
    world = dist.get_world_size() if not own_group else int(os.environ.get("WORLD_SIZE", 1))
    shape, axes = mesh_layout(args.mesh, world)
    mesh = None  # one rank: plain tensors (a (1, 1) mesh shards nothing)
    if world > 1:
        init_process_group(device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(shape, axes, device.type)
    own_group = own_group and dist.is_initialized()
    lead = mesh is None or dist.get_rank() == 0

    registry = None
    if args.registry:
        from repro_torch.core.registry import ScheduleRegistry
        registry = ScheduleRegistry(args.registry)
    cfg, raw_step = build(args, registry=registry)
    ds = make_dataset(cfg, None, seed=args.seed, global_batch=args.batch, seq_len=args.seq)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, opt = S.init_train_state(cfg, gen, device, mesh=mesh)

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

    def batch_fn(step):  # the same global batch on every rank, placed on the batch axes
        batch = {k: torch.from_numpy(v).to(device) for k, v in ds.batch(step).items()}
        return batch if mesh is None else S.distribute_batch(batch, mesh)

    ckpt = TrainCheckpoints(CheckpointManager(
        args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"), keep_n=3),
        cfg)
    injector = FailureInjector(args.fail_at) if args.fail_at else None
    watchdog = StragglerWatchdog(n_hosts=1 if mesh is None
                                 else SH.mesh_sizes(mesh).get("data", 1))
    runner = FaultTolerantRunner(
        step_fn, ckpt, save_every=args.save_every, injector=injector,
        extras_fn=lambda s: {"data_seed": args.seed, "arch": cfg.name})

    start = 0
    restored = ckpt.restore_latest(state)
    if restored is not None:
        start, state, _ = restored
        if lead:
            print(f"[train] resumed from step {start}", flush=True)

    t0 = time.time()
    losses = []

    def log_hook(step, m):
        losses.append(m["loss"])
        watchdog.record(step, np.array([m["step_time_s"]]) if mesh is None
                        else _host_times(m["step_time_s"], mesh, device))
        if step % args.log_every == 0 and lead:
            tput = args.batch * args.seq / m["step_time_s"]
            print(f"[train] step {step:5d} loss {m['loss']:.4f} "
                  f"ce {m.get('ce', float('nan')):.4f} "
                  f"gnorm {m['grad_norm']:.3f} tok/s {tput:,.0f}", flush=True)

    with SH.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
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
    if lead:
        print(f"[train] mesh {dict(zip(axes, shape))}", flush=True)
        print("[train] done:", json.dumps(summary), flush=True)
    if own_group:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
