"""Rank programs of ``tests/test_torch_dist*.py``: ``gloo`` process groups on
the CPU, one process a rank.

    python tests/torch_dist_ranks.py SCENARIO WORLD DIR

spawns WORLD ranks that meet through ``file://DIR/pg`` (no sockets, so the
test workers' groups never collide), runs the scenario on every rank and
has rank 0 write what the test checks to ``DIR/result.npz`` and
``DIR/result.json``.  The ranks import torch and the port only; the JAX
reference is the caller's (``DIR/inputs.npz``).

Scenarios:

* ``olmoe`` (4 ranks, mesh (2, 2); 8 ranks, (4, 2)): olmoe-1b-7b's smoke
  config from the caller's weights, placed by the FSDP/ZeRO specs: the loss
  and every gradient of one evaluation, then two train steps (the loss and
  the parameters after each); on 4 ranks also prefill and one decode step
  under the mesh (their logits, and against the unsharded port), a
  checkpoint of the trained state written by the 4 ranks, and ``remesh``
  4 -> 2 -> 1 -> 4 of the parameters under the ZeRO specs (the data axis
  shards every leaf it divides) with each leaf's whole value compared bit
  for bit.
* ``llama4`` (4 ranks, mesh (1, 4)): llama4-scout's smoke config from the
  caller's weights (4 q heads, 2 kv heads: K and V replicated over the
  model axis, each rank cutting out its q head's kv head): the loss and
  every gradient; then a prefill of ``LLAMA4_PROMPT`` tokens and one decode
  step, whose caches put their sequence dim on the model axis (2 kv heads
  do not divide 4), so that each rank writes only its own slots: the
  logits, and the logits and whole caches against the unsharded port.
* ``scans`` (4 ranks, mesh (2, 2)): rwkv6-7b's smoke config with two heads
  (``SCAN_OVERRIDES``: the heads, RWKV-6's state and its bonus ``u`` over
  model) and jamba's (Mamba's d_inner over model), each from the caller's
  weights: the loss, every gradient, the prefill's last logits and a
  decode step's, and the same against the unsharded port.
"""
from __future__ import annotations

import json
import os
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

MESHES = {("olmoe", 4): (2, 2), ("olmoe", 8): (4, 2), ("llama4", 4): (1, 4),
          ("scans", 4): (2, 2)}
SCAN_ARCHS = ("rwkv6-7b", "jamba-v0.1-52b")
# the smoke configs as the scans scenario runs them: RWKV-6 at head dim 32
# has 2 heads (its smoke config has one head of 64), which the model axis
# of 2 shards
SCAN_OVERRIDES = {"rwkv6-7b": {"rwkv_head_dim": 32}, "jamba-v0.1-52b": {}}
LLAMA4_PROMPT, LLAMA4_MAX_LEN = 12, 32  # cache seq shards of 8: one and a half filled
ARCH = {"olmoe": "olmoe-1b-7b", "llama4": "llama4-scout-17b-a16e", "scans": "rwkv6-7b"}
LR = (3e-3, 2, 20)  # cosine_with_warmup(peak, warmup, total)


def _quiet() -> None:
    import logging

    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)


def _unstack(inputs, prefix: str) -> dict:
    """The caller's numpy tree written flat (``prefix/blocks/0/attn/wq``)."""
    tree: dict = {}
    for key in inputs.files:
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = inputs[key]
    if "blocks" in tree:
        tree["blocks"] = tuple(tree["blocks"][str(i)] for i in range(len(tree["blocks"])))
    return tree


def _full(named: dict) -> dict:
    """Whole values of a dict of DTensors (every rank gathers)."""
    return {k: v.full_tensor().detach().clone() for k, v in named.items()}


def _grads(params) -> dict:
    from repro_torch.runtime.sharding import to_plain

    return {k: to_plain(p.grad).detach().clone() for k, p in params.named_parameters()}


def _olmoe(rank: int, world: int, out: str, mesh, cfg, inputs) -> tuple:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import TrainCheckpoints
    from repro_torch.models import steps as S
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.runtime import elastic
    from repro_torch.runtime import sharding as SH

    weights = _unstack(inputs, "params")
    batch = {"tokens": torch.from_numpy(inputs["tokens"]),
             "labels": torch.from_numpy(inputs["labels"])}
    params = params_from_jax(weights, cfg, "cpu", trainable=True)
    params, opt = S.place_train_state(params, cfg, mesh)
    placed = S.distribute_batch(batch, mesh)
    res, js = {}, {"placements": {k: str(tuple(p.placements))
                                  for k, p in params.named_parameters()}}
    with SH.use_mesh(mesh):
        loss, _ = S.make_loss_fn(cfg)(params, placed)
    loss.backward()
    res.update({f"grad/{k}": g.numpy() for k, g in _grads(params).items()})
    js["loss0"] = float(loss.full_tensor())
    for p in params.parameters():
        p.grad = None
    step = S.make_train_step(cfg, cosine_with_warmup(*LR))
    with SH.use_mesh(mesh):
        for i in (1, 2):
            params, opt, m = step(params, opt, placed)
            js[f"loss{i}"] = float(m["loss"])
            js[f"grad_norm{i}"] = float(m["grad_norm"])
            res.update({f"step{i}/{k}": v.numpy()
                        for k, v in _full(dict(params.named_parameters())).items()})
    if world != 4:
        return res, js

    # serving under the mesh against the unsharded port, same weights
    plain = params_from_jax(weights, cfg, "cpu")
    prompt, one = {"tokens": batch["tokens"]}, {"tokens": batch["tokens"][:, :1]}
    pre, dec = S.make_prefill_step(cfg, 48), S.make_decode_step(cfg)
    want_last, caches, n = pre(plain, prompt)
    want_tok, want_logits, _ = dec(plain, one, caches, n)
    served = S.place_params(params_from_jax(weights, cfg, "cpu"), cfg, mesh, "tp")
    with SH.use_mesh(mesh):
        last, caches, n = pre(served, S.distribute_batch(prompt, mesh))
        tok, logits, caches = dec(served, S.distribute_batch(one, mesh), caches, n)
    js["prefill_rel"] = _rel(last.full_tensor(), want_last)
    js["decode_rel"] = _rel(logits.full_tensor(), want_logits)
    js["tokens_equal"] = bool(torch.equal(tok.full_tensor(), want_tok))
    res.update(prefill=last.full_tensor().numpy(), decode=logits.full_tensor().numpy())
    js["cache_placements"] = {k: str(tuple(v.placements)) for k, v in caches[0].items()}

    # a checkpoint of the trained state, written by every rank together
    TrainCheckpoints(CheckpointManager(os.path.join(out, "ckpt")), cfg).save(2, (params, opt))
    res.update({f"mu/{k}": v.numpy() for k, v in _full(opt.mu).items()})

    # remesh 4 -> 2 -> 1 -> 4: the whole values must not change
    from torch.distributed.device_mesh import DeviceMesh

    state = dict(params.named_parameters())
    whole = _full(state)
    meshes = [DeviceMesh("cpu", torch.arange(2).reshape(2, 1), mesh_dim_names=("data", "model")),
              DeviceMesh("cpu", torch.arange(1).reshape(1, 1), mesh_dim_names=("data", "model")),
              mesh]
    equal = []
    for new in meshes:
        state = elastic.remesh(state, new, SH.port_pspecs(state, cfg, new, "zero"))
        if new.get_coordinate() is None:  # not a rank of this mesh
            equal.append(None)
            continue
        equal.append(all(torch.equal(v.full_tensor(), whole[k]) for k, v in state.items()))
        js.setdefault("remesh_placements", []).append(
            str(tuple(state["blocks.0.attn.wq"].placements)))
    js["remesh_equal"] = equal
    return res, js


def _llama4(rank: int, world: int, out: str, mesh, cfg, inputs) -> tuple:
    from repro_torch.models import steps as S
    from repro_torch.models.convert import params_from_jax
    from repro_torch.runtime import sharding as SH

    weights = _unstack(inputs, "params")
    batch = {"tokens": torch.from_numpy(inputs["tokens"]),
             "labels": torch.from_numpy(inputs["labels"])}
    plain = params_from_jax(weights, cfg, "cpu", trainable=True)
    want, _ = S.make_loss_fn(cfg)(plain, batch)
    want.backward()
    params, _ = S.place_train_state(params_from_jax(weights, cfg, "cpu", trainable=True),
                                    cfg, mesh)
    with SH.use_mesh(mesh):
        loss, _ = S.make_loss_fn(cfg)(params, S.distribute_batch(batch, mesh))
    loss.backward()
    got, ref = _grads(params), _grads(plain)
    worst = {k: float((got[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30))
             for k in ref}
    res = {f"grad/{k}": g.numpy() for k, g in got.items()}
    js = {"loss": float(loss.full_tensor()), "want": float(want), "grad_rel": worst,
          "wq_placements": str(tuple(params["blocks"][0]["attn"]["wq"].placements))}

    # a prefill and one decode step on the TP specs: the caches' sequence
    # dim is on model, each rank writing the overlap of its slots
    plain = params_from_jax(weights, cfg, "cpu")
    served = S.place_params(params_from_jax(weights, cfg, "cpu"), cfg, mesh, "tp")
    tokens = batch["tokens"]
    prompt = {"tokens": tokens[:, :LLAMA4_PROMPT]}
    one = {"tokens": tokens[:, LLAMA4_PROMPT:LLAMA4_PROMPT + 1]}
    pre, dec = S.make_prefill_step(cfg, LLAMA4_MAX_LEN), S.make_decode_step(cfg)
    with torch.no_grad():
        w_last, w_caches, n = pre(plain, prompt)
        _, w_logits, w_caches = dec(plain, one, w_caches, n)
        with SH.use_mesh(mesh):
            last, caches, n = pre(served, S.distribute_batch(prompt, mesh))
            _, logits, caches = dec(served, S.distribute_batch(one, mesh), caches, n)
    res.update(prefill=last.full_tensor().numpy(), decode=logits.full_tensor().numpy())
    js.update(prefill_rel=_rel(last.full_tensor(), w_last),
              decode_rel=_rel(logits.full_tensor(), w_logits),
              cache_rel=max(_rel(c[k].full_tensor(), w[k]) for c, w in zip(caches, w_caches)
                            for k in c),
              cache_placements=str(tuple(caches[0]["k"].placements)))
    return res, js


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def scan_config(get_config, arch: str):
    """``arch``'s smoke config as the scans scenario runs it (``get_config``
    of either package)."""
    import dataclasses

    return dataclasses.replace(get_config(arch).smoke(), **SCAN_OVERRIDES[arch])


def _scans(rank: int, world: int, out: str, mesh, cfg, inputs) -> tuple:
    from repro_torch.configs import get_config
    from repro_torch.models import steps as S
    from repro_torch.models.convert import params_from_jax
    from repro_torch.runtime import sharding as SH

    res, js = {}, {}
    for arch in SCAN_ARCHS:
        cfg = scan_config(get_config, arch)
        weights = _unstack(inputs, f"{arch}/params")
        batch = {k: torch.from_numpy(inputs[f"{arch}/{k}"]) for k in ("tokens", "labels")}
        plain = params_from_jax(weights, cfg, "cpu", trainable=True)
        placed = S.place_params(params_from_jax(weights, cfg, "cpu", trainable=True), cfg,
                                mesh, "fsdp")
        want, _ = S.make_loss_fn(cfg)(plain, batch)
        want.backward()
        with SH.use_mesh(mesh):
            loss, _ = S.make_loss_fn(cfg)(placed, S.distribute_batch(batch, mesh))
        loss.backward()
        got, ref = _grads(placed), _grads(plain)
        res.update({f"{arch}/grad/{k}": g.numpy() for k, g in got.items()})
        row = {"loss": float(loss.full_tensor()), "want": float(want),
               "grad_rel": max(float((got[k] - ref[k]).abs().max()
                                     / ref[k].abs().max().clamp_min(1e-30)) for k in ref)}
        prompt = {"tokens": batch["tokens"]}
        one = {"tokens": batch["tokens"][:, :1]}
        pre, dec = S.make_prefill_step(cfg, 32), S.make_decode_step(cfg)
        with torch.no_grad():
            w_last, caches, n = pre(plain, prompt)
            _, w_step, _ = dec(plain, one, caches, n)
            with SH.use_mesh(mesh):
                last, caches, n = pre(placed, S.distribute_batch(prompt, mesh))
                _, step, caches = dec(placed, S.distribute_batch(one, mesh), caches, n)
        res.update({f"{arch}/prefill": last.full_tensor().numpy(),
                    f"{arch}/decode": step.full_tensor().numpy()})
        row.update(prefill_rel=_rel(last.full_tensor(), w_last),
                   decode_rel=_rel(step.full_tensor(), w_step),
                   state_placements={k: str(tuple(v.placements)) for k, v in caches[0].items()})
        js[arch] = row
    return res, js


def _rank(rank: int, scenario: str, world: int, out: str) -> None:
    _quiet()
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out, 'pg')}",
                           rank=rank, world_size=world)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(MESHES[(scenario, world)], ("data", "model"), "cpu")
    cfg = get_config(ARCH[scenario]).smoke()
    path = os.path.join(out, "inputs.npz")
    inputs = np.load(path) if os.path.exists(path) else None
    run = {"olmoe": _olmoe, "llama4": _llama4, "scans": _scans}[scenario]
    res, js = run(rank, world, out, mesh, cfg, inputs)
    if rank == 0:
        np.savez(os.path.join(out, "result.npz"), **res)
        with open(os.path.join(out, "result.json"), "w") as f:
            json.dump(js, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    scenario, world, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    mp.spawn(_rank, args=(scenario, world, out), nprocs=world)
