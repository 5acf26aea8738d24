"""AdamW written out in tensor ops, mixed-precision aware.

The JAX package's ``optim/adamw.py`` on dicts of tensors (name -> tensor,
as ``dict(module.named_parameters())`` gives them): the same defaults (b1
0.9, b2 0.95, eps 1e-8), global-norm clipping with ``+ 1e-9``, bias
correction in f32, weight decay ``wd * p32`` inside the lr product, and an
optional f32 master copy that is updated and then cast to each parameter's
dtype.  Not ``torch.optim.AdamW``: the master copy and the returned grad
norm are the reference's.

Unlike the reference, whose arrays are immutable, :func:`adamw_update`
updates in place to save memory: the moments and the master copy are
written into ``state``'s own tensors, and the parameters into ``params``'
tensors (under ``torch.no_grad``).  It works one leaf at a time, so its
temporaries are one leaf's f32 copies, not the model's.

DTensor leaves (a model under a mesh): each gradient is brought to its
moments' placements (ZeRO), the update runs on each rank's local shards
of the moments, master and gradient, and the parameter (FSDP) receives the
new shards redistributed to its own placements.  :func:`global_norm` sums
each rank's local squares (a leaf replicated over a mesh dim counted once)
and reduces the total over the mesh before the clip.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.runtime.sharding import is_dtensor

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor  # i32 0-d
    mu: Tree  # first moment, f32, like params
    nu: Tree  # second moment, f32, like params
    master: Optional[Tree]  # f32 master params (None when params are already f32)


def adamw_init(params: Tree, keep_master: bool = False) -> AdamWState:
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    master = ({k: p.detach().float().clone() for k, p in params.items()}
              if keep_master else None)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device), zeros,
                      {k: z.clone() for k, z in zeros.items()}, master)


def global_norm(grads: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total, mesh = None, None
    for g in grads.values():
        if is_dtensor(g):
            # this rank's shard, once per copy across the mesh dims that
            # replicate it; the total is reduced over the mesh below
            mesh = g.device_mesh
            copies = 1
            for i, pl in enumerate(g.placements):
                if pl.is_partial():
                    raise ValueError("global_norm of a partial gradient: reduce it first")
                if pl.is_replicate():
                    copies *= mesh.size(i)
            sq = torch.sum(torch.square(g.to_local().float())) / copies
        else:
            sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Partial

        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim).full_tensor()
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled by min(1, max_norm / (norm + 1e-9)) in f32, norm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return {k: g.float() * scale for k, g in grads.items()}, gnorm


def adamw_update(grads: Tree, state: AdamWState, params: Tree, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0, max_grad_norm: Optional[float] = None
                 ) -> Tuple[Tree, AdamWState, torch.Tensor]:
    """One AdamW step.  Returns (params, state, grad_norm): the same dicts
    and tensors, updated in place (grad_norm is 0 without clipping, as in
    the reference).  With ``state.master`` set the update runs on the f32
    master and each parameter becomes the master cast to its dtype."""
    device = state.step.device
    gnorm = torch.zeros((), dtype=torch.float32, device=device)
    scale = None
    if max_grad_norm is not None:
        gnorm = global_norm(grads)
        scale = torch.clamp(max_grad_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=device), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=device)
    with torch.no_grad():
        for name, p in params.items():
            m, v = state.mu[name], state.nu[name]
            ref = state.master[name] if state.master is not None else p
            g = grads[name]
            if is_dtensor(m):  # the update on this rank's shards of the leaf
                mesh, pl = m.device_mesh, tuple(m.placements)
                g = g.redistribute(mesh, pl).to_local()
                ref = ref.redistribute(mesh, pl) if tuple(ref.placements) != pl else ref
                m, v, ref = m.to_local(), v.to_local(), ref.to_local()
            g = g.float()
            if scale is not None:
                g = g * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            p32 = ref.float()
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            new = p32 - lr * (u + weight_decay * p32)
            if state.master is not None:
                ref.copy_(new)
            if is_dtensor(p):
                from torch.distributed.tensor import DTensor

                new_p = DTensor.from_local(new.to(p.dtype), mesh, pl, run_check=False)
                p.to_local().copy_(new_p.redistribute(mesh, p.placements).to_local())
            else:
                p.copy_(new.to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu, state.master), gnorm
