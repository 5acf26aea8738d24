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
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

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
    total = None
    for g in grads.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
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
            g = grads[name].float()
            if scale is not None:
                g = g * scale
            m, v = state.mu[name], state.nu[name]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            ref = state.master[name] if state.master is not None else p
            p32 = ref.float()
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            new = p32 - lr * (u + weight_decay * p32)
            if state.master is not None:
                state.master[name].copy_(new)
            p.copy_(new.to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu, state.master), gnorm
