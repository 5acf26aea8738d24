"""Gradient compression: int8 quantisation with error feedback.

The JAX package's ``runtime/compress.py`` on dicts of tensors: each leaf
of ``grads + ef`` is quantised to int8 with one scale a leaf (max |x| / 127
+ 1e-12), and the quantisation residual becomes the next step's error
feedback, which the caller carries (in the train state, so that it
survives checkpoints).  ``torch.round`` rounds half to even, as
``jnp.round`` does.  The transform is the arithmetic on each leaf (under a
mesh, on DTensor leaves); the gradients' reduction has already run."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_init(params: Tree) -> Tree:
    """f32 zeros like each parameter (a DTensor's in its placements)."""
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def compress_grads(grads: Tree, ef: Tree) -> Tuple[Tree, Tree]:
    """Quantise (grads + ef) to int8; the residual becomes the new ef.
    Returns (dequantised grads f32, new ef)."""
    deq, new_ef = {}, {}
    for k, g in grads.items():
        x = g.float() + ef[k]
        d = dequantize_int8(*quantize_int8(x))
        deq[k] = d
        new_ef[k] = g.float() + ef[k] - d
    return deq, new_ef
