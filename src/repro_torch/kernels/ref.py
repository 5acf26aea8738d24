"""Plain torch oracles for the port's kernels (the allclose targets)."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """A @ B as one f32 product (TF32 off, as the tuner's executor sets it),
    cast to ``out_dtype`` (default: A's dtype)."""
    out = torch.matmul(a.float(), b.float())
    return out.to(out_dtype or a.dtype)
