"""Learning-rate schedules: pure functions of the step.

A schedule takes an int or a 0-d tensor step.  For a tensor it returns an
f32 0-d tensor on the step's device, computed in f32 as the JAX package's
``optim/schedules.py`` computes it; for an int it returns a float (the same
f32 arithmetic, read back)."""
from __future__ import annotations

import math
from typing import Union

import torch

Step = Union[int, torch.Tensor]


def _as_f32(step: Step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def _out(step: Step, value: torch.Tensor):
    return value if isinstance(step, torch.Tensor) else float(value)


def constant(lr: float):
    def fn(step: Step):
        return _out(step, torch.full_like(_as_f32(step), lr))

    return fn


def cosine_with_warmup(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step: Step):
        s = _as_f32(step)
        warm = peak_lr * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return _out(step, torch.where(s < warmup, warm, cos))

    return fn
