"""The comparisons that decide ``correct``, and the control's lower precision.

Every number compared is a worst case over what was checked, and each has
its limit in the cell's file under ``limits/``: the run is correct when
every number is at or under its limit.  A number that could not be read
(NaN, or a part missing) fails.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

E4M3_MAX = 448.0


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in f32 (NaN anywhere gives NaN)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs().max()
    if not torch.isfinite(got).all():
        return math.nan
    return float(diff / want.abs().max().clamp_min(1e-30))


def served_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best, over rows: ``ref_logits`` (..., V) f32 and
    ``served`` (...) token ids."""
    ref = ref_logits.float()
    best = ref.max(dim=-1).values
    got = torch.gather(ref, -1, served.long()[..., None])[..., 0]
    return float((best - got).max())


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude onto e4m3's largest), back in f32: an fp8 operand.
    Under autograd the gradient passes the rounding unchanged."""
    x = x.float()
    with torch.no_grad():
        scale = x.abs().max().clamp_min(1e-30) / E4M3_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach() if x.requires_grad else q


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of fp8 operands, accumulated in f32: the control's."""
    return fp8(a) @ fp8(b)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Each limit's number read, finite and at or under it."""
    for name, limit in limits.items():
        v: Optional[float] = numbers.get(name)
        if v is None or not math.isfinite(v) or v > limit:
            return False
    return True
