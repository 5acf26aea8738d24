"""Plain torch oracles for the port's kernels (the allclose targets)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """A @ B as one f32 product (TF32 off, as the tuner's executor sets it),
    cast to ``out_dtype`` (default: A's dtype)."""
    out = torch.matmul(a.float(), b.float())
    return out.to(out_dtype or a.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Attention as one f32 softmax over every key: q (B, S, H, D), k and v
    (B, T, HKV, D); masked scores are -inf and a row with no visible key
    is 0.  Returns q's dtype."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(d)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = torch.arange(s, device=q.device)[:, None]
    kv_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window is not None:
        mask &= kv_pos > q_pos - window
    scores = torch.where(mask[None, None], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    out = torch.einsum("bhst,bthd->bshd", p, v.float())
    return out.to(q.dtype)


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
              u: torch.Tensor) -> tuple:
    """Token-by-token Finch recurrence from a zero state.  All args f32;
    r/k/v/logw (BH, S, N); u (BH, N).  Returns (y (BH, S, N), state
    (BH, N, N))."""
    bh, s, n = r.shape
    state = torch.zeros(bh, n, n, dtype=torch.float32, device=r.device)
    ys = []
    for t in range(s):
        kv = torch.einsum("bn,bm->bnm", k[:, t], v[:, t])
        ys.append(torch.einsum("bn,bnm->bm", r[:, t], state + u[:, :, None] * kv))
        state = state * torch.exp(logw[:, t])[..., None] + kv
    return torch.stack(ys, dim=1), state


def mamba_scan_ref(dtx: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> tuple:
    """Token-by-token selective scan from a zero state.  All args f32;
    dtx (B, S, C); da (B, S, C, N) log-decay; b/c (B, S, N).  Returns
    (y (B, S, C), state (B, C, N))."""
    bsz, s, ch = dtx.shape
    n = b.shape[-1]
    h = torch.zeros(bsz, ch, n, dtype=torch.float32, device=dtx.device)
    ys = []
    for t in range(s):
        u = dtx[:, t, :, None] * b[:, t, None, :]
        h = torch.exp(da[:, t]) * h + u
        ys.append(torch.einsum("bcn,bn->bc", h, c[:, t]))
    return torch.stack(ys, dim=1), h
