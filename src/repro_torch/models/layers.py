"""Core model primitives of the port, as torch functions on tensors.

The JAX package's ``models/layers.py`` with the same names, arguments and
layouts (q ``(B, S, H, D)``, k/v ``(B, T, HKV, D)``, weights ``(in, out)``),
so converted weights give the same numbers.  Norms and softmax accumulate in
f32 whatever the activation dtype.  Every prefill and training attention
(S > 1) runs the hand-written flash-attention kernel through
``kernels.ops.flash_attention`` (under grad its ``autograd.Function``, whose
backward is the flash backward kernel);
decode (S == 1) is plain torch, as it is plain jnp in the reference.
Dense sites go through ``kernels.ops.tuned_einsum`` while a tuned-schedule
registry is being served.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as K

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(generator: Optional[torch.Generator], shape: Sequence[int], dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) (or ``scale``) weights drawn in f32 from
    ``generator`` on ``device`` (the generator must live there; ``None``
    with ``device="meta"`` only shapes the tensor)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (w * s).to(dtype)


# ---------------------------------------------------------------------------
# Tuned-serving hook: matmul sites route through the schedule registry
# ---------------------------------------------------------------------------


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` — the model's matmul hot path.

    While a tuned-schedule registry is served (``kernels.ops.serving``) the
    contraction goes through :func:`repro_torch.kernels.ops.tuned_einsum`
    (registry lookup; a hit on the card launches the tiled-matmul kernel);
    otherwise it is the plain ``@``."""
    if K.serving_registry() is None:
        return x @ w
    free = "abce"[: x.ndim - 1]  # skip k/n (bound in the spec)
    return K.tuned_einsum(f"{free}k,kn->{free}n", x, w)


# ---------------------------------------------------------------------------
# RMSNorm, RoPE
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:  # gemma parameterization: weight stored as (w - 1)
        w = w + 1.0
    return (y * w).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (D/2,)
    ang = positions[..., None].float() * freqs                   # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                           # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, T, HKV, D) -> (B, T, HKV*groups, D)."""
    return k if groups == 1 else k.repeat_interleave(groups, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0, kv_len: Optional[int] = None,
              window: Optional[int] = None, softcap: Optional[float] = None,
              kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B, S, HQ, D) over k, v (B, T, HKV, D); HQ % HKV == 0.

    ``q_offset``: absolute position of q[0] — decode (S=1, offset=cache
    length) or prefill (0).  ``window``: sliding-window size; a query at
    position p sees [p-window+1, p].  ``kv_len``: valid cache length
    (trailing slots masked).  ``kv_positions`` (decode only): the absolute
    position each of the T cache slots holds, negative for a slot never
    written (a sliding-window ring cache); None means slot t holds position
    t.  Returns (B, S, HQ, D) in v's dtype.

    S == 1 is the plain decode branch.  S > 1 with ``q_offset == 0`` and no
    ``kv_len`` (every prefill self-attention) is the flash-attention kernel.
    Any other S > 1 call raises: attention of a block of queries over a
    cache is not ported (ROADMAP.md, A4b).  The kernel applies
    1/sqrt(D); there is no ``scale`` argument, and the reference's
    ``q_block``/``kv_block`` are the "fa" registry block here.
    """
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    if s == 1:
        # decode: one query row, (B, H, 1, T) scores are tiny
        scale = torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype, device=q.device)
        kv_pos = torch.arange(t, device=q.device) if kv_positions is None else kv_positions
        kvl = t if kv_len is None else kv_len
        scores = torch.einsum("bqhd,bthd->bhqt", (q * scale).float(),
                              _repeat_kv(k, groups).float())
        scores = _softcap(scores, softcap)
        mask = (kv_pos < kvl) & (kv_pos >= 0)
        if causal:
            mask &= kv_pos <= q_offset
        if window is not None:
            mask &= kv_pos > q_offset - window
        scores = torch.where(mask[None, None, None], scores, -1e30)
        p = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqt,bthd->bqhd", p.to(v.dtype), _repeat_kv(v, groups))
    if q_offset != 0 or kv_len is not None or kv_positions is not None:
        raise NotImplementedError(
            "attention of S > 1 queries at an offset or over a partly filled "
            "cache is not ported (ROADMAP.md, A4b); prefill calls it "
            "with q_offset=0 and kv_len=None")
    return K.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap).to(v.dtype)


# ---------------------------------------------------------------------------
# Attention layer (GQA, RoPE, optional qk-norm / bias)
# ---------------------------------------------------------------------------


def attn_params(generator, cfg, dtype, device, cross: bool = False
                ) -> Dict[str, torch.Tensor]:
    """q/k/v/o projections (+bias, +qk-norm weights).  ``cross``: k and v
    project the encoder's ``d_cross``-wide states (where the config has one)."""
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    kv_in = cfg.d_cross if (cross and cfg.d_cross) else d
    p = {
        "wq": dense_init(generator, (d, hq * hd), dtype, device),
        "wk": dense_init(generator, (kv_in, hkv * hd), dtype, device),
        "wv": dense_init(generator, (kv_in, hkv * hd), dtype, device),
        "wo": dense_init(generator, (hq * hd, d), dtype, device),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros(hq * hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(hkv * hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(hkv * hd, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    return p


def attn_qkv(p, cfg, x: torch.Tensor, kv_src: Optional[torch.Tensor] = None,
             positions: Optional[torch.Tensor] = None, rope: bool = True):
    """Project to q/k/v heads (+bias, +qk-norm, +rope).  ``kv_src``: the
    states k and v project (the encoder, for cross-attention); x if None."""
    b, s = x.shape[:2]
    hd = cfg.head_dim_
    kv_src = x if kv_src is None else kv_src
    q = dense(x, p["wq"])
    k = dense(kv_src, p["wk"])
    v = dense(kv_src, p["wv"])
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, kv_src.shape[1], cfg.n_kv_heads, hd)
    v = v.reshape(b, kv_src.shape[1], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu}


def mlp_params(generator, d_model: int, d_ff: int, dtype, device
               ) -> Dict[str, torch.Tensor]:
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), dtype, device),
        "w_up": dense_init(generator, (d_model, d_ff), dtype, device),
        "w_down": dense_init(generator, (d_ff, d_model), dtype, device),
    }


def mlp_apply(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = _ACTS[act](dense(x, p["w_gate"]))
    return dense(g * dense(x, p["w_up"]), p["w_down"])


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_params(generator, vocab: int, d_model: int, dtype, device
                 ) -> Dict[str, torch.Tensor]:
    return {"table": dense_init(generator, (vocab, d_model), dtype, device, scale=1.0)}


def embed_apply(p, tokens: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    x = p["table"][tokens]
    if scale is not None:
        x = x * torch.tensor(scale, dtype=x.dtype, device=x.device)
    return x


LOGITS_CHUNK = 32768  # vocab rows widened to f32 at once by logits_apply


def logits_apply(embed_p, x: torch.Tensor, head_p: Any = None,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """f32 logits ``x (B, S, D) . table (V, D)`` (bf16 operands are
    multiplied exactly and summed in f32, as ``preferred_element_type``)."""
    table = head_p if head_p is not None else embed_p["table"]
    if K.serving_registry() is not None:
        logits = K.tuned_einsum("bsd,vd->bsv", x, table, out_dtype=torch.float32)
    else:
        # the table is widened to f32 a slice of LOGITS_CHUNK rows at a time:
        # a 256k x 8192 head would otherwise add an 8.4 GB f32 copy
        xf = x.float()
        logits = torch.empty(*x.shape[:-1], table.shape[0], dtype=torch.float32,
                             device=x.device)
        for v0 in range(0, table.shape[0], LOGITS_CHUNK):
            logits[..., v0:v0 + LOGITS_CHUNK] = torch.einsum(
                "bsd,vd->bsv", xf, table[v0:v0 + LOGITS_CHUNK].float())
    return _softcap(logits, softcap)
