"""Mamba selective SSM block (Jamba's attention-free mixer), in torch.

The JAX package's ``models/mamba.py`` with the same names, arguments and
layouts.  The continuous-time SSM is discretised per token::

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t     (h: d_inner x d_state, f32)
    y_t = C_t . h_t + D * x_t

with data-dependent (selective) dt, B and C.  Prefill (:func:`mamba_apply`)
is one call of the hand-written selective scan through
``kernels.ops.mamba_scan`` (the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor) in place of the reference's ``lax.scan`` over
chunks with an associative scan inside (under a mesh the reference's
constraints on the scan's buffers become the placements of the kernel's
``local_map``: d_inner over model); decode (:func:`mamba_decode`) is the
plain single-token recurrence, as it is plain jnp in the reference.  The
step-size projection, its bias, ``a_log`` and the skip ``d`` stay f32 in a
bf16 model, as the JAX initialiser makes them.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as K
from repro_torch.runtime.sharding import ashard

from .layers import dense_init, matmul


class MambaState(NamedTuple):
    h: torch.Tensor     # (B, d_inner, d_state) f32
    conv: torch.Tensor  # (B, d_conv - 1, d_inner) last inputs for the causal conv


def mamba_params(generator, d_model: int, d_state: int, d_conv: int, expand: int,
                 dtype, device) -> Dict[str, torch.Tensor]:
    d_inner = expand * d_model
    dt_rank = max(d_model // 16, 1)
    f32 = torch.float32
    a = torch.arange(1, d_state + 1, dtype=f32, device=device)[None].repeat(d_inner, 1)
    return {
        "in_proj": dense_init(generator, (d_model, 2 * d_inner), dtype, device),
        "conv_w": dense_init(generator, (d_conv, d_inner), dtype, device, 0.5),
        "conv_b": torch.zeros(d_inner, dtype=dtype, device=device),
        "x_proj": dense_init(generator, (d_inner, dt_rank + 2 * d_state), dtype, device),
        "dt_proj": dense_init(generator, (dt_rank, d_inner), f32, device),
        "dt_bias": torch.log(torch.expm1(torch.full((d_inner,), 1e-2, dtype=f32,
                                                    device=device))),
        "a_log": torch.log(a),  # A = -exp(a_log), (d_inner, d_state)
        "d": torch.ones(d_inner, dtype=f32, device=device),
        "out_proj": dense_init(generator, (d_inner, d_model), dtype, device),
    }


def _conv_causal(xs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  xs: (B, S, C); w: (K, C).  The reference's
    sum of shifted products, term by term in the activation dtype (a
    ``conv1d`` would accumulate in another order)."""
    k = w.shape[0]
    if carry is None:
        carry = torch.zeros((xs.shape[0], k - 1, xs.shape[2]), dtype=xs.dtype,
                            device=xs.device)
    xp = torch.cat([carry, xs], dim=1)
    s = xs.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b, xp[:, -(k - 1):]


def _ssm_inputs(p, xz: torch.Tensor):
    """Common projections.  xz: conv'd + silu'd x part, (B, S, d_inner).
    Returns dt (rounded to xz's dtype, as the reference keeps the
    full-sequence streams), and B and C as views of the ``x_proj`` output."""
    d_state = p["a_log"].shape[1]
    dt_rank = p["dt_proj"].shape[0]
    proj = matmul(xz, p["x_proj"])
    dt_low, bmat, cmat = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(matmul(dt_low.float(), p["dt_proj"]) + p["dt_bias"])  # f32
    return dt.to(xz.dtype), bmat, cmat


def mamba_apply(p, x: torch.Tensor, state: Optional[MambaState] = None,
                chunk: int = 64) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence (prefill) forward.  x: (B, S, D).  ``state`` carries the
    conv window and h in (zeros when None).  The scan is one
    ``kernels.ops.mamba_scan`` call with ``chunk`` tokens a tile (the
    ``"mamba"`` registry block may set it)."""
    xz, z = torch.chunk(matmul(x, p["in_proj"]), 2, dim=-1)
    xz, conv_out = _conv_causal(xz, p["conv_w"], p["conv_b"],
                                state.conv if state is not None else None)
    # d_inner stays model-sharded through the scan, as in the reference;
    # the scan's local_map (kernels/ops.py) keeps it so on each shard
    xz = ashard(F.silu(xz), ("batch", None, "model"))
    dt, bmat, cmat = _ssm_inputs(p, xz)
    dt = ashard(dt, ("batch", None, "model"))
    a = -torch.exp(p["a_log"])  # (d_inner, N)
    y, h_final = K.mamba_scan(xz, dt, a, bmat, cmat, chunk=chunk,
                              h0=state.h if state is not None else None)
    y = y + xz.float() * p["d"]  # skip term (f32)
    out = matmul(y.to(x.dtype) * F.silu(z), p["out_proj"])
    return out, MambaState(h_final, conv_out)


def mamba_decode(p, x: torch.Tensor, state: MambaState
                 ) -> Tuple[torch.Tensor, MambaState]:
    """Single-token step.  x: (B, 1, D)."""
    xz, z = torch.chunk(matmul(x, p["in_proj"]), 2, dim=-1)
    xz, conv_out = _conv_causal(xz, p["conv_w"], p["conv_b"], state.conv)
    xz = F.silu(xz)
    dt, bmat, cmat = _ssm_inputs(p, xz)
    a = -torch.exp(p["a_log"])
    dt0 = dt[:, 0].float()  # (B, d_inner)
    decay = torch.exp(dt0[..., None] * a[None])  # (B, d_inner, N)
    u = (dt0 * xz[:, 0].float())[..., None] * bmat[:, 0, None, :].float()
    h = state.h * decay + u
    y = (torch.einsum("bcn,bn->bc", h, cmat[:, 0].float())
         + xz[:, 0].float() * p["d"])
    out = matmul(y[:, None].to(x.dtype) * F.silu(z), p["out_proj"])
    return out, MambaState(h, conv_out)


def mamba_reference(p, x: torch.Tensor) -> Tuple[torch.Tensor, MambaState]:
    """Token-by-token oracle for tests (the plain recurrence, no kernel)."""
    b = x.shape[0]
    d_inner = p["out_proj"].shape[0]
    n = p["a_log"].shape[1]
    st = MambaState(
        torch.zeros(b, d_inner, n, dtype=torch.float32, device=x.device),
        torch.zeros(b, p["conv_w"].shape[0] - 1, d_inner, dtype=x.dtype, device=x.device))
    outs = []
    for t in range(x.shape[1]):
        o, st = mamba_decode(p, x[:, t:t + 1], st)
        outs.append(o)
    return torch.cat(outs, dim=1), st

