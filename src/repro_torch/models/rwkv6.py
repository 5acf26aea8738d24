"""RWKV-6 "Finch" time-mix and channel-mix (arXiv:2404.05892), in torch.

The JAX package's ``models/rwkv6.py`` with the same names, arguments and
layouts.  The time-mix recurrence per head (head dim N)::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state: N x N, f32)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with data-dependent per-channel decay ``w_t = exp(-exp(w0 + lora(x_t)))``.
Prefill (:func:`time_mix_chunked`) is one call of the hand-written chunked
scan through ``kernels.ops.rwkv6_chunk_scan`` (the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor) in place of the reference's
``lax.scan`` over chunks; decode (:func:`time_mix_decode`) is the plain
single-token recurrence, as it is plain jnp in the reference.  The decay
parameters, the bonus and the group-norm affine stay f32 in a bf16 model,
as the JAX initialisers make them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as K
from repro_torch.runtime import sharding as SH

from .layers import dense_init

LORA_RANK = 32


def rwkv_time_mix_params(generator, d_model: int, head_dim: int, dtype, device
                         ) -> Dict[str, torch.Tensor]:
    h = d_model // head_dim
    f32 = torch.float32

    def mu():  # token-shift interpolation coefficients per stream
        return dense_init(generator, (d_model,), f32, device, 0.2)

    return {
        "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_w": mu(), "mu_g": mu(),
        "w_r": dense_init(generator, (d_model, d_model), dtype, device),
        "w_k": dense_init(generator, (d_model, d_model), dtype, device),
        "w_v": dense_init(generator, (d_model, d_model), dtype, device),
        "w_g": dense_init(generator, (d_model, d_model), dtype, device),
        "w_o": dense_init(generator, (d_model, d_model), dtype, device),
        # data-dependent decay: w0 + tanh(x A) B  (low-rank, Finch eq. 6)
        "w0": torch.full((d_model,), -6.0, dtype=f32, device=device),
        "w_lora_a": dense_init(generator, (d_model, LORA_RANK), f32, device),
        "w_lora_b": dense_init(generator, (LORA_RANK, d_model), f32, device),
        "u": dense_init(generator, (h, head_dim), f32, device, 0.5),
        "ln_w": torch.ones(d_model, dtype=f32, device=device),
        "ln_b": torch.zeros(d_model, dtype=f32, device=device),
    }


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Previous token's activation (zeros / supplied carry at position 0)."""
    pad = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _streams(p, x, x_shift):
    xr = _mix(x, x_shift, p["mu_r"])
    xk = _mix(x, x_shift, p["mu_k"])
    xv = _mix(x, x_shift, p["mu_v"])
    xw = _mix(x, x_shift, p["mu_w"])
    xg = _mix(x, x_shift, p["mu_g"])
    r = xr @ p["w_r"]
    k = xk @ p["w_k"]
    v = xv @ p["w_v"]
    g = F.silu(xg @ p["w_g"])
    logw = -torch.exp(p["w0"] + torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"])
    return r, k, v, g, logw  # logw (B, S, D) f32: log of the decay in (0, 1)


def _heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, d // head_dim, head_dim)


def _group_norm(y: torch.Tensor, w, b, eps: float = 64e-5) -> torch.Tensor:
    """LayerNorm per head (RWKV's GroupNorm with H groups); f32 out."""
    y32 = y.float()
    mean = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, unbiased=False)
    yn = (y32 - mean) * torch.rsqrt(var + eps)
    bsz, s, h, n = y.shape
    return yn.reshape(bsz, s, h * n) * w + b


def time_mix_chunked(p, x: torch.Tensor, head_dim: int, chunk: int = 128,
                     state: Optional[torch.Tensor] = None,
                     x_prev: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time-mix.  Returns (out, final_state, last_x).

    x: (B, S, D); state: (B, H, N, N) f32, the carried state to start from
    (zeros when None).  S is padded to a multiple of ``chunk`` with
    state-neutral positions, and the scan is one
    ``kernels.ops.rwkv6_chunk_scan`` call at that chunk.
    """
    b, s, d = x.shape
    n = head_dim
    if s % chunk != 0:
        x = F.pad(x, (0, 0, 0, -s % chunk))
    sp = x.shape[1]
    x_shift = _token_shift(x, x_prev)
    r, k, v, g, logw = _streams(p, x, x_shift)
    if sp != s:
        # padded positions must be state-neutral: no contribution (k = 0)
        # and no decay (logw = 0), so the carried state is exactly the
        # state after the s real tokens.
        valid = (torch.arange(sp, device=x.device) < s)[None, :, None]
        if SH.is_dtensor(x):  # the where's backward reads the mask
            valid = SH.distribute(valid, x.device_mesh, ())
        k = torch.where(valid, k, torch.zeros((), dtype=k.dtype, device=k.device))
        logw = torch.where(valid, logw, 0.0)
    y, final_state = K.rwkv6_chunk_scan(_heads(r, n), _heads(k, n), _heads(v, n),
                                        _heads(logw, n), p["u"], chunk=chunk, s0=state)
    y = _group_norm(y[:, :s], p["ln_w"], p["ln_b"])
    out = (y.to(x.dtype) * g[:, :s]) @ p["w_o"]
    return out, final_state, x[:, s - 1]


def time_mix_decode(p, x: torch.Tensor, head_dim: int, state: torch.Tensor,
                    x_prev: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token: x (B, 1, D), state (B, H, N, N) f32, x_prev (B, D) the
    last token's input activation.  Returns (out, new_state, last_x)."""
    b, _, d = x.shape
    n = head_dim
    h = d // n
    r, k, v, g, logw = _streams(p, x, x_prev[:, None])
    rh = _heads(r, n)[:, 0].float()  # (B, H, N)
    kh = _heads(k, n)[:, 0].float()
    vh = _heads(v, n)[:, 0].float()
    w = torch.exp(_heads(logw, n)[:, 0])
    kv = torch.einsum("bhn,bhm->bhnm", kh, vh)
    y = torch.einsum("bhn,bhnm->bhm", rh, state + p["u"][None, :, :, None] * kv)
    new_state = state * w[..., None] + kv
    y = _group_norm(y.reshape(b, 1, h, n), p["ln_w"], p["ln_b"])
    out = (y.to(x.dtype) * g) @ p["w_o"]
    return out, new_state, x[:, 0]


def time_mix_reference(p, x, head_dim, state=None, x_prev=None):
    """Token-by-token oracle for tests (exact recurrence, O(S) python loop)."""
    b, s, d = x.shape
    if state is None:
        state = torch.zeros(b, d // head_dim, head_dim, head_dim, dtype=torch.float32,
                            device=x.device)
    if x_prev is None:
        x_prev = torch.zeros(b, d, dtype=x.dtype, device=x.device)
    outs = []
    for t in range(s):
        o, state, x_prev = time_mix_decode(p, x[:, t:t + 1], head_dim, state, x_prev)
        outs.append(o)
    return torch.cat(outs, dim=1), state, x_prev


# ---------------------------------------------------------------------------
# Channel mix (RWKV-6 FFN)
# ---------------------------------------------------------------------------


def channel_mix_params(generator, d_model: int, d_ff: int, dtype, device
                       ) -> Dict[str, torch.Tensor]:
    f32 = torch.float32
    return {
        "mu_k": dense_init(generator, (d_model,), f32, device, 0.2),
        "mu_r": dense_init(generator, (d_model,), f32, device, 0.2),
        "w_k": dense_init(generator, (d_model, d_ff), dtype, device),
        "w_v": dense_init(generator, (d_ff, d_model), dtype, device),
        "w_r": dense_init(generator, (d_model, d_model), dtype, device),
    }


def channel_mix(p, x: torch.Tensor, x_prev: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, last_x) — last_x is the decode carry."""
    xs = _token_shift(x, x_prev)
    xk = _mix(x, xs, p["mu_k"])
    xr = _mix(x, xs, p["mu_r"])
    k = torch.square(F.relu(xk @ p["w_k"]))
    return torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"]), x[:, -1]
