"""RWKV-6 "Finch" time-mix and channel-mix (arXiv:2404.05892), in torch.

The JAX package's ``models/rwkv6.py`` with the same names, arguments and
layouts, and Finch's published block beside it.  The time-mix recurrence
per head (head dim N)::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state: N x N, f32)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with data-dependent per-channel decay ``w_t = exp(-exp(w0 + lora(x_t)))``.
The five streams' inputs come from the token shift ``x_prev`` (the previous
position's input; the carried one, or zeros, at position 0).  The JAX
package's form (``ModelConfig.rwkv_mix_lora == 0``) mixes each stream with a
static coefficient, ``x_s = x + (x_prev - x) * mu_s``.  Finch's (section 4,
``ddlerp``; rank ``r_mix > 0``) makes the five coefficients data-dependent
through one shared LoRA::

    xx  = x_prev - x
    m   = tanh((x + xx * mu_x) A)                A (d, 5 r_mix)
    x_s = x + xx * (mu_s + m_s B_s)              B (5, r_mix, d), s in w, k, v, r, g
    logw = -exp(w0 + tanh(x_w D_a) D_b)          D_a (d, r_decay), D_b (r_decay, d), f32
    r, k, v = x_r W_r, x_k W_k, x_v W_v;  g = silu(x_g W_g)
    out = (groupnorm_H(wkv(r, k, v, logw, u)) * g) W_o

with ``m_s`` the s-th rank-r_mix slice of ``m``.  RWKV-LM's
``RWKV_Tmix_x060`` sets r_mix 64 and r_decay 128 at d_model 4096 (32 and 64
below it); the JAX package's decay LoRA has rank 32.  The channel-mix::

    k = relu(x_k W_k)^2;  out = sigmoid(x_r W_r) * (k W_v)

with ``x_k``, ``x_r`` static mixes of its own token shift.

The eight full-width products (time-mix r, k, v, g, o; channel-mix k, v,
r) go through ``layers.dense``: the plain ``@`` unless a tuned-schedule
registry is served, then ``tuned_einsum`` and, on the card, the tiled
matmul.  The LoRAs stay on ``layers.matmul`` (the decay's in f32).
Prefill (:func:`time_mix_chunked`) is one call of the hand-written chunked
scan through ``kernels.ops.rwkv6_chunk_scan`` (the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor) in place of the reference's
``lax.scan`` over chunks; decode (:func:`time_mix_decode`) is the plain
single-token recurrence, as it is plain jnp in the reference.  The decay
parameters, the bonus and the group-norm affine stay f32 in a bf16 model,
as the JAX initialisers make them; ddlerp's ``mu_x`` is f32 and its LoRA
is in the model's type.  Spans (``repro_torch.tracing``, device time):
``rwkv6.mix`` around the token shift, the mixes and the decay, up to the
projections, and ``rwkv6.scan`` around the scan.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as K
from repro_torch.runtime import sharding as SH
from repro_torch.tracing import span

from .layers import dense, dense_init, matmul, merge_heads, split_heads

LORA_RANK = 32  # the decay LoRA's rank by default (ModelConfig.rwkv_decay_lora)
STREAMS = ("w", "k", "v", "r", "g")  # ddlerp's order of the streams (RWKV_Tmix_x060)


def rwkv_time_mix_params(generator, d_model: int, head_dim: int, dtype, device,
                         mix_lora: int = 0, decay_lora: int = LORA_RANK
                         ) -> Dict[str, torch.Tensor]:
    """The time-mix's parameters; ``mix_lora > 0`` adds ddlerp's ``mu_x``
    and its LoRA ``mix_lora_a`` (d, 5 r_mix) and ``mix_lora_b`` (5, r_mix,
    d), drawn after the others (so the default ranks draw what the JAX
    package's initialisers do)."""
    h = d_model // head_dim
    f32 = torch.float32

    def mu():  # token-shift interpolation coefficients per stream
        return dense_init(generator, (d_model,), f32, device, 0.2)

    p = {
        "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_w": mu(), "mu_g": mu(),
        "w_r": dense_init(generator, (d_model, d_model), dtype, device),
        "w_k": dense_init(generator, (d_model, d_model), dtype, device),
        "w_v": dense_init(generator, (d_model, d_model), dtype, device),
        "w_g": dense_init(generator, (d_model, d_model), dtype, device),
        "w_o": dense_init(generator, (d_model, d_model), dtype, device),
        # data-dependent decay: w0 + tanh(x A) B  (low-rank, Finch eq. 6)
        "w0": torch.full((d_model,), -6.0, dtype=f32, device=device),
        "w_lora_a": dense_init(generator, (d_model, decay_lora), f32, device),
        "w_lora_b": dense_init(generator, (decay_lora, d_model), f32, device),
        "u": dense_init(generator, (h, head_dim), f32, device, 0.5),
        "ln_w": torch.ones(d_model, dtype=f32, device=device),
        "ln_b": torch.zeros(d_model, dtype=f32, device=device),
    }
    if mix_lora:
        p["mu_x"] = mu()
        p["mix_lora_a"] = dense_init(generator, (d_model, 5 * mix_lora), dtype, device)
        p["mix_lora_b"] = dense_init(generator, (5, mix_lora, d_model), dtype, device,
                                     mix_lora ** -0.5)
    return p


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Previous token's activation (zeros / supplied carry at position 0)."""
    pad = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _mixed(p, x, x_shift):
    """Each stream's input by name (r, k, v, g) and logw: Finch's ddlerp
    where ``p`` holds its LoRA, else a static mu a stream."""
    if "mix_lora_a" in p:
        xx = x_shift - x
        m = torch.tanh(matmul(x + xx * p["mu_x"].to(x.dtype), p["mix_lora_a"]))
        lora_b = p["mix_lora_b"]
        rank = lora_b.shape[1]
        xs = {s: x + xx * (p[f"mu_{s}"] + matmul(m[..., i * rank:(i + 1) * rank],
                                                 lora_b[i])).to(x.dtype)
              for i, s in enumerate(STREAMS)}
    else:
        xs = {s: _mix(x, x_shift, p[f"mu_{s}"]) for s in STREAMS}
    xw = xs.pop("w")
    logw = -torch.exp(p["w0"] + matmul(torch.tanh(matmul(xw.float(), p["w_lora_a"])),
                                         p["w_lora_b"]))
    return xs, logw  # logw (B, S, D) f32: log of the decay in (0, 1)


def _project(p, xs):
    """r, k, v and g from the mixed streams: four full-width products."""
    return (dense(xs["r"], p["w_r"]), dense(xs["k"], p["w_k"]), dense(xs["v"], p["w_v"]),
            F.silu(dense(xs["g"], p["w_g"])))


def _heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    return split_heads(x, x.shape[-1] // head_dim)


def _group_norm(y: torch.Tensor, w, b, eps: float = 64e-5) -> torch.Tensor:
    """LayerNorm per head (RWKV's GroupNorm with H groups); f32 out."""
    y32 = y.float()
    mean = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, unbiased=False)
    yn = (y32 - mean) * torch.rsqrt(var + eps)
    return merge_heads(yn) * w + b


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x (B, S, D)`` with ``n`` zero positions after S; a DTensor whose
    sequence is whole on each rank is padded shard by shard (torch 2.11's
    DTensor has no working rule for the pad)."""
    if SH.is_dtensor(x):
        return SH.local_call(lambda t: F.pad(t, (0, 0, 0, n)), (x,), (x.placements,),
                             (x.placements,))
    return F.pad(x, (0, 0, 0, n))


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
    # the sequence whole on each rank: the scan runs over it (its local_map
    # keeps it so), and DTensor pads a sharded one on no torch 2.11 rule
    x = SH.ashard(x, ("batch", None, None))
    if s % chunk != 0:
        x = _pad_seq(x, -s % chunk)
    sp = x.shape[1]
    with span("rwkv6.mix", device=True):
        xs, logw = _mixed(p, x, _token_shift(x, x_prev))
    r, k, v, g = _project(p, xs)
    del xs
    if sp != s:
        # padded positions must be state-neutral: no contribution (k = 0)
        # and no decay (logw = 0), so the carried state is exactly the
        # state after the s real tokens.
        valid = (torch.arange(sp, device=x.device) < s)[None, :, None]
        if SH.is_dtensor(x):  # the where's backward reads the mask
            valid = SH.distribute(valid, x.device_mesh, ())
        k = torch.where(valid, k, torch.zeros((), dtype=k.dtype, device=k.device))
        logw = torch.where(valid, logw, 0.0)
    with span("rwkv6.scan", device=True):
        y, final_state = K.rwkv6_chunk_scan(_heads(r, n), _heads(k, n), _heads(v, n),
                                            _heads(logw, n), p["u"], chunk=chunk, s0=state)
    y = _group_norm(y[:, :s], p["ln_w"], p["ln_b"])
    out = dense(y.to(x.dtype) * g[:, :s], p["w_o"])
    return out, final_state, x[:, s - 1]


def time_mix_decode(p, x: torch.Tensor, head_dim: int, state: torch.Tensor,
                    x_prev: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token: x (B, 1, D), state (B, H, N, N) f32, x_prev (B, D) the
    last token's input activation.  Returns (out, new_state, last_x)."""
    b, _, d = x.shape
    n = head_dim
    h = d // n
    with span("rwkv6.mix", device=True):
        xs, logw = _mixed(p, x, x_prev[:, None])
    r, k, v, g = _project(p, xs)
    rh = _heads(r, n)[:, 0].float()  # (B, H, N)
    kh = _heads(k, n)[:, 0].float()
    vh = _heads(v, n)[:, 0].float()
    w = torch.exp(_heads(logw, n)[:, 0])
    kv = torch.einsum("bhn,bhm->bhnm", kh, vh)
    y = torch.einsum("bhn,bhnm->bhm", rh, state + p["u"][None, :, :, None] * kv)
    new_state = state * w[..., None] + kv
    y = _group_norm(y.reshape(b, 1, h, n), p["ln_w"], p["ln_b"])
    out = dense(y.to(x.dtype) * g, p["w_o"])
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
    k = torch.square(F.relu(dense(xk, p["w_k"])))
    return torch.sigmoid(dense(xr, p["w_r"])) * dense(k, p["w_v"]), x[:, -1]
