"""RWKV-6 "Finch" 7B as the benchmark runs it (arXiv:2404.05892, section 4),
in plain PyTorch, float32, TF32 off.

Written from the paper's equations and from nothing of the program: it
imports no module of the port and no kernel.  It reads the weights the
benchmark made (``yardstick/rwkv6.py``: stacked over layers, matrices
``(L, in, out)``, the head ``(V, d)``) and the token ids, widens each to f32
where it is used, and computes, for each layer ``l``::

    h     = rms(x) * g_attn[l]                       rms(x) = x / sqrt(mean(x^2) + 1e-6)
    xx    = shift(h) - h                             shift: the previous position, 0 at the first
    m     = tanh((h + xx * mu_x) A)                  A (d, 5 r), r = mix_lora
    h_s   = h + xx * (mu_s + m_s B_s)                s in w, k, v, r, g; m_s = m[:, s r:(s + 1) r]
    logw  = -exp(w0 + tanh(h_w Da) Db)               Da (d, decay_lora), Db (decay_lora, d)
    r, k, v = h_r Wr, h_k Wk, h_v Wv;  g = silu(h_g Wg)     heads of N = head_dim
    S_t   = diag(exp(logw_t)) S_{t-1} + k_t^T v_t    per head, S_{-1} = 0
    y_t   = r_t (S_{t-1} + diag(u) k_t^T v_t)
    x     = x + ((groupnorm_H(y) * ln_w + ln_b) * g) Wo      groupnorm eps 64e-5
    h     = rms(x) * g_ffn[l]
    xk, xr = h + (shift(h) - h) * cmu_k, h + (shift(h) - h) * cmu_r
    x     = x + sigmoid(xr Wcr) * (relu(xk Wck)^2 Wcv)

then ``logits = (rms(x) * g_final) Whead^T``.  The WKV recurrence runs in
an exactly equivalent chunked form (:func:`wkv`): within a chunk every
decay is the exponential of a sum of ``logw`` over the positions it spans
(each exponent <= 0, so nothing overflows), and the state crosses chunks
as the recurrence carries it.

Departures from the published model, the same as the program's block
(``configs/rwkv6-7b.json``, ``assumed``): RMSNorm pre-norms (with gains, no
bias) in place of Finch's LayerNorms, and no ``ln0`` after the embedding.

``matmul`` is where a lower precision is put for the fp8 control
(``yardstick.compare.fp8`` on both operands), and ``scan`` (with
:func:`wkv`'s ``state_dtype``) where the bf16 control puts logw and the
state in bf16; the defaults compute in f32.  Everything is computed a layer at a time, each layer's weights
widened to f32 as it runs, so that a prefill of the timed size fits beside
the program's weights.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .decoder import Matmul, embed, f32_matmul, logits, no_tf32, rms  # noqa: F401

#: the order of ddlerp's five streams in its LoRA (RWKV-LM ``RWKV_Tmix_x060``)
STREAMS = ("w", "k", "v", "r", "g")
GROUP_NORM_EPS = 64e-5
#: the channel-mix's activation, squared ReLU
ACT = lambda x: torch.square(torch.relu(x))  # noqa: E731
CHUNK = 32     # positions a chunk of the WKV form
SLAB = 16      # chunks whose pairwise decays are held at once


def shift(h: torch.Tensor) -> torch.Tensor:
    """The previous position's row, zeros at position 0: (B, S, d)."""
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
        u: torch.Tensor, chunk: int = CHUNK, slab: int = SLAB,
        state_dtype: torch.dtype = torch.float32):
    """The Finch recurrence from a zero state over r, k, v, logw (B, S, H, N)
    f32 with bonus u (H, N).  Returns y (B, S, H, N) and the final state
    (B, H, N, N).  ``state_dtype`` is where a lower precision is put for a
    control: logw, and the state wherever it crosses a chunk, are rounded
    to it (the default leaves both f32).

    Chunks of ``chunk`` positions (the tail padded with k = 0, logw = 0,
    which leaves the state as it was).  With c the inclusive sum of logw
    within a chunk and c' the exclusive one, for the chunk's positions t:

        y_t = (r_t * exp(c'_t)) S_0 + sum_{s < t} sum_n r_tn k_sn exp(c'_tn - c_sn) v_s
              + (sum_n r_tn u_n k_tn) v_t
        S_T = diag(exp(c_T)) S_0 + sum_s (k_s * exp(c_T - c_s))^T v_s

    which is the recurrence unrolled over the chunk."""
    b, s, h, n = r.shape
    pad = -s % chunk
    low = state_dtype != torch.float32
    if low:
        logw = logw.to(state_dtype).to(r.dtype)
    streams = []
    for t in (r, k, v, logw):
        t = F.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t
        streams.append(t.permute(0, 2, 1, 3).reshape(b * h, -1, chunk, n))   # (Z, C, T, N)
    r, k, v, lw = streams
    c = lw.cumsum(dim=2)
    c_ex = F.pad(c, (0, 0, 1, 0))[:, :, :-1]
    strict = torch.ones(chunk, chunk, dtype=torch.bool, device=r.device).tril(-1)
    y = ((r * u.repeat(b, 1)[:, None, None]) * k).sum(-1, keepdim=True) * v
    for c0 in range(0, r.shape[1], slab):
        sl = slice(c0, c0 + slab)
        expo = (c_ex[:, sl, :, None] - c[:, sl, None]).masked_fill(~strict[..., None],
                                                                   float("-inf"))
        att = (expo.exp_() * r[:, sl, :, None] * k[:, sl, None]).sum(-1)   # (Z, c, T, T)
        y[:, sl] += att @ v[:, sl]
        del expo, att
    last = c[:, :, -1:]
    inc = (k * torch.exp(last - c)).transpose(-1, -2) @ v                # (Z, C, N, N)
    decay = torch.exp(last[:, :, 0])                                     # (Z, C, N)
    state = torch.zeros(b * h, n, n, dtype=torch.float32, device=r.device)
    starts = torch.empty_like(inc)
    for ci in range(r.shape[1]):
        starts[:, ci] = state
        state = decay[:, ci, :, None] * state + inc[:, ci]
        if low:
            state = state.to(state_dtype).to(inc.dtype)
    y += (r * torch.exp(c_ex)) @ starts
    y = y.reshape(b, h, -1, n)[:, :, :s].permute(0, 2, 1, 3)
    return y, state.reshape(b, h, n, n)


def group_norm(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over each head's N (RWKV's GroupNorm of H groups): (B, S, H, N)
    -> (B, S, d)."""
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, unbiased=False)
    yn = (y - mean) * torch.rsqrt(var + GROUP_NORM_EPS)
    return yn.flatten(2) * w.float() + b.float()


def time_mix(model: Dict, w: Dict[str, torch.Tensor], l: int, h: torch.Tensor,
             matmul: Matmul, scan: Callable = wkv):
    """The layer's time-mix on its normed input h (B, S, d) f32: (out, final
    state (B, H, N, N)).  ``scan`` computes the recurrence (:func:`wkv`
    unless a control puts another in its place)."""
    bsz, s, d = h.shape
    n = model["head_dim"]
    rank = model["mix_lora"]
    xx = shift(h) - h
    m = torch.tanh(matmul(h + xx * w["mu_x"][l].float(), w["mix_lora_a"][l]))
    lora_b = w["mix_lora_b"][l]
    hs = {st: h + xx * (w[f"mu_{st}"][l].float()
                        + matmul(m[..., i * rank:(i + 1) * rank], lora_b[i]))
          for i, st in enumerate(STREAMS)}
    logw = -torch.exp(w["w0"][l].float()
                      + matmul(torch.tanh(matmul(hs["w"], w["decay_lora_a"][l])),
                               w["decay_lora_b"][l]))
    heads = (bsz, s, d // n, n)
    r = matmul(hs["r"], w["w_r"][l]).view(heads)
    k = matmul(hs["k"], w["w_k"][l]).view(heads)
    v = matmul(hs["v"], w["w_v"][l]).view(heads)
    g = F.silu(matmul(hs["g"], w["w_g"][l]))
    del hs, m
    y, state = scan(r, k, v, logw.view(heads), w["u"][l].float())
    y = group_norm(y, w["ln_w"][l], w["ln_b"][l])
    return matmul(y * g, w["w_o"][l]), state


def channel_mix(w: Dict[str, torch.Tensor], l: int, h: torch.Tensor,
                matmul: Matmul) -> torch.Tensor:
    xx = shift(h) - h
    xk = h + xx * w["cmix_mu_k"][l].float()
    xr = h + xx * w["cmix_mu_r"][l].float()
    k = ACT(matmul(xk, w["cmix_w_k"][l]))
    return torch.sigmoid(matmul(xr, w["cmix_w_r"][l])) * matmul(k, w["cmix_w_v"][l])


def hidden(model: Dict, w: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
           matmul: Matmul = f32_matmul, on_state: Optional[Callable] = None,
           scan: Callable = wkv) -> torch.Tensor:
    """The final-normed hidden states (B, S, d) f32; ``on_state(l, s, xt,
    xc)`` sees each layer's final WKV state (B, H, N, N) and its two
    token-shift carries, the last position's normed inputs of the time-mix
    and of the channel-mix (B, d)."""
    x = embed(model, w, inputs)
    for l in range(model["n_layers"]):
        h = rms(x, w["norm_attn"][l])
        out, state = time_mix(model, w, l, h, matmul, scan)
        x = x + out
        xt = h[:, -1]
        h = rms(x, w["norm_ffn"][l])
        x = x + channel_mix(w, l, h, matmul)
        if on_state is not None:
            on_state(l, state, xt, h[:, -1])
        del out, state, h
    return rms(x, w["final_norm"])


def prefill(model: Dict, w: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
            matmul: Matmul = f32_matmul, on_state: Optional[Callable] = None,
            all_positions: bool = False, scan: Callable = wkv) -> torch.Tensor:
    """The last position's logits (B, V) f32, or every position's (B, S, V)
    with ``all_positions``."""
    with torch.no_grad():
        h = hidden(model, w, inputs, matmul, on_state, scan)
        return logits(w, h if all_positions else h[:, -1], matmul)
