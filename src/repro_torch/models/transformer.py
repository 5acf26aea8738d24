"""Model assembly of the port: embeddings -> layers -> LM head.

The JAX package stacks each period position's parameters over
``n_periods`` and runs ``lax.scan`` over periods; here every layer is one
:class:`ParamTree` in an ``nn.ModuleList`` (layer ``i`` is period
``i // len(period)``, position ``i % len(period)``) and the scan is a
Python loop.  Parameters are read by name as in the JAX pytree
(``p["attn"]["wq"]``, ``params.get("lm_head")``), and
``models/convert.py`` carries a JAX pytree across unchanged.

The port runs every layer kind of the JAX package: attention (global and
sliding-window), cross-attention (self-attention, then attention over the
encoder states ``batch["encoder"]``, llama-3.2-vision's), RWKV-6 time-mix +
channel-mix and Mamba mixers, dense MLP and MoE FFNs.  Sharding annotations
(``ashard``) are dropped until ``runtime/sharding.py`` is ported.  Entry
points:

  * :func:`forward`        — full-sequence logits (prefill)
  * :func:`decode_step`    — one token against the cache
  * :func:`init_cache`     — allocate the decode cache

The cache is the JAX layout (one dict per period position, leaves stacked
over ``n_periods``: attention ``k``/``v`` ``(n_periods, B, buf, HKV, hd)``,
a cross layer also the encoder's projections ``ck``/``cv`` ``(n_periods,
B, n_cross_tokens, HKV, hd)``, RWKV-6 ``s`` ``(n_periods, B, H, N, N)`` f32
and ``xt``/``xc`` ``(n_periods, B, D)``, Mamba ``h`` ``(n_periods, B, d_inner, N)`` f32 and
``conv`` ``(n_periods, B, d_conv - 1, d_inner)``), and **prefill and decode
write into it in place**: the caches passed in are the caches returned.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import (
    ATTN,
    ATTN_LOCAL,
    CROSS_ATTN,
    DENSE,
    MAMBA,
    MOE,
    RWKV6,
    LayerSpec,
    ModelConfig,
)

from . import layers as L
from . import mamba as M
from . import moe as X
from . import rwkv6 as R

def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a layer kind the schema does not have."""
    for spec in cfg.period:
        if (spec.mixer not in (ATTN, ATTN_LOCAL, CROSS_ATTN, RWKV6, MAMBA)
                or spec.ffn not in (DENSE, MOE)):
            raise ValueError(f"unknown layer kind {spec}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """Named parameters, nested like the JAX pytree's dicts: ``p["wq"]``,
    ``"lm_head" in p``, ``p.get("lm_head")``.  Serving only, so nothing
    requires a gradient."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val))
            elif isinstance(val, nn.Module):
                self.add_module(name, val)
            else:
                self.register_parameter(name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default


def make_params(top: Dict[str, Any], blocks: List[Dict[str, Any]]) -> ParamTree:
    """The model's parameters from plain dicts of tensors: ``top`` (embed,
    final_norm[, lm_head]) and one dict per layer, in layer order."""
    return ParamTree({**top, "blocks": nn.ModuleList(ParamTree(b) for b in blocks)})


def _block_init(generator, spec: LayerSpec, cfg: ModelConfig, device) -> Dict[str, Any]:
    dt = _dtype(cfg)
    d = cfg.d_model
    p: Dict[str, Any] = {"norm_attn": torch.ones(d, dtype=dt, device=device),
                         "norm_ffn": torch.ones(d, dtype=dt, device=device)}
    if cfg.post_norm:
        p["post_attn"] = torch.ones(d, dtype=dt, device=device)
        p["post_ffn"] = torch.ones(d, dtype=dt, device=device)
    if spec.mixer == RWKV6:
        p["rwkv"] = R.rwkv_time_mix_params(generator, d, cfg.rwkv_head_dim, dt, device)
    elif spec.mixer == MAMBA:
        p["mamba"] = M.mamba_params(generator, d, cfg.ssm_d_state, cfg.ssm_d_conv,
                                    cfg.ssm_expand, dt, device)
    else:
        p["attn"] = L.attn_params(generator, cfg, dt, device)
        if spec.mixer == CROSS_ATTN:
            p["cross"] = L.attn_params(generator, cfg, dt, device, cross=True)
            p["norm_cross"] = torch.ones(d, dtype=dt, device=device)
    if spec.ffn == MOE:
        p["moe"] = X.moe_params(generator, d, cfg.moe, dt, device)
    elif spec.mixer == RWKV6:
        p["cmix"] = R.channel_mix_params(generator, d, cfg.d_ff, dt, device)
    else:
        p["mlp"] = L.mlp_params(generator, d, cfg.d_ff, dt, device)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device="cuda") -> ParamTree:
    """Random weights from ``generator`` (which must live on ``device``).
    The JAX package's initialisers, not its random numbers: parity tests
    carry JAX weights across with ``models.convert.params_from_jax``."""
    check_supported(cfg)
    dt = _dtype(cfg)
    top: Dict[str, Any] = {
        "embed": L.embed_params(generator, cfg.vocab, cfg.d_model, dt, device),
        "final_norm": torch.ones(cfg.d_model, dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        top["lm_head"] = L.dense_init(generator, (cfg.vocab, cfg.d_model), dt, device, 1.0)
    n = len(cfg.period)
    blocks = [_block_init(generator, cfg.period[i % n], cfg, device)
              for i in range(cfg.n_layers)]
    return make_params(top, blocks)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters :func:`init_params` makes (shapes only, on the meta device).
    ``active_only``: a routed MoE expert tensor counts ``top_k / n_experts``
    of its size (not the router, not a shared expert), the JAX package's rule."""
    total = 0
    for name, p in init_params(cfg, None, "meta").named_parameters():
        n = p.numel()
        if (active_only and cfg.moe is not None and ".moe." in f".{name}."
                and "shared" not in name and "router" not in name):
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        total += n
    return total


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"
               ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Decode cache: one dict per period position, leaves stacked over
    ``n_periods``.  Attention keeps ``k``/``v`` ``(n_periods, batch, buf,
    HKV, hd)``, where a sliding-window layer has ``buf = min(max_len, window)``
    slots used as a ring (position p in slot ``p % buf``, unlike the JAX
    package's clamped last slot); RWKV-6 keeps the f32 state ``s`` ``(n_periods, batch, H, N, N)``
    and the token-shift carries ``xt`` (time-mix) and ``xc`` (channel-mix)
    ``(n_periods, batch, D)``; Mamba keeps the f32 state ``h``
    ``(n_periods, batch, d_inner, N)`` and the conv window ``conv``
    ``(n_periods, batch, d_conv - 1, d_inner)``; a cross layer also keeps the
    encoder's k/v projections ``ck``/``cv`` ``(n_periods, batch,
    n_cross_tokens, HKV, hd)``, written at prefill and read at decode."""
    check_supported(cfg)
    dt = _dtype(cfg)
    caches = []
    for spec in cfg.period:
        if spec.mixer == RWKV6:
            n = cfg.rwkv_head_dim
            caches.append({
                "s": torch.zeros((cfg.n_periods, batch, cfg.d_model // n, n, n),
                                 dtype=torch.float32, device=device),
                "xt": torch.zeros((cfg.n_periods, batch, cfg.d_model), dtype=dt,
                                  device=device),
                "xc": torch.zeros((cfg.n_periods, batch, cfg.d_model), dtype=dt,
                                  device=device)})
            continue
        if spec.mixer == MAMBA:
            d_inner = cfg.ssm_expand * cfg.d_model
            caches.append({
                "h": torch.zeros((cfg.n_periods, batch, d_inner, cfg.ssm_d_state),
                                 dtype=torch.float32, device=device),
                "conv": torch.zeros((cfg.n_periods, batch, cfg.ssm_d_conv - 1, d_inner),
                                    dtype=dt, device=device)})
            continue
        win = spec.window if spec.mixer == ATTN_LOCAL else None
        buf = min(max_len, win) if win else max_len
        shape = (cfg.n_periods, batch, buf, cfg.n_kv_heads, cfg.head_dim_)
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
        if spec.mixer == CROSS_ATTN:
            xshape = (cfg.n_periods, batch, max(cfg.n_cross_tokens, 1), cfg.n_kv_heads,
                      cfg.head_dim_)
            c["ck"] = torch.zeros(xshape, dtype=dt, device=device)
            c["cv"] = torch.zeros(xshape, dtype=dt, device=device)
        caches.append(c)
    return tuple(caches)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _apply_rwkv(p, cfg, h, cache, decode):
    """RWKV-6 time-mix on normed input ``h``; writes ``cache`` (one layer's
    s/xt views) in place.  Prefill starts from the cache's state and carry,
    as the reference does (zeros in a fresh cache)."""
    if decode:
        out, s2, xt = R.time_mix_decode(p["rwkv"], h, cfg.rwkv_head_dim, cache["s"],
                                        cache["xt"])
    else:
        out, s2, xt = R.time_mix_chunked(
            p["rwkv"], h, cfg.rwkv_head_dim,
            state=cache["s"] if cache is not None else None,
            x_prev=cache["xt"] if cache is not None else None)
    if cache is not None:
        cache["s"].copy_(s2)
        cache["xt"].copy_(xt)
    return out


def _apply_mamba(p, h, cache, decode):
    """The Mamba mixer on normed input ``h``; writes ``cache`` (one layer's
    h/conv views) in place.  Prefill starts from the cache's state and conv
    window, as the reference does (zeros in a fresh cache)."""
    st = M.MambaState(cache["h"], cache["conv"]) if cache is not None else None
    if decode:
        out, st2 = M.mamba_decode(p["mamba"], h, st)
    else:
        out, st2 = M.mamba_apply(p["mamba"], h, st)
    if cache is not None:
        cache["h"].copy_(st2.h)
        cache["conv"].copy_(st2.conv)
    return out


def _apply_cross(p, cfg, h, out, cache, encoder, decode):
    """A cross layer's second half, after its self-attention ``out``
    (projected by ``wo``): ``norm_cross`` on the residual, then non-causal
    attention over the encoder's projections, without RoPE.  Prefill
    projects ``encoder`` and writes ``ck``/``cv`` in place; decode reads them."""
    hx = L.rms_norm(h + out.to(h.dtype), p["norm_cross"])
    if decode:
        ck, cv = cache["ck"], cache["cv"]
        qx = L.dense(hx, p["cross"]["wq"]).reshape(*hx.shape[:2], cfg.n_heads,
                                                   cfg.head_dim_)
    else:
        qx, ck, cv = L.attn_qkv(p["cross"], cfg, hx, kv_src=encoder, rope=False)
        if cache is not None:
            cache["ck"].copy_(ck)
            cache["cv"].copy_(cv)
    xout = L.attention(qx, ck, cv, causal=False)
    return out + L.dense(xout.reshape(*h.shape[:2], -1), p["cross"]["wo"]).to(out.dtype)


def _apply_mixer(spec, p, cfg, h, cache, cache_len, positions, encoder, decode):
    """The mixer on normed input ``h``; writes ``cache`` (one layer's
    views) in place."""
    if spec.mixer == RWKV6:
        return _apply_rwkv(p, cfg, h, cache, decode)
    if spec.mixer == MAMBA:
        return _apply_mamba(p, h, cache, decode)
    q, k, v = L.attn_qkv(p["attn"], cfg, h, positions=positions)
    window = spec.window if spec.mixer == ATTN_LOCAL else None
    if not decode:
        out = L.attention(q, k, v, causal=True, window=window, softcap=cfg.attn_softcap)
        if cache is not None:
            buf, s = cache["k"].shape[1], k.shape[1]
            if buf >= s:
                cache["k"][:, :s] = k
                cache["v"][:, :s] = v
            else:  # a windowed cache is a ring: the last buf keys, position p in slot p % buf
                cache["k"].copy_(torch.roll(k[:, -buf:], shifts=s % buf, dims=1))
                cache["v"].copy_(torch.roll(v[:, -buf:], shifts=s % buf, dims=1))
    else:
        buf = cache["k"].shape[1]
        kv_positions = None
        if window is None:
            # jax.lax.dynamic_update_slice clamps the start so the update fits
            at = min(cache_len, buf - 1)
        else:
            # the ring: position cache_len goes to slot cache_len % buf, and
            # slot j then holds the latest position p <= cache_len with
            # p % buf == j (negative: never written)
            at = cache_len % buf
            kv_positions = cache_len - (cache_len - torch.arange(buf, device=h.device)) % buf
        cache["k"][:, at:at + 1] = k
        cache["v"][:, at:at + 1] = v
        out = L.attention(q, cache["k"], cache["v"], causal=True, q_offset=cache_len,
                          kv_len=cache_len + 1, window=window,
                          softcap=cfg.attn_softcap, kv_positions=kv_positions)
    out = L.dense(out.reshape(*h.shape[:2], -1), p["attn"]["wo"])
    if spec.mixer == CROSS_ATTN:
        return _apply_cross(p, cfg, h, out, cache, encoder, decode)
    return out


def _apply_ffn(spec, p, cfg, h, cache, decode):
    """The FFN on normed input ``h``.  Returns (out, aux): aux is the MoE
    layer's ``moe_aux_loss + moe_z_loss`` (f32 scalar), None for a dense
    FFN."""
    if spec.ffn == MOE:
        out, aux = X.moe_apply(p["moe"], h, cfg.moe, cfg.act)
        return out, aux["moe_aux_loss"] + aux["moe_z_loss"]
    if spec.mixer != RWKV6:
        return L.mlp_apply(p["mlp"], h, cfg.act), None
    # the channel-mix token shift reads the carry only in decode; prefill
    # starts from zeros whatever the cache holds, as the reference does
    xc = cache["xc"] if (cache is not None and decode) else None
    out, last = R.channel_mix(p["cmix"], h, x_prev=xc)
    if cache is not None:
        cache["xc"].copy_(last)
    return out, None


def _apply_block(spec, p, cfg, x, cache, cache_len, positions, encoder, decode):
    """One layer.  Returns (x, aux) with aux as :func:`_apply_ffn`'s."""
    h = L.rms_norm(x, p["norm_attn"])
    mix = _apply_mixer(spec, p, cfg, h, cache, cache_len, positions, encoder, decode)
    if cfg.post_norm:
        mix = L.rms_norm(mix, p["post_attn"])
    if cfg.parallel_block:
        ff, aux = _apply_ffn(spec, p, cfg, h, cache, decode)
        return x + mix.to(x.dtype) + ff.to(x.dtype), aux
    x = x + mix.to(x.dtype)
    ff, aux = _apply_ffn(spec, p, cfg, L.rms_norm(x, p["norm_ffn"]), cache, decode)
    if cfg.post_norm:
        ff = L.rms_norm(ff, p["post_ffn"])
    return x + ff.to(x.dtype), aux


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _embed_in(params, cfg, batch) -> torch.Tensor:
    if cfg.frontend == "tokens":
        scale = math.sqrt(cfg.d_model) if cfg.embed_scale else None
        return L.embed_apply(params["embed"], batch["tokens"], scale)
    # audio / stub frontends supply precomputed frame embeddings
    return batch["embeds"].to(_dtype(cfg))


def _run_layers(params, cfg, x, caches, cache_len, positions, encoder, decode):
    """Every layer in order.  Returns (x, aux): the sum over MoE layers of
    ``moe_aux_loss + moe_z_loss`` (f32 scalar, 0 without MoE layers)."""
    n = len(cfg.period)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params["blocks"]):
        per, pos = divmod(i, n)
        cache = (None if caches is None
                 else {name: t[per] for name, t in caches[pos].items()})
        x, layer_aux = _apply_block(cfg.period[pos], p, cfg, x, cache, cache_len,
                                    positions, encoder, decode)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


def hidden_states(params: ParamTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  caches: Optional[Tuple] = None
                  ) -> Tuple[torch.Tensor, Optional[Tuple], torch.Tensor]:
    """Full-sequence forward up to the final norm (no logits).  Returns
    (hidden (B, S, D), caches, aux_loss): aux_loss sums each MoE layer's
    ``moe_aux_loss + moe_z_loss`` (0 without MoE layers), as the
    reference's does.  A model with cross layers reads the encoder states
    ``batch["encoder"]`` ``(B, n_cross_tokens, d_cross)``."""
    x = _embed_in(params, cfg, batch)
    encoder = batch.get("encoder")
    if any(spec.mixer == CROSS_ATTN for spec in cfg.period):
        want = (x.shape[0], cfg.n_cross_tokens, cfg.d_cross)
        if encoder is None:
            raise ValueError(f"{cfg.name} has cross-attention layers: its forward and "
                             f"prefill need batch['encoder'] of shape {want}")
        if tuple(encoder.shape) != want:
            raise ValueError(f"batch['encoder'] is {tuple(encoder.shape)}; {cfg.name} "
                             f"takes {want}")
        encoder = encoder.to(_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x, aux = _run_layers(params, cfg, x, caches, 0, positions, encoder, decode=False)
    x = L.rms_norm(x, params["final_norm"])
    return x, caches, aux


def forward(params: ParamTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            caches: Optional[Tuple] = None
            ) -> Tuple[torch.Tensor, Optional[Tuple], torch.Tensor]:
    """Full-sequence forward (prefill when caches are given, written in
    place).  Returns (logits (B, S, V) f32, caches, aux_loss)."""
    x, caches, aux = hidden_states(params, cfg, batch, caches)
    logits = L.logits_apply(params["embed"], x, params.get("lm_head"), cfg.logit_softcap)
    return logits, caches, aux


def decode_step(params: ParamTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                caches: Tuple, cache_len: int) -> Tuple[torch.Tensor, Tuple]:
    """One decode step at position ``cache_len`` (the valid cache length);
    writes the new k/v (or RWKV-6 state and carries, or Mamba state and
    conv window) into ``caches`` in place.  Returns (logits (B, 1, V) f32,
    caches)."""
    x = _embed_in(params, cfg, batch)
    positions = torch.full((1, 1), cache_len, device=x.device)
    x, _ = _run_layers(params, cfg, x, caches, cache_len, positions, None, decode=True)
    x = L.rms_norm(x, params["final_norm"])
    logits = L.logits_apply(params["embed"], x, params.get("lm_head"), cfg.logit_softcap)
    return logits, caches
