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
channel-mix and Mamba mixers, dense MLP and MoE FFNs.  Entry points:

  * :func:`hidden_states`  — full-sequence forward to the final norm
    (training's loss reads it through a seq-chunked CE)
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

Training builds the parameters with ``trainable=True`` (every leaf
requires grad) and runs :func:`hidden_states` under the config's
``remat_policy``, as the reference does: ``"block"`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant: the backward keeps each layer's
input and recomputes one layer at a time), ``"period"`` each period,
``"none"`` nothing.  Remat applies only with grad enabled and no cache.

Under a mesh (``runtime/sharding.use_mesh``, parameters and inputs as
DTensors) the same code runs sharded: the reference's ``ashard`` sites hold
the residual stream at ``("batch", "act_seq", None)`` and the logits at
``("batch", None, "model")``; the caches are DTensors placed by
``cache_pspecs`` (:func:`init_cache` with ``mesh``), written in place shard
by shard.  Each layer re-enters the mesh context it was built under, so a
remat recompute in the backward runs as its forward did.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint
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

from repro_torch.runtime import sharding as SH
from repro_torch.runtime.sharding import ashard

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
    ``"lm_head" in p``, ``p.get("lm_head")``.  Every leaf requires grad when
    ``trainable`` (training), none otherwise (serving)."""

    def __init__(self, tree: Dict[str, Any], trainable: bool = False):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val, trainable))
            elif isinstance(val, nn.Module):
                self.add_module(name, val)
            else:
                self.register_parameter(name, nn.Parameter(val, requires_grad=trainable))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default


def make_params(top: Dict[str, Any], blocks: List[Dict[str, Any]],
                trainable: bool = False) -> ParamTree:
    """The model's parameters from plain dicts of tensors: ``top`` (embed,
    final_norm[, lm_head]) and one dict per layer, in layer order."""
    return ParamTree({**top, "blocks": nn.ModuleList(ParamTree(b, trainable)
                                                     for b in blocks)}, trainable)


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
                device="cuda", trainable: bool = False) -> ParamTree:
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
    return make_params(top, blocks, trainable)


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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda", mesh=None
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
    n_cross_tokens, HKV, hd)``, written at prefill and read at decode.

    With ``mesh`` every leaf is a zero DTensor placed by the reference's
    ``cache_pspecs`` (batch over the batch axes, kv heads or else the
    sequence over model, Mamba's d_inner and RWKV-6's heads over model),
    allocated shard by shard."""
    if mesh is not None:
        shapes = init_cache(cfg, batch, max_len, device="meta")
        specs = SH.cache_pspecs(shapes, mesh, batch, cfg.n_kv_heads)
        return tuple({k: SH.zeros(c[k].shape, c[k].dtype, mesh, spec[k]) for k in c}
                     for c, spec in zip(shapes, specs))
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


def _write(dst: torch.Tensor, src: torch.Tensor, t0: int) -> None:
    """``dst[:, t0:t0 + src.shape[1]] = src`` in place.  On DTensors each rank
    writes its own shard: where ``dst`` (a cache) is sharded on that dim,
    only the overlap of the rank's slots with the written ones."""
    if not SH.is_dtensor(dst):
        dst[:, t0:t0 + src.shape[1]] = src
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = dst.device_mesh
    pl = tuple(dst.placements)
    src_l = src.redistribute(mesh, tuple(Replicate() if p == Shard(1) else p for p in pl)
                             ).to_local()
    dst_l = dst.to_local()
    if mesh.get_coordinate() is None:
        return
    shape, offset = compute_local_shape_and_global_offset(dst.shape, mesh, pl)
    lo, hi = max(t0, offset[1]), min(t0 + src.shape[1], offset[1] + shape[1])
    if lo < hi:
        dst_l[:, lo - offset[1]:hi - offset[1]] = src_l[:, lo - t0:hi - t0]


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
                _write(cache["k"], k, 0)
                _write(cache["v"], v, 0)
            else:  # a windowed cache is a ring: the last buf keys, position p in slot p % buf
                _write(cache["k"], torch.roll(k[:, -buf:], shifts=s % buf, dims=1), 0)
                _write(cache["v"], torch.roll(v[:, -buf:], shifts=s % buf, dims=1), 0)
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
        _write(cache["k"], k, at)
        _write(cache["v"], v, at)
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
        return ashard(x + mix.to(x.dtype) + ff.to(x.dtype), ("batch", "act_seq", None)), aux
    x = x + mix.to(x.dtype)
    ff, aux = _apply_ffn(spec, p, cfg, L.rms_norm(x, p["norm_ffn"]), cache, decode)
    if cfg.post_norm:
        ff = L.rms_norm(ff, p["post_ffn"])
    return ashard(x + ff.to(x.dtype), ("batch", "act_seq", None)), aux


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _embed_in(params, cfg, batch) -> torch.Tensor:
    if cfg.frontend == "tokens":
        scale = math.sqrt(cfg.d_model) if cfg.embed_scale else None
        x = L.embed_apply(params["embed"], batch["tokens"], scale)
    else:  # audio / stub frontends supply precomputed frame embeddings
        x = batch["embeds"].to(_dtype(cfg))
    return ashard(x, ("batch", "act_seq", None))


def _run_layers(params, cfg, x, caches, cache_len, positions, encoder, decode,
                remat=True):
    """Every layer in order.  Returns (x, aux): the sum over MoE layers of
    ``moe_aux_loss + moe_z_loss`` (f32 scalar, 0 without MoE layers).

    ``remat``: True takes ``cfg.remat_policy``, a string names a policy,
    False is ``"none"``; it applies only with grad enabled and no cache."""
    n = len(cfg.period)
    policy = cfg.remat_policy if remat is True else (remat if isinstance(remat, str)
                                                      else "none")
    if policy not in ("block", "period", "none"):
        raise ValueError(f"remat policy {policy!r}: block | period | none")
    if caches is not None or not torch.is_grad_enabled():
        policy = "none"
    blocks = params["blocks"]
    ctx = SH.capture()  # the mesh context a recompute re-enters

    def layer(i, x, aux):
        per, pos = divmod(i, n)
        cache = (None if caches is None
                 else {name: t[per] for name, t in caches[pos].items()})
        with SH.mesh_scope(ctx):
            x, layer_aux = _apply_block(cfg.period[pos], blocks[i], cfg, x, cache,
                                        cache_len, positions, encoder, decode)
            return x, (aux if layer_aux is None else aux + layer_aux)

    def period(per, x, aux):
        for i in range(per * n, (per + 1) * n):
            x, aux = layer(i, x, aux)
        return x, aux

    def remat_fn(fn, *args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if SH.is_dtensor(x):
        aux = SH.distribute(aux, x.device_mesh, ())
    if policy == "period":
        for per in range(cfg.n_periods):
            x, aux = remat_fn(period, per, x, aux)
        return x, aux
    for i in range(len(blocks)):
        x, aux = remat_fn(layer, i, x, aux) if policy == "block" else layer(i, x, aux)
    return x, aux


def _scoped(fn):
    """``fn`` inside the current mesh context with implicit replication (a
    no-op outside a mesh)."""

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with SH.mesh_scope(SH.capture()):
            return fn(*args, **kwargs)

    return inner


@_scoped
def hidden_states(params: ParamTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  caches: Optional[Tuple] = None, remat=True
                  ) -> Tuple[torch.Tensor, Optional[Tuple], torch.Tensor]:
    """Full-sequence forward up to the final norm (no logits).  Returns
    (hidden (B, S, D), caches, aux_loss): aux_loss sums each MoE layer's
    ``moe_aux_loss + moe_z_loss`` (0 without MoE layers), as the
    reference's does.  A model with cross layers reads the encoder states
    ``batch["encoder"]`` ``(B, n_cross_tokens, d_cross)``.  ``remat`` as
    :func:`_run_layers` takes it."""
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
    if SH.is_dtensor(x):  # RoPE's tables a DTensor: its backward reads them
        positions = SH.distribute(positions, x.device_mesh, ())
    x, aux = _run_layers(params, cfg, x, caches, 0, positions, encoder, decode=False,
                         remat=remat)
    x = L.rms_norm(x, params["final_norm"])
    return x, caches, aux


@_scoped
def forward(params: ParamTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            caches: Optional[Tuple] = None
            ) -> Tuple[torch.Tensor, Optional[Tuple], torch.Tensor]:
    """Full-sequence forward (prefill when caches are given, written in
    place).  Returns (logits (B, S, V) f32, caches, aux_loss)."""
    x, caches, aux = hidden_states(params, cfg, batch, caches)
    logits = L.logits_apply(params["embed"], x, params.get("lm_head"), cfg.logit_softcap)
    return ashard(logits, ("batch", None, "model")), caches, aux


@_scoped
def decode_step(params: ParamTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                caches: Tuple, cache_len: int) -> Tuple[torch.Tensor, Tuple]:
    """One decode step at position ``cache_len`` (the valid cache length);
    writes the new k/v (or RWKV-6 state and carries, or Mamba state and
    conv window) into ``caches`` in place.  Returns (logits (B, 1, V) f32,
    caches)."""
    x = _embed_in(params, cfg, batch)
    positions = torch.full((1, 1), cache_len, device=x.device)
    x, _ = _run_layers(params, cfg, x, caches, cache_len, positions, None, decode=True,
                       remat=False)
    x = L.rms_norm(x, params["final_norm"])
    logits = L.logits_apply(params["embed"], x, params.get("lm_head"), cfg.logit_softcap)
    return logits, caches
