"""Public kernel entry points that consult the LoopTune schedule registry
for block shapes — the tuned schedules become launch blocks here.

``set_registry(path_or_registry)`` installs a tuned-schedule table (produced
by :class:`~repro_torch.core.tuner.LoopTuner`); :func:`tuned_matmul` falls
back to 128^3 blocks, :func:`flash_attention` to a (128, 128) block, and
:func:`rwkv6_chunk_scan` and :func:`mamba_scan` to the caller's chunk (and
channel block) when no entry exists.

**Tuned serving**: :func:`tuned_einsum` is the model zoo's consume path.
Inside a :func:`serving` context every matmul-shaped contraction looks its
workload signature up in the active :class:`ScheduleRegistry`.  Hits on
CUDA tensors launch the hand-written tiled-matmul kernel at the tuned block
and grid order (``kernel="auto"``); cold misses, non-matmul shapes and CPU
tensors take ``torch.einsum``, as the JAX package takes ``jnp.einsum``.  On
a CUDA tensor the lookup requires a record tuned on this card (or a
wildcard record), so a schedule tuned for other hardware is never served
there.  Per-contraction hit/miss/routed counters are read with
:func:`serving_stats`.

**Gradients.**  With grad enabled and an input that requires grad, the
flash and scan wrappers go through their ``torch.autograd.Function`` (the
kernel forward; flash's backward kernel, the scans' plain recompute), and a
registry hit that would launch the tiled matmul raises (it has no backward,
ROADMAP.md §C 6): no entry point returns a result without a ``grad_fn``
under grad.  The CPU fallback of :func:`tuned_einsum` is ``torch.einsum``
and stays differentiable.

**Under a mesh** (``runtime/sharding.py``): given DTensors, the flash and
scan entry points run their kernel (or, on the CPU, its plain version) on
each rank's local shard through ``local_map``: attention per (batch shard,
head shard), the RWKV-6 scan per (batch, head) shard and the Mamba scan per
(batch, channel) shard, with the layer's placements; their autograd
functions run inside, on the local tensors.  Attention's K and V follow the
kv-head fallback: where the kv heads do not divide the model axis they are
replicated, and each rank cuts out the kv heads of its own q heads, so the
kernel's GQA map (q head h reads kv head h / (HQ / HKV) of the tensors it
is given) holds on the shard.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.registry import ScheduleRegistry, current_hardware
from repro_torch.runtime import sharding as SH

from .flash_attention import flash_attention as _flash_attention
from .mamba_scan import mamba_scan as _mamba_scan
from .matmul import matmul as _matmul
from .rwkv6_scan import rwkv6_chunk_scan as _rwkv6_chunk_scan

_REGISTRY: Optional[ScheduleRegistry] = None

DEFAULT_MM_BLOCK: Dict[str, int] = {"m": 128, "k": 128, "n": 128}


def set_registry(reg: Union[str, ScheduleRegistry, None]) -> None:
    global _REGISTRY
    if isinstance(reg, str):
        reg = ScheduleRegistry(reg)
    _REGISTRY = reg


def get_registry() -> Optional[ScheduleRegistry]:
    return _REGISTRY


# --------------------------------------------------------------------------
# Tuned serving: registry context + per-contraction counters
# --------------------------------------------------------------------------

_SERVING: Optional[ScheduleRegistry] = None
_SERVING_STATS: Dict[str, Dict[str, int]] = {}


@contextlib.contextmanager
def serving(registry: Union[str, ScheduleRegistry, None]):
    """Activate a tuned-schedule registry for the model's matmul sites,
    which go through :func:`tuned_einsum`.  ``None`` deactivates (the
    default path is untouched ``torch.einsum``)."""
    global _SERVING
    if isinstance(registry, str):
        registry = ScheduleRegistry(registry)
    prev = _SERVING
    _SERVING = registry
    try:
        yield registry
    finally:
        _SERVING = prev


def serving_registry() -> Optional[ScheduleRegistry]:
    """The registry of the active :func:`serving` context, or None."""
    return _SERVING


def serving_stats(reset: bool = False) -> Dict[str, Any]:
    """Per-contraction registry hit/miss/routed counters.

    ``hits``  — workload found in the registry;
    ``misses`` — matmul-shaped contraction with no entry (cold miss);
    ``routed`` — hits actually launched through the tiled-matmul kernel
    (subset of hits: CPU tensors count the hit but keep ``torch.einsum``).
    """
    per_key = {k: dict(v) for k, v in _SERVING_STATS.items()}
    out = {
        "hits": sum(v.get("hits", 0) for v in per_key.values()),
        "misses": sum(v.get("misses", 0) for v in per_key.values()),
        "routed": sum(v.get("routed", 0) for v in per_key.values()),
        "per_key": per_key,
    }
    if reset:
        reset_serving_stats()
    return out


def reset_serving_stats() -> None:
    _SERVING_STATS.clear()


def _count(key: str, field: str) -> None:
    slot = _SERVING_STATS.setdefault(key, {"hits": 0, "misses": 0,
                                           "routed": 0})
    slot[field] += 1


def _parse_matmul_spec(spec: str, a_shape, b_shape):
    """Match an einsum spec to a (batched-)matmul; None if not one.

    Accepts two-operand specs where the rhs is 2-D, exactly one index is
    contracted, the contracted index is the trailing lhs dim, and the
    output is ``lhs_free + rhs_free`` — i.e. ``...k,kn->...n`` and the
    transposed-weight form ``...k,nk->...n`` (logits against an embedding
    table).  An lhs/out ellipsis stands for the leading (batch) dims of
    ``a`` and folds into ``m`` exactly like explicit letters.  Returns
    ``(m, k, n, transpose_rhs)`` with leading lhs dims folded into m.
    """
    if "->" not in spec:
        return None
    ins, out = spec.split("->")
    if ins.count(",") != 1:
        return None
    lhs, rhs = ins.split(",")
    ellipsis = lhs.startswith("...") and out.startswith("...")
    if ellipsis:
        lhs, out = lhs[3:], out[3:]
    # after stripping a matched lhs/out prefix, any remaining "..." (rhs
    # ellipsis, mid-spec, or one side only) is a shape we don't tune
    if "..." in lhs or "..." in rhs or "..." in out:
        return None
    if ellipsis:
        # the ellipsis absorbs len(a_shape) - len(lhs) leading batch dims;
        # the explicit letters must still cover at least the contracted dim
        if not lhs or len(lhs) > len(a_shape):
            return None
    elif len(lhs) != len(a_shape):
        return None
    if len(rhs) != 2 or len(rhs) != len(b_shape):
        return None
    if len(set(lhs)) != len(lhs) or len(set(rhs)) != len(rhs):
        return None
    contracted = (set(lhs) & set(rhs)) - set(out)
    if len(contracted) != 1:
        return None
    ck = contracted.pop()
    if lhs[-1] != ck:
        return None
    free_l = lhs[:-1]
    free_r = rhs.replace(ck, "")
    if out != free_l + free_r:
        return None
    m = 1
    for d in a_shape[:-1]:
        m *= int(d)
    k = int(a_shape[-1])
    n = int(b_shape[1] if rhs[0] == ck else b_shape[0])
    return m, k, n, rhs[0] != ck


def _route(kernel: str, a: torch.Tensor) -> bool:
    """Whether a registry hit launches the tiled-matmul kernel: ``"auto"``
    on CUDA tensors only, ``"on"`` always (a CPU tensor then runs the
    kernel's plain version), ``"off"`` never."""
    if kernel not in ("auto", "on", "off"):
        raise ValueError(f"kernel must be auto|on|off, got {kernel!r}")
    if kernel == "auto":
        return a.is_cuda
    return kernel == "on"


def _entry_schedule(entry: Optional[dict]) -> Tuple[Dict[str, int], str]:
    """(block sizes, grid order) of a registry entry over the defaults."""
    block = dict(DEFAULT_MM_BLOCK)
    order = "mn"
    if entry and "block" in entry:
        block.update({kk: int(vv) for kk, vv in entry["block"].items()})
        go = [it for it in entry.get("grid_order", []) if it in ("m", "n")]
        if go and go[0] == "n":
            order = "nm"
    return block, order


def tuned_einsum(spec: str, a: torch.Tensor, b: torch.Tensor, *,
                 registry: Optional[ScheduleRegistry] = None,
                 kernel: str = "auto",
                 out_dtype=None) -> torch.Tensor:
    """Registry-backed einsum: the tuned-serving entry point.

    Looks the contraction's workload signature up in ``registry`` (default:
    the active :func:`serving` registry).  On a hit with a tuned block,
    matmul-shaped contractions launch the tiled-matmul kernel with the tuned
    block and grid order (the transposed-weight form passes B as stored,
    ``trans_b``); cold misses, non-matmul shapes and CPU tensors under
    ``kernel="auto"`` take ``torch.einsum`` — numerically interchangeable
    with the kernel.
    """
    reg = registry if registry is not None else _SERVING

    def _fallback():
        if out_dtype is None:
            return torch.einsum(spec, a, b)
        # accumulate in the wider of the two types, as jnp.einsum's
        # preferred_element_type does (bf16 operands, f32 logits)
        ct = torch.promote_types(a.dtype, out_dtype)
        return torch.einsum(spec, a.to(ct), b.to(ct)).to(out_dtype)

    if reg is None:
        return _fallback()
    parsed = _parse_matmul_spec(spec, a.shape, b.shape)
    if parsed is None:
        return _fallback()
    m, k, n, transpose_rhs = parsed
    dtype = str(a.dtype).replace("torch.", "")
    wl_key = ScheduleRegistry.key("mm", (m, k, n), dtype)
    entry = reg.get("mm", (m, k, n), dtype=dtype,
                    hardware=current_hardware(), exact=a.is_cuda)
    if not entry or "block" not in entry:
        _count(wl_key, "misses")
        return _fallback()
    _count(wl_key, "hits")
    if not _route(kernel, a):
        return _fallback()
    _count(wl_key, "routed")
    block, order = _entry_schedule(entry)
    out = _matmul(a.reshape(m, k).contiguous(), b.contiguous(), bm=block["m"],
                  bk=block["k"], bn=block["n"], grid_order=order,
                  out_dtype=out_dtype or a.dtype, trans_b=transpose_rhs)
    return out.reshape(*a.shape[:-1], n)


def tuned_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 out_dtype=None) -> torch.Tensor:
    """Registry-tuned tiled matmul (falls back to 128^3 blocks).  CUDA
    tensors launch the kernel; CPU tensors run its plain version."""
    m, k = a.shape
    n = b.shape[1]
    entry = (_REGISTRY.get("mm", (m, k, n)) if _REGISTRY is not None
             else None)
    block, order = _entry_schedule(entry)
    return _matmul(a, b, bm=block["m"], bk=block["k"], bn=block["n"],
                   grid_order=order, out_dtype=out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, softcap=None) -> torch.Tensor:
    """Registry-tuned flash attention (block sizes under kernel id 'fa',
    workload ``(S, T, D)``).  CUDA tensors launch the kernel, CPU tensors
    run its plain version; under grad, through
    :class:`~repro_torch.kernels.flash_attention.FlashAttention`."""
    bq, bk = 128, 128
    if _REGISTRY is not None:
        entry = _REGISTRY.get("fa", (q.shape[1], k.shape[1], q.shape[-1]))
        if entry and "block" in entry:
            bq = int(entry["block"].get("q", bq))
            bk = int(entry["block"].get("k", bk))
    if SH.is_dtensor(q):
        return _flash_sharded(q, k, v, causal=causal, window=window, softcap=softcap,
                              bq=bq, bk=bk)
    return _flash_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap, bq=bq, bk=bk)


def _flash_sharded(q, k, v, **opts):
    """Flash attention on DTensors: per (batch shard, q-head shard), K and V
    on the q heads' mesh dims only where the kv heads divide them; else
    replicated there, each rank cutting out its q heads' kv heads."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    qp = SH.spec_placements(q, ("batch", None, "heads", None))
    kvp = SH.spec_placements(k, ("batch", None, "kv", None))
    head_dims = [i for i, p in enumerate(qp) if p == Shard(2)]
    parts = 1
    for i in head_dims:
        parts *= mesh.size(i)
    if head_dims and all(kvp[i] == Shard(2) for i in head_dims):
        kv_in, cut = qp, False
    else:
        kv_in = tuple(Replicate() if i in head_dims else p for i, p in enumerate(qp))
        cut = bool(head_dims)

    def body(q_l, k_l, v_l):
        if cut:
            coord = 0
            for i in head_dims:
                coord = coord * mesh.size(i) + mesh.get_local_rank(i)
            hq_l, g = hq // parts, hq // hkv
            h0 = coord * hq_l
            if hq_l % g == 0 or g % hq_l == 0:
                k_l = k_l[:, :, h0 // g:h0 // g + max(hq_l // g, 1)]
                v_l = v_l[:, :, h0 // g:h0 // g + max(hq_l // g, 1)]
            else:  # the slice crosses a group: its own kv head for each q head
                k_l = k_l.repeat_interleave(g, dim=2)[:, :, h0:h0 + hq_l]
                v_l = v_l.repeat_interleave(g, dim=2)[:, :, h0:h0 + hq_l]
        return _flash_attention(q_l, k_l, v_l, **opts)

    return SH.local_call(body, (q, k, v), (qp, kv_in, kv_in), (qp,))


def rwkv6_chunk_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                     s0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Registry-tuned RWKV-6 chunked scan over ``(B, S, H, N)`` streams
    (chunk under kernel id 'rwkv6', block ``"l"``, workload ``(S, N)``).
    CUDA tensors launch the kernel, CPU tensors run its plain version;
    under grad, through
    :class:`~repro_torch.kernels.rwkv6_scan.RWKV6Scan`."""
    if _REGISTRY is not None:
        entry = _REGISTRY.get("rwkv6", (r.shape[1], r.shape[3]))
        if entry and "block" in entry:
            chunk = int(entry["block"].get("l", chunk))
    if SH.is_dtensor(r):
        # per (batch, head) shard: the state is per head
        sp = SH.spec_placements(r, ("batch", None, "model", None))
        up = SH.spec_placements(u, ("model", None))
        args, specs = [r, k, v, logw, u], [sp, sp, sp, sp, up]
        if s0 is not None:
            args.append(s0)
            specs.append(SH.spec_placements(s0, ("batch", "model", None, None)))
        state_p = tuple(type(p)(1) if p.is_shard(2) else p for p in sp)  # (B, H, N, N)

        def body(*xs):
            return _rwkv6_chunk_scan(*xs[:5], chunk=chunk, s0=xs[5] if len(xs) > 5 else None)

        return SH.local_call(body, args, specs, (sp, state_p))
    return _rwkv6_chunk_scan(r, k, v, logw, u, chunk=chunk, s0=s0)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, *, chunk: int = 32, bd: int = 128,
               h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Registry-tuned Mamba selective scan on the model's tensors: x, dt
    ``(B, S, C)``, a ``(C, N)`` f32, b, c ``(B, S, N)``, h0 ``(B, C, N)``
    f32 or None (block ``{"l": tokens a tile, "c": channels a CTA}`` under
    kernel id 'mamba', workload ``(S, C)``).  CUDA tensors launch the
    kernel; CPU tensors form dtx and da and run its plain version; under
    grad, through :class:`~repro_torch.kernels.mamba_scan.MambaScan`."""
    if _REGISTRY is not None:
        entry = _REGISTRY.get("mamba", (x.shape[1], x.shape[2]))
        if entry and "block" in entry:
            chunk = int(entry["block"].get("l", chunk))
            bd = int(entry["block"].get("c", bd))
    if SH.is_dtensor(x):
        return _mamba_sharded(x, dt, a, b, c, chunk=chunk, bd=bd, h0=h0)
    return _mamba_scan(x, dt, a, b, c, chunk=chunk, bd=bd, h0=h0)


def _mamba_sharded(x, dt, a, b, c, *, chunk, bd, h0):
    """The Mamba scan on DTensors, per (batch shard, channel shard): the
    reference keeps d_inner model-sharded through its scan (its
    ``models/mamba.py`` chunk buffers and state).  B and C are replicated
    over the channel shards."""
    from torch.distributed.tensor import Replicate, Shard

    xp = SH.spec_placements(x, ("batch", None, "model"))
    ap = SH.spec_placements(a, ("model", None))
    bp = tuple(p if p != Shard(2) else Replicate() for p in xp)
    hp = tuple(p if p != Shard(2) else Shard(1) for p in xp)  # (B, C, N)
    args, specs = [x, dt, a, b, c], [xp, xp, ap, bp, bp]
    if h0 is not None:
        args.append(h0)
        specs.append(hp)

    def body(*xs):
        return _mamba_scan(*xs[:5], chunk=chunk, bd=bd, h0=xs[5] if len(xs) > 5 else None)

    return SH.local_call(body, args, specs, (xp, hp))
