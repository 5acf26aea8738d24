"""Public kernel entry points that consult the LoopTune schedule registry
for block shapes — the tuned schedules become launch blocks here.

``set_registry(path_or_registry)`` installs a tuned-schedule table (produced
by :class:`~repro_torch.core.tuner.LoopTuner`); :func:`tuned_matmul` falls
back to 128^3 blocks when no entry exists.

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
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.registry import ScheduleRegistry, current_hardware

from .matmul import matmul as _matmul

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
        out = torch.einsum(spec, a, b)
        return out if out_dtype is None else out.to(out_dtype)

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
