"""Architecture registry of the port.

``get_config(arch_id)`` resolves the JAX package's ten architectures, with
the same fields: attention + dense MLP (musicgen-large, phi3-mini-3.8b,
command-r-35b, gemma2-27b, gemma3-12b), RWKV-6 (rwkv6-7b), Mamba + attention
+ MoE (jamba-v0.1-52b), attention + MoE (olmoe-1b-7b, llama4-scout-17b-a16e)
and self- + cross-attention (llama-3.2-vision-11b, whose vision frontend is
a stub: the caller passes the encoder states).  ``input_specs(cfg, cell)``
builds allocation-free stand-ins for every input of a shape cell
(tokens/labels for train, the request batch and the cache for decode) as
meta-device tensors, shape and dtype without storage: what
``launch/dryrun.py`` traces the step with, in place of the JAX package's
``ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import (
    command_r_35b,
    gemma2_27b,
    gemma3_12b,
    jamba_v01_52b,
    llama4_scout_17b_a16e,
    llama32_vision_11b,
    musicgen_large,
    olmoe_1b_7b,
    phi3_mini_3_8b,
    rwkv6_7b,
)
from .base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    LayerSpec,
    ModelConfig,
    MoEConfig,
    ShapeCell,
    shapes_for,
)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        phi3_mini_3_8b,
        command_r_35b,
        gemma2_27b,
        gemma3_12b,
        rwkv6_7b,
        llama32_vision_11b,
        jamba_v01_52b,
        olmoe_1b_7b,
        llama4_scout_17b_a16e,
        musicgen_large,
    )
}

SHAPES: Dict[str, ShapeCell] = {c.name: c for c in ALL_SHAPES}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    return ARCHS[arch]


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=getattr(torch, str(dtype)), device="meta")


def _model_inputs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    d: Dict[str, Any] = {}
    if cfg.frontend == "tokens":
        d["tokens"] = _sds((batch, seq), "int32")
    else:
        d["embeds"] = _sds((batch, seq, cfg.d_model), cfg.dtype)
    if cfg.n_cross_tokens:
        d["encoder"] = _sds((batch, cfg.n_cross_tokens, cfg.d_cross), cfg.dtype)
    return d


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every input of an (arch x shape) cell, in
    the JAX package's structure:

      train   -> {"batch": {tokens/embeds, labels[, encoder]}}
      prefill -> {"batch": {...}}
      decode  -> {"batch": one-token inputs, "caches": ..., "cache_len": i32}

    The decode caches are ``models.transformer.init_cache`` on the meta
    device: a sliding-window layer's ``k``/``v`` hold ``min(seq_len,
    window)`` slots, as the JAX package's do (used as a ring here)."""
    from repro_torch.models.transformer import init_cache

    if cell.kind == "train":
        batch = _model_inputs(cfg, cell.global_batch, cell.seq_len)
        batch["labels"] = _sds((cell.global_batch, cell.seq_len), "int32")
        return {"batch": batch}
    if cell.kind == "prefill":
        return {"batch": _model_inputs(cfg, cell.global_batch, cell.seq_len)}
    if cell.kind == "decode":
        one = _model_inputs(cfg, cell.global_batch, 1)
        one.pop("encoder", None)  # cross K/V live in the cache at decode time
        return {"batch": one,
                "caches": init_cache(cfg, cell.global_batch, cell.seq_len, device="meta"),
                "cache_len": _sds((), "int32")}
    raise ValueError(cell.kind)


__all__ = [
    "ARCHS", "SHAPES", "ALL_SHAPES", "get_config", "input_specs", "shapes_for", "ModelConfig",
    "MoEConfig", "LayerSpec", "ShapeCell", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K",
]
