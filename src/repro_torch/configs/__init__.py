"""Architecture registry of the port.

``get_config(arch_id)`` resolves the JAX package's ten architectures, with
the same fields: attention + dense MLP (musicgen-large, phi3-mini-3.8b,
command-r-35b, gemma2-27b, gemma3-12b), RWKV-6 (rwkv6-7b), Mamba + attention
+ MoE (jamba-v0.1-52b), attention + MoE (olmoe-1b-7b, llama4-scout-17b-a16e)
and self- + cross-attention (llama-3.2-vision-11b, whose vision frontend is
a stub: the caller passes the encoder states).  ``input_specs`` (the
dry-run's allocation-free stand-ins) comes with the dry-run launcher.
"""
from __future__ import annotations

from typing import Dict

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


__all__ = [
    "ARCHS", "SHAPES", "ALL_SHAPES", "get_config", "shapes_for", "ModelConfig",
    "MoEConfig", "LayerSpec", "ShapeCell", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K",
]
