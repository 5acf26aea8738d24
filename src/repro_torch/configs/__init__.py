"""Architecture registry of the port.

``get_config(arch_id)`` resolves the architectures whose layers the port
runs: musicgen-large (attention + dense MLP), rwkv6-7b (RWKV-6 time-mix
with kernel B3 + channel-mix) and jamba-v0.1-52b (Mamba with kernel B4,
GQA attention, dense MLP and MoE FFNs).  The JAX package's other seven
architectures raise ``KeyError`` until the port is asked to serve them
(ROADMAP.md, model zoo; llama-3.2-vision also needs cross-attention).
``input_specs`` (the dry-run's allocation-free stand-ins)
comes with the dry-run launcher.
"""
from __future__ import annotations

from typing import Dict

from . import jamba_v01_52b, musicgen_large, rwkv6_7b
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

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                 for m in (musicgen_large, rwkv6_7b, jamba_v01_52b)}

SHAPES: Dict[str, ShapeCell] = {c.name: c for c in ALL_SHAPES}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP.md, model zoo); "
                       f"ported: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = [
    "ARCHS", "SHAPES", "ALL_SHAPES", "get_config", "shapes_for", "ModelConfig",
    "MoEConfig", "LayerSpec", "ShapeCell", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K",
]
