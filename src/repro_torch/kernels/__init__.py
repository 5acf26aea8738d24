"""Hand-written Hopper kernels for the compute hot-spots LoopTune
schedules (and flash attention's backward), each with a wrapper that counts
its launches and a plain torch version beside it (taken for CPU tensors),
the registry-backed entry points (ops.py) and plain torch oracles
(ref.py).  Kernels build at first use."""
from .flash_attention import flash_attention_bwd_plain, flash_attention_plain
from .mamba_scan import mamba_scan_plain
from .matmul import matmul, matmul_plain
from .rwkv6_scan import rwkv6_chunk_scan_plain
from .ops import (
    flash_attention,
    get_registry,
    mamba_scan,
    rwkv6_chunk_scan,
    serving,
    serving_registry,
    serving_stats,
    set_registry,
    tuned_einsum,
    tuned_matmul,
)

__all__ = [
    "flash_attention",
    "flash_attention_bwd_plain",
    "flash_attention_plain",
    "matmul",
    "matmul_plain",
    "get_registry",
    "mamba_scan",
    "mamba_scan_plain",
    "rwkv6_chunk_scan",
    "rwkv6_chunk_scan_plain",
    "serving",
    "serving_registry",
    "serving_stats",
    "set_registry",
    "tuned_einsum",
    "tuned_matmul",
]
