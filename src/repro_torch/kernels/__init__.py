"""Hand-written Hopper kernels for the compute hot-spots LoopTune
schedules, each with a wrapper that counts its launches and a plain torch
version beside it (taken for CPU tensors), the registry-backed entry points
(ops.py) and plain torch oracles (ref.py).  Kernels build at first use."""
from .matmul import matmul, matmul_plain
from .ops import (
    get_registry,
    serving,
    serving_stats,
    set_registry,
    tuned_einsum,
    tuned_matmul,
)

__all__ = [
    "matmul",
    "matmul_plain",
    "get_registry",
    "serving",
    "serving_stats",
    "set_registry",
    "tuned_einsum",
    "tuned_matmul",
]
