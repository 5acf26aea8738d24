"""Benchmark dataset (paper §VI).

"The matrix multiplication dataset has 2197 untiled loop nests for matrices
with dimensions in the range from 64 to 256 with the step of 16" — 13 values
per dim, 13^3 = 2197 (m, k, n) triples.  80/20 train/test split (1757/440),
seeded for reproducibility.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .loop_ir import (
    Contraction,
    conv2d_benchmark,
    matmul_benchmark,
    reduction_benchmark,
    transpose_benchmark,
)

DIMS: Sequence[int] = tuple(range(64, 257, 16))  # 13 values


def matmul_dataset() -> List[Contraction]:
    return [
        matmul_benchmark(m, k, n) for m in DIMS for k in DIMS for n in DIMS
    ]


def train_test_split(
    benchmarks: Sequence[Contraction], frac: float = 0.8, seed: int = 0
) -> Tuple[List[Contraction], List[Contraction]]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(benchmarks))
    cut = int(len(benchmarks) * frac)
    bm = list(benchmarks)
    return [bm[i] for i in idx[:cut]], [bm[i] for i in idx[cut:]]


def small_dataset(n: int = 32, seed: int = 0) -> List[Contraction]:
    """Subsampled dataset for 1-core CPU experiments (documented deviation)."""
    rng = np.random.default_rng(seed)
    all_bm = matmul_dataset()
    idx = rng.choice(len(all_bm), size=n, replace=False)
    return [all_bm[i] for i in idx]


def mixed_ops_dataset() -> List[Contraction]:
    """Beyond-paper: the §II operator families (conv/reduction/transpose)."""
    out: List[Contraction] = []
    for d in (64, 128, 256):
        out.append(conv2d_benchmark(d, d, 3, 3))
        out.append(reduction_benchmark(d, 4 * d))
        out.append(transpose_benchmark(d, 2 * d))
    return out
