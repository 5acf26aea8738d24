"""State featurization (paper §III-C, Figs. 4-5).

Each loop is encoded as 20 integers:

    [ cursor_bit, size, tail, compute_bit, stride_hist[16] ]

where ``stride_hist[b]`` counts tensor accesses whose effective stride falls
in bin ``2^b`` (b = 0..15, clamped).  The nest is padded/truncated to
``MAX_LOOPS`` rows; the flattened vector (MAX_LOOPS * 20) feeds the MLP.
"""
from __future__ import annotations

import numpy as np

from .loop_ir import LoopNest

MAX_LOOPS = 16
FEATS_PER_LOOP = 20
N_STRIDE_BINS = 16
STATE_DIM = MAX_LOOPS * FEATS_PER_LOOP


def stride_bin(stride: int) -> int:
    """Discretize a stride to its power-of-two bin (paper Fig. 5)."""
    if stride <= 1:
        return 0
    return min(int(np.log2(stride)), N_STRIDE_BINS - 1)


def loop_features(nest: LoopNest, idx: int) -> np.ndarray:
    row = np.zeros(FEATS_PER_LOOP, dtype=np.float32)
    row[0] = 1.0 if idx == nest.cursor else 0.0
    size, tail = nest.size_tail(idx)
    row[1] = float(size)
    row[2] = float(tail)
    row[3] = 1.0 if nest.in_compute(idx) else 0.0
    for s in nest.effective_strides(idx):
        row[4 + stride_bin(s)] += 1.0
    return row


def encode(nest: LoopNest, max_loops: int = MAX_LOOPS) -> np.ndarray:
    """Flatten the nest to the fixed-size state vector (``max_loops`` rows;
    deeper nests are silently truncated — the graph path in
    ``graph_features.py`` is the depth-agnostic alternative)."""
    out = np.zeros((max_loops, FEATS_PER_LOOP), dtype=np.float32)
    for i in range(min(len(nest.loops), max_loops)):
        out[i] = loop_features(nest, i)
    return out.reshape(-1)


def normalize(state: np.ndarray, max_loops: int = MAX_LOOPS) -> np.ndarray:
    """Squash unbounded size/tail features with log1p for NN stability.

    (The paper feeds raw integers to RLlib, which normalizes internally; we
    make the normalization explicit since our trainers are from scratch.)
    """
    s = state.reshape(max_loops, FEATS_PER_LOOP).copy()
    s[:, 1] = np.log1p(s[:, 1])
    s[:, 2] = np.log1p(s[:, 2])
    return s.reshape(-1)
