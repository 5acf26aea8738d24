"""Graph-structured state representation (paper §III-C, "novel graph-based
representation of the loop nest").

The flat featurization (``features.py``) flattens the nest into a fixed
``MAX_LOOPS x FEATS_PER_LOOP`` matrix: padding rows are indistinguishable
from real loops, nests deeper than ``MAX_LOOPS`` are silently truncated, and
the MLP consuming it is sensitive to loop order in ways the schedule
semantics are not.  This module encodes the nest as a *graph*:

* **Nodes** — one per loop level, carrying the same per-loop feature row as
  the flat path (cursor bit, size, tail, compute bit, stride histogram),
  with the same log1p normalization.
* **Padding mask** — ``mask[i] = 1`` iff node ``i`` is a real loop.  A nest
  deeper than ``max_loops`` raises instead of silently truncating.
* **Typed edges** (``N_EDGE_TYPES`` adjacency planes), derived from integer
  node annotations (section, iterator id, nest position):

  0. *nest-order*: adjacent positions within the same section — the
     sequential loop order the cursor walks.
  1. *same-iterator*: levels produced by splitting the same iterator
     (split chains), within a section.
  2. *membership*: clique over each body's loops — every loop is connected
     to every other loop driving the same compute (or write-back) body.

For transport through the existing ``(T, N, state_dim)`` rollout buffers and
replay memory, a graph observation is *packed* into one flat float32 vector
(`nodes | mask | section | iter_id | pos`); :func:`unpack_graph` and
:func:`build_adjacency` reconstruct nodes and typed adjacency inside jitted
encoder code (``encoders.py``) from the packed form, so adjacency never has
to be shipped through the env API.

``FlatFeaturizer`` / ``GraphFeaturizer`` are the pluggable observation
functions consumed by :class:`LoopTuneEnv` / :class:`VecLoopTuneEnv`; the
flat one reproduces the pre-refactor observation bit-for-bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .features import FEATS_PER_LOOP, MAX_LOOPS, encode, loop_features, normalize
from .loop_ir import LoopNest

GRAPH_MAX_LOOPS = 32  # graph-path default: headroom over the flat 16
N_EDGE_TYPES = 3  # nest-order, same-iterator, membership
# packed vector: nodes (M*F) + mask (M) + section (M) + iter_id (M) + pos (M)
_EXTRA_PER_NODE = 4


def packed_dim(max_loops: int) -> int:
    """Flat size of one packed graph observation."""
    return max_loops * (FEATS_PER_LOOP + _EXTRA_PER_NODE)


def unpack_graph(x, max_loops: int):
    """Split a packed observation ``(..., packed_dim)`` back into
    ``(nodes (..., M, F), mask, section, iter_id, pos)`` — each annotation
    ``(..., M)``.  Pure slicing/reshaping: works on numpy and jax arrays,
    inside jit, with any leading batch dims."""
    m, f = max_loops, FEATS_PER_LOOP
    nodes = x[..., : m * f].reshape(*x.shape[:-1], m, f)
    mask = x[..., m * f : m * f + m]
    section = x[..., m * f + m : m * f + 2 * m]
    iter_id = x[..., m * f + 2 * m : m * f + 3 * m]
    pos = x[..., m * f + 3 * m :]
    return nodes, mask, section, iter_id, pos


def build_adjacency(mask, section, iter_id, pos, xp=np):
    """Typed adjacency ``(..., N_EDGE_TYPES, M, M)`` from node annotations.

    ``xp`` is the array namespace (numpy or torch) so the same code runs at
    featurization time and inside the graph encoder, on the host or the
    card.  All planes are symmetric, zero on the diagonal and zero anywhere
    a padding node is involved — permuting node slots (with their
    annotations) permutes the adjacency consistently, which is what makes
    the encoder permutation-robust.
    """
    m2 = mask[..., :, None] * mask[..., None, :]
    eye = xp.eye(mask.shape[-1], dtype=mask.dtype)
    if xp is not np:  # torch: the identity on the mask's device
        eye = eye.to(mask.device)
    off_diag = m2 * (1.0 - eye)
    same_sec = section[..., :, None] == section[..., None, :]
    adjacent = xp.abs(pos[..., :, None] - pos[..., None, :]) == 1.0
    same_it = iter_id[..., :, None] == iter_id[..., None, :]
    order = off_diag * same_sec * adjacent
    split = off_diag * same_sec * same_it
    member = off_diag * same_sec
    return xp.stack([order, split, member], axis=-3)


@dataclasses.dataclass
class LoopGraph:
    """One nest as a padded graph (see module doc for the edge types)."""

    nodes: np.ndarray    # (M, FEATS_PER_LOOP) float32, normalized rows
    mask: np.ndarray     # (M,) float32 — 1 for real loops, 0 for padding
    section: np.ndarray  # (M,) float32 — 0 compute body, 1 write-back body
    iter_id: np.ndarray  # (M,) float32 — iterator index; -1 on padding
    pos: np.ndarray      # (M,) float32 — index in nest.loops; -1 on padding

    @property
    def n_loops(self) -> int:
        return int(self.mask.sum())

    def adjacency(self) -> np.ndarray:
        """(N_EDGE_TYPES, M, M) float32 typed adjacency."""
        return build_adjacency(self.mask, self.section, self.iter_id,
                               self.pos, np).astype(np.float32)

    def pack(self) -> np.ndarray:
        """Flatten to the fixed transport vector (see module doc layout)."""
        return np.concatenate([
            self.nodes.reshape(-1), self.mask, self.section,
            self.iter_id, self.pos,
        ]).astype(np.float32)

    @classmethod
    def unpack(cls, x: np.ndarray, max_loops: int) -> "LoopGraph":
        nodes, mask, section, iter_id, pos = unpack_graph(
            np.asarray(x, np.float32), max_loops)
        return cls(nodes, mask, section, iter_id, pos)


def encode_graph(nest: LoopNest, max_loops: int = GRAPH_MAX_LOOPS) -> LoopGraph:
    """Encode ``nest`` as a :class:`LoopGraph` with padding masks.

    Unlike the flat path, depth overflow is an explicit error — never a
    silent truncation."""
    n = len(nest.loops)
    if n > max_loops:
        raise ValueError(
            f"nest has {n} loops but the graph featurizer was configured "
            f"with max_loops={max_loops}; raise max_loops (padding masks "
            f"make the encoder depth-agnostic)")
    iters = list(nest.contraction.iter_sizes)
    nodes = np.zeros((max_loops, FEATS_PER_LOOP), np.float32)
    mask = np.zeros(max_loops, np.float32)
    section = np.zeros(max_loops, np.float32)
    iter_id = np.full(max_loops, -1.0, np.float32)
    pos = np.full(max_loops, -1.0, np.float32)
    for i in range(n):
        row = loop_features(nest, i)
        row[1] = np.log1p(row[1])  # same squash as features.normalize
        row[2] = np.log1p(row[2])
        nodes[i] = row
        mask[i] = 1.0
        section[i] = 0.0 if nest.in_compute(i) else 1.0
        iter_id[i] = float(iters.index(nest.loops[i].iterator))
        pos[i] = float(i)
    return LoopGraph(nodes, mask, section, iter_id, pos)


# ---------------------------------------------------------------------------
# Featurizers — the pluggable observation functions for the environments.
# Protocol: .kind (str), .state_dim (int), __call__(nest) -> (state_dim,)
# float32.  Which featurizer an env needs is dictated by the policy
# encoder's EncoderConfig (encoders.py), carried in checkpoints.
# ---------------------------------------------------------------------------


class FlatFeaturizer:
    """The pre-refactor observation: ``normalize(encode(nest))`` — fixed
    ``max_loops`` rows, flattened, silently truncating deeper nests."""

    kind = "flat"

    def __init__(self, max_loops: int = MAX_LOOPS):
        self.max_loops = max_loops

    @property
    def state_dim(self) -> int:
        return self.max_loops * FEATS_PER_LOOP

    def __call__(self, nest: LoopNest) -> np.ndarray:
        return normalize(encode(nest, self.max_loops), self.max_loops)

    def __repr__(self) -> str:
        return f"FlatFeaturizer(max_loops={self.max_loops})"


class GraphFeaturizer:
    """Packed graph observation (see module doc); raises on depth overflow
    instead of truncating."""

    kind = "graph"

    def __init__(self, max_loops: int = GRAPH_MAX_LOOPS):
        self.max_loops = max_loops

    @property
    def state_dim(self) -> int:
        return packed_dim(self.max_loops)

    def __call__(self, nest: LoopNest) -> np.ndarray:
        return encode_graph(nest, self.max_loops).pack()

    def __repr__(self) -> str:
        return f"GraphFeaturizer(max_loops={self.max_loops})"
