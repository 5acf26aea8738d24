"""Deterministic, host-sharded synthetic data pipeline (the port's copy of
the JAX package's ``data/pipeline.py``: pure NumPy, so the two give equal
batches, byte for byte).

Every batch is a pure function of ``(seed, step, host_id)`` — no iterator
state to checkpoint beyond the step counter, so a restarted job regenerates
exactly the batches it would have seen (deterministic restart).
Each data-parallel host materializes only its shard (``host_id``/``n_hosts``
slice of the global batch), which is what a 1000-node input pipeline must do
to avoid N× ingest.

Two generators:
* :class:`SyntheticDataset` — uniform tokens (shape/throughput testing).
* :class:`MarkovLMDataset` — tokens from a fixed random Markov chain: the
  data has real conditional structure, so training losses drop well below
  ``log(vocab)`` and convergence is measurable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    frontend: str = "tokens"   # tokens | embeds
    d_model: int = 0           # for embeds frontends
    n_cross_tokens: int = 0
    d_cross: int = 0

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        self.host_batch = self.global_batch // self.n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))

    def _tokens(self, rng, b, s):
        return rng.integers(0, self.vocab, (b, s + 1), dtype=np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        b, s = self.host_batch, self.seq_len
        toks = self._tokens(rng, b, s)
        out: Dict[str, np.ndarray] = {"labels": toks[:, 1:].astype(np.int32)}
        if self.frontend == "tokens":
            out["tokens"] = toks[:, :-1].astype(np.int32)
        else:
            out["embeds"] = rng.standard_normal(
                (b, s, self.d_model)).astype(np.float32)
        if self.n_cross_tokens:
            out["encoder"] = rng.standard_normal(
                (b, self.n_cross_tokens, self.d_cross)).astype(np.float32)
        return out


@dataclasses.dataclass
class MarkovLMDataset(SyntheticDataset):
    """Order-1 Markov chain over the vocab with temperature-skewed rows."""

    branching: int = 8  # effective successors per state

    def __post_init__(self):
        super().__post_init__()
        rng = np.random.default_rng(self.seed + 7919)
        v = min(self.vocab, 4096)  # transition table cap (tiled over vocab)
        self._v = v
        # each state transitions to `branching` preferred successors
        self._succ = rng.integers(0, v, (v, self.branching), dtype=np.int64)
        self._succ_p = rng.dirichlet(np.ones(self.branching) * 0.5, size=v)

    def _tokens(self, rng, b, s):
        v = self._v
        toks = np.empty((b, s + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, v, b)
        # vectorized over batch: sample successor slot, map through table
        u = rng.random((b, s))
        slots = (u[..., None] > np.cumsum(
            self._succ_p[toks[:, 0]], -1)[:, None, :]).sum(-1)
        for t in range(s):
            slot = np.minimum(slots[:, t], self.branching - 1)
            # re-draw slot against the *current* state's distribution
            cur = toks[:, t]
            cdf = np.cumsum(self._succ_p[cur], -1)
            slot = (u[:, t, None] > cdf).sum(-1)
            slot = np.minimum(slot, self.branching - 1)
            toks[:, t + 1] = self._succ[cur, slot]
        return toks % self.vocab


def make_dataset(cfg, cell_or_shape, *, seed: int = 0, host_id: int = 0,
                 n_hosts: int = 1, kind: str = "markov",
                 global_batch: Optional[int] = None,
                 seq_len: Optional[int] = None):
    """Dataset for a (ModelConfig, ShapeCell) pair."""
    gb = global_batch or cell_or_shape.global_batch
    sl = seq_len or cell_or_shape.seq_len
    cls = MarkovLMDataset if (kind == "markov" and cfg.frontend == "tokens") \
        else SyntheticDataset
    return cls(
        vocab=cfg.vocab, seq_len=sl, global_batch=gb, seed=seed,
        host_id=host_id, n_hosts=n_hosts, frontend=cfg.frontend,
        d_model=cfg.d_model, n_cross_tokens=cfg.n_cross_tokens,
        d_cross=cfg.d_cross)
