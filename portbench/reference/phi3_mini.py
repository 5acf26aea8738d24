"""phi3-mini-3.8b as the benchmark runs it (arXiv:2404.14219), in plain
PyTorch: :mod:`decoder` with a SwiGLU MLP (SiLU gate).

Departures from the published model, the same as the configuration the
program runs (``configs/phi3-mini-3.8b.json``):

- the q, k and v projections are three matrices, and gate and up two, where
  the published checkpoint fuses each group into one matrix: the same
  products;
- rotary positions over the whole head at theta 10,000, with no long-rope
  scaling (the 4k-context model's).
"""
from __future__ import annotations

from .decoder import ACTS, adamw, loss, no_tf32, prefill  # noqa: F401

ACT = ACTS["silu"]
