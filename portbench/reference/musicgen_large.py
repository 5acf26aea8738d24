"""musicgen-large as the benchmark runs it (arXiv:2306.05284), in plain
PyTorch: :mod:`decoder` with a GELU-gated MLP (tanh GELU).

Departures from the published model, the same as the configuration the
program runs (``configs/musicgen-large.json``):

- the EnCodec front end (four codebooks, delay pattern) is a stub: the
  input is one frame embedding a position, (B, S, 2048), and the head
  predicts the next frame's code in one codebook of 2,048;
- RMSNorm, a GELU-gated MLP and rotary positions (theta 10,000) in place
  of MusicGen's LayerNorm, plain GELU MLP and sinusoidal positions;
- no text conditioning (no cross-attention to T5 states).
"""
from __future__ import annotations

from .decoder import ACTS, adamw, loss, no_tf32, prefill  # noqa: F401

ACT = ACTS["gelu_tanh"]
