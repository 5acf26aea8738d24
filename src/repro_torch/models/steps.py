"""Step functions of the port: prefill and decode (the training step comes
with the training slice).

Each builder takes an optional ``registry=`` (a
:class:`~repro_torch.core.registry.ScheduleRegistry` or path): when given,
the step body runs under ``kernels.ops.serving(registry)``, so every dense
site looks its contraction up in the tuned-schedule table and a hit on the
card launches the tiled-matmul kernel.  ``None`` leaves dense sites on the
plain ``@``.  Either way every prefill attention is the flash-attention
kernel, every prefill RWKV-6 time-mix the chunked-scan kernel and every
prefill Mamba mixer the selective-scan kernel (the RWKV-6 and Mamba dense
projections and the MoE experts stay on the plain ``@``, as in the
reference).  Steps run under ``torch.no_grad()``.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K

from . import transformer as T


def _serving_ctx(registry):
    """`kernels.ops.serving(registry)`, or a no-op when registry is None."""
    if registry is None:
        return contextlib.nullcontext()
    return K.serving(registry)


def make_prefill_step(cfg: ModelConfig, max_len: int, registry=None) -> Callable:
    """prefill(params, batch) -> (last_logits, caches, cache_len); the
    caches are allocated on the batch's device."""

    def prefill(params, batch):
        x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        bsz, s = x.shape[:2]
        caches = T.init_cache(cfg, bsz, max_len, device=x.device)
        with torch.no_grad(), _serving_ctx(registry):
            logits, caches, _ = T.forward(params, cfg, batch, caches=caches)
        return logits[:, -1], caches, s

    return prefill


def make_decode_step(cfg: ModelConfig, registry=None) -> Callable:
    """serve_step(params, batch, caches, cache_len) ->
    (next_token, logits, caches) — one new token against the cache."""

    def serve_step(params, batch, caches, cache_len: int):
        with torch.no_grad(), _serving_ctx(registry):
            logits, caches = T.decode_step(params, cfg, batch, caches, cache_len)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, logits, caches

    return serve_step
