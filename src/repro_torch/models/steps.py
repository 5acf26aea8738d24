"""Step functions of the port: training (loss + AdamW), prefill, decode.

Each builder takes an optional ``registry=`` (a
:class:`~repro_torch.core.registry.ScheduleRegistry` or path): when given,
the step body runs under ``kernels.ops.serving(registry)``, so every dense
site looks its contraction up in the tuned-schedule table and a hit on the
card launches the tiled-matmul kernel.  ``None`` leaves dense sites on the
plain ``@``.  Either way every prefill attention is the flash-attention
kernel, every prefill RWKV-6 time-mix the chunked-scan kernel and every
prefill Mamba mixer the selective-scan kernel (the RWKV-6 and Mamba dense
projections and the MoE experts stay on the plain ``@``, as in the
reference).  Prefill and decode run under ``torch.no_grad()``.

Training (:func:`make_train_step`) is the reference's step: the loss is the
seq-chunked cross-entropy (+ z-loss 1e-4) of :func:`hidden_states` under
the config's remat policy, plus the MoE layers' aux losses; gradients come
from autograd (flash attention's backward kernel, the scans' recompute
backward on the card); optional microbatches accumulate f32 gradients and
divide by their count; an optional ``grad_transform`` (int8 compression)
runs on them; then AdamW (``optim/adamw.py``) updates the parameters in
place.  Train with ``registry=None``: under grad the tiled-matmul route
raises (it has no backward, ROADMAP.md §C 6), and the CPU fallback is the
plain ``@``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.optim import AdamWState, adamw_init, adamw_update

from . import layers as L
from . import transformer as T


def _serving_ctx(registry):
    """`kernels.ops.serving(registry)`, or a no-op when registry is None."""
    if registry is None:
        return contextlib.nullcontext()
    return K.serving(registry)


def make_prefill_step(cfg: ModelConfig, max_len: int, registry=None) -> Callable:
    """prefill(params, batch) -> (last_logits, caches, cache_len); the
    caches are allocated on the batch's device.  A model with cross layers
    takes the encoder states as ``batch["encoder"]`` and keeps their
    projections in the cache for the decode steps."""

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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE over all positions (+ z-loss); returns (loss, ce)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    return ce + z_loss * torch.square(lse).mean(), ce


def chunked_cross_entropy(cfg: ModelConfig, params, hidden: torch.Tensor,
                          labels: torch.Tensor, chunk: int = 512, z_loss: float = 1e-4
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seq-chunked CE: the logits exist one ``(B, chunk, V)`` slice at a time
    (each chunk under ``torch.utils.checkpoint``, recomputed in the
    backward), never the whole ``(B, S, V)``.  Where ``chunk`` (clamped to
    S) does not divide S it falls back to :func:`cross_entropy` over the
    whole logits, as the reference does.  The same value as
    :func:`cross_entropy`."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    head = params.get("lm_head")
    if s % chunk:
        logits = L.logits_apply(params["embed"], hidden, head, cfg.logit_softcap)
        return cross_entropy(logits, labels, z_loss)

    def body(h, lab):
        logits = L.logits_apply(params["embed"], h, head, cfg.logit_softcap).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        return (lse - gold).sum(), torch.square(lse).sum()

    ce_sum = z_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        args = (hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            ce_c, z_c = torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False)
        else:
            ce_c, z_c = body(*args)
        ce_sum, z_sum = ce_sum + ce_c, z_sum + z_c
    n = b * s
    ce = ce_sum / n
    return ce + z_loss * z_sum / n, ce


def make_loss_fn(cfg: ModelConfig, ce_chunk: int = 512, registry=None) -> Callable:
    """loss_fn(params, batch) -> (loss, {"loss", "ce", "aux"}): the chunked
    CE of the final hidden states plus the MoE layers' aux losses."""

    def loss_fn(params, batch):
        with _serving_ctx(registry):
            hidden, _, aux = T.hidden_states(params, cfg, batch)
            loss, ce = chunked_cross_entropy(cfg, params, hidden, batch["labels"],
                                             chunk=ce_chunk)
        loss = loss + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    return loss_fn


def make_train_step(cfg: ModelConfig, lr_fn: Callable, *, weight_decay: float = 0.1,
                    max_grad_norm: Optional[float] = 1.0, n_microbatches: int = 1,
                    grad_transform: Optional[Callable] = None, registry=None) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is a trainable :class:`~repro_torch.models.transformer.ParamTree`,
    updated in place.  ``n_microbatches > 1`` splits the batch's leading
    axis into equal slices, accumulates their gradients in f32 and divides
    by the count; the metrics are the last slice's, as in the reference.
    ``grad_transform`` maps the gradients (a dict keyed by parameter name)
    before the optimizer.  Metrics gain ``grad_norm`` and ``lr``."""
    loss_fn = make_loss_fn(cfg, registry=registry)

    def grads_of(named: Dict[str, torch.Tensor], params, batch):
        for p in named.values():
            p.grad = None
        loss, metrics = loss_fn(params, batch)
        loss.backward()
        # a parameter the loss does not read (the embedding table of an
        # embeds frontend with its own head) gets zeros, as under jax.grad
        return {k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in named.items()}, metrics

    def train_step(params, opt_state: AdamWState, batch):
        named = dict(params.named_parameters())
        if n_microbatches == 1:
            grads, metrics = grads_of(named, params, batch)
        else:
            grads = None
            for i in range(n_microbatches):
                mb = {k: v.reshape(n_microbatches, v.shape[0] // n_microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                g, metrics = grads_of(named, params, mb)
                if grads is None:
                    grads = {k: x.float() for k, x in g.items()}
                else:
                    for k, x in g.items():
                        grads[k].add_(x.float())
            grads = {k: g / n_microbatches for k, g in grads.items()}
        for p in named.values():
            p.grad = None
        if grad_transform is not None:
            grads = grad_transform(grads)
        lr = lr_fn(opt_state.step)
        _, new_opt, gnorm = adamw_update(grads, opt_state, named, lr,
                                         weight_decay=weight_decay,
                                         max_grad_norm=max_grad_norm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, new_opt, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def init_train_state(cfg: ModelConfig, generator: Optional[torch.Generator],
                     device="cuda") -> Tuple[T.ParamTree, AdamWState]:
    """Trainable parameters from ``generator`` (on ``device``) and their
    AdamW state, with an f32 master copy unless the model is f32."""
    params = T.init_params(cfg, generator, device, trainable=True)
    opt = adamw_init(dict(params.named_parameters()), keep_master=cfg.dtype != "float32")
    return params, opt
