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

**Under a mesh** (``runtime/sharding.use_mesh``): :func:`init_train_state`
with ``mesh=`` places each parameter by the reference's ``fsdp_pspecs`` and
AdamW's moments and master by ``zero_pspecs`` (brought to the port's one
module a layer by ``sharding.layer_spec``), as the reference's dry-run
does; :func:`distribute_batch` places a batch on the batch axes; prefill
allocates its caches placed by ``cache_pspecs``.  The train step then runs
on DTensors: each gradient is brought to its parameter's placements, the
grad norm reduces over every shard, AdamW updates each leaf's shards in
place, and the metrics come back as plain tensors.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.optim import AdamWState, adamw_init, adamw_update
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.sharding import ashard
from repro_torch.tracing import span

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
        mesh = x.device_mesh if SH.is_dtensor(x) else None
        caches = T.init_cache(cfg, bsz, max_len, device=x.device, mesh=mesh)
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
        with SH.mesh_scope(SH.capture()):
            # the vocab whole for the argmax (its DTensor rule on a sharded
            # vocab does not run)
            nxt = torch.argmax(ashard(logits[:, -1], ("batch", None)), dim=-1).to(torch.int32)
        return nxt, logits, caches

    return serve_step


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE over all positions (+ z-loss); returns (loss, ce)."""
    logits = ashard(logits.float(), ("batch", None, None))
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
        # the gold logit's gather takes the vocab whole (DTensor's gather
        # on a vocab-sharded dim does not run)
        logits = ashard(logits, ("batch", None, None))
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        return (lse - gold).sum(), torch.square(lse).sum()

    ctx = SH.capture()  # the mesh context a recompute re-enters

    def scoped(h, lab):
        with SH.mesh_scope(ctx):
            return body(h, lab)

    ce_sum = z_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        args = (hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            ce_c, z_c = torch.utils.checkpoint.checkpoint(scoped, *args, use_reentrant=False)
        else:
            ce_c, z_c = scoped(*args)
        ce_sum, z_sum = ce_sum + ce_c, z_sum + z_c
    n = b * s
    ce = ce_sum / n
    return ce + z_loss * z_sum / n, ce


def make_loss_fn(cfg: ModelConfig, ce_chunk: int = 512, registry=None) -> Callable:
    """loss_fn(params, batch) -> (loss, {"loss", "ce", "aux"}): the chunked
    CE of the final hidden states plus the MoE layers' aux losses."""

    def loss_fn(params, batch):
        with _serving_ctx(registry), SH.mesh_scope(SH.capture()):
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
        with span("train.forward", device=True):
            loss, metrics = loss_fn(params, batch)
        with span("train.backward", device=True):
            loss.backward()
        # a parameter the loss does not read (the embedding table of an
        # embeds frontend with its own head) gets zeros, as under jax.grad
        return {k: _as_param(p.grad, p) if p.grad is not None else torch.zeros_like(p)
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
        with span("optim.adamw", device=True) as sp:
            if sp:
                sp.set(params=sum(p.numel() for p in named.values()))
            _, new_opt, gnorm = adamw_update(grads, opt_state, named, lr,
                                             weight_decay=weight_decay,
                                             max_grad_norm=max_grad_norm)
        metrics = {k: SH.to_plain(v.detach()) for k, v in metrics.items()}
        return params, new_opt, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def _as_param(g, p):
    """A DTensor gradient in its parameter's placements (a partial sum
    reduced, a gathered one cut); a plain gradient as it is."""
    if SH.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def init_train_state(cfg: ModelConfig, generator: Optional[torch.Generator],
                     device="cuda", mesh=None) -> Tuple[T.ParamTree, AdamWState]:
    """Trainable parameters from ``generator`` (on ``device``) and their
    AdamW state, with an f32 master copy unless the model is f32.

    With ``mesh`` (every rank draws the same weights from the same seed)
    each parameter becomes a DTensor placed by ``fsdp_pspecs`` and each
    moment and master leaf one placed by ``zero_pspecs`` (the port's
    per-layer specs, ``sharding.port_pspecs``); each rank keeps its shards."""
    params = T.init_params(cfg, generator, device, trainable=True)
    if mesh is None:
        return params, adamw_init(dict(params.named_parameters()),
                                  keep_master=cfg.dtype != "float32")
    return place_train_state(params, cfg, mesh)


def place_train_state(params: T.ParamTree, cfg: ModelConfig, mesh
                      ) -> Tuple[T.ParamTree, AdamWState]:
    """Trainable parameters that are the same on every rank, placed on
    ``mesh`` in place (FSDP specs), and a fresh AdamW state for them (ZeRO
    specs; an f32 master unless the model is f32)."""
    keep_master = cfg.dtype != "float32"
    named = dict(params.named_parameters())
    zero = SH.port_pspecs(named, cfg, mesh, "zero")
    mu, nu, master = {}, {}, {} if keep_master else None
    for name, p in named.items():
        mu[name] = SH.zeros(p.shape, torch.float32, mesh, zero[name])
        nu[name] = SH.zeros(p.shape, torch.float32, mesh, zero[name])
        if keep_master:
            master[name] = SH.distribute(p.detach().float(), mesh, zero[name])
    place_params(params, cfg, mesh, "fsdp")
    device = next(iter(named.values())).device
    return params, AdamWState(torch.zeros((), dtype=torch.int32, device=device), mu, nu, master)


def place_params(params: T.ParamTree, cfg: ModelConfig, mesh, kind: str = "fsdp"
                 ) -> T.ParamTree:
    """The parameters (the same on every rank) as DTensors on ``mesh``, in
    place, by ``sharding.port_pspecs(kind)``: ``"fsdp"`` for training,
    ``"tp"`` for serving; each rank keeps its shards."""
    specs = SH.port_pspecs(dict(params.named_parameters()), cfg, mesh, kind)
    for mod_name, mod in params.named_modules():
        for pname, p in list(mod._parameters.items()):
            full = f"{mod_name}.{pname}" if mod_name else pname
            mod._parameters[pname] = torch.nn.Parameter(
                SH.distribute(p.detach(), mesh, specs[full]), requires_grad=p.requires_grad)
    return params


def distribute_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """A batch that is the same on every rank, placed on the mesh's batch
    axes (``batch_pspec``: replicated where the batch does not divide
    them)."""
    return {k: SH.distribute(v, mesh, SH.batch_pspec(mesh, v.shape[0], v.ndim))
            for k, v in batch.items()}
