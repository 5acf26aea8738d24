"""Mixture-of-Experts FFN with gather-based capacity dispatch, in torch.

The JAX package's ``models/moe.py`` with the same names, arguments and
layouts, in plain torch (the reference has no Pallas kernel here).
Dispatch is an *inverse token map*: an ``(E*C,)`` scatter records which
token fills each expert-capacity slot, tokens are gathered into the
``(E, C, D)`` expert buffer, the experts run as batched products, and the
combine adds each slot's output back to its token, gate-weighted.  Slots are
assigned exactly as the reference assigns them (a stable sort by expert,
then the rank within each expert's run), so the same routing drops the same
tokens: a kept assignment goes to slot ``expert * C + rank``, a dropped one
(rank >= C) to the sentinel ``E * C``, which the scatters write into one
spare slot that is then cut off.  Long sequences are sliced into
``dispatch_chunk``-token chunks (capacity is per chunk), as in the
reference.

Covers jamba (16 experts top-2) and, with a shared expert, llama4-scout's
layout.

Under a mesh the reference's constraints hold (``ashard``): tokens on
``tokens_dp`` (batch axes), the expert buffer on (``expert`` -> model,
``seq`` -> data).  DTensor has no sharding strategy for the slot assignment
(``searchsorted``, the scatters) or the combine's ``index_add_``, so those
run through ``local_map``, and so do the top-k routing (token by token, on
each rank's tokens) and the dispatch's gather, whose backwards would build
plain tensors among DTensors: the assignment and the gather on the whole
(replicated) routing and tokens, the same on every rank, and the combine on each rank's slice of the expert
buffer into a partial (N, D) sum that ``ashard`` then reduces, as GSPMD
lowers the reference's scatter (local updates + a reduction).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.runtime import sharding as SH
from repro_torch.runtime.sharding import ashard

from .layers import _ACTS, dense_init, mlp_apply, mlp_params


def moe_params(generator, d_model: int, moe_cfg, dtype, device) -> Dict[str, Any]:
    e, dff = moe_cfg.n_experts, moe_cfg.d_ff_expert
    p: Dict[str, Any] = {
        "router": dense_init(generator, (d_model, e), torch.float32, device),
        "w_gate": dense_init(generator, (e, d_model, dff), dtype, device),
        "w_up": dense_init(generator, (e, d_model, dff), dtype, device),
        "w_down": dense_init(generator, (e, dff, d_model), dtype, device),
    }
    if moe_cfg.shared_expert:
        p["shared"] = mlp_params(generator, d_model, dff, dtype, device)
    return p


def _capacity(n_tokens: int, moe_cfg) -> int:
    cap = int(n_tokens * moe_cfg.top_k * moe_cfg.capacity_factor / moe_cfg.n_experts)
    return max(cap, moe_cfg.top_k)


def _route(p, xt: torch.Tensor, moe_cfg):
    """Router: top-k gates + expert assignment.  xt: (N, D)."""
    logits = xt.float() @ p["router"]  # (N, E) f32
    if SH.is_dtensor(logits):  # token by token, on each rank's tokens
        pl = tuple(logits.placements)
        return (logits, *SH.local_call(lambda lg: _gates(lg, moe_cfg.top_k), (logits,), (pl,),
                                       (pl, pl, pl)))
    return (logits, *_gates(logits, moe_cfg.top_k))


def _gates(logits: torch.Tensor, top_k: int):
    """(probs, the top-k gates renormalised, their experts), each (N, ...)."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)  # (N, K), sorted
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def _dispatch_indices(expert_idx: torch.Tensor, e: int, cap: int):
    """Capacity-limited slot assignment.

    expert_idx: (N, K).  Returns
      slot (N, K)      — flat index into the (E*C) expert buffer, or E*C (the
                         sentinel) for dropped assignments,
      keep (N, K) bool — assignment kept,
      token_map (E*C,) — inverse map: source token (flat N index) per slot;
                         unfilled slots point at token 0 but contribute 0
                         through ``filled``,
      filled (E*C,)    — slot filled.
    """
    n, k = expert_idx.shape
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1)
    # rank of each assignment within its expert = its position in the
    # expert-capacity buffer (the stable sort keeps token order)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(e, dtype=sorted_e.dtype, device=dev))
    pos_sorted = torch.arange(n * k, device=dev) - start[sorted_e]
    pos = torch.zeros(n * k, dtype=torch.long, device=dev)
    pos[order] = pos_sorted
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)  # sentinel = E*C
    # inverse map: slot -> flat token index; the sentinel writes slot E*C,
    # which is cut off (the reference's mode="drop")
    token_ids = torch.arange(n * k, device=dev) // k
    token_map = torch.zeros(e * cap + 1, dtype=torch.long, device=dev)
    token_map[slot] = token_ids
    filled = torch.zeros(e * cap + 1, dtype=torch.bool, device=dev)
    filled[slot] = keep
    return slot.reshape(n, k), keep.reshape(n, k), token_map[:-1], filled[:-1]


def _experts_ffn(p, xe: torch.Tensor, act: str) -> torch.Tensor:
    """Batched per-expert gated MLP: xe (E, C, D) -> (E, C, D)."""
    gate = _ACTS[act](torch.bmm(xe, p["w_gate"]))
    up = torch.bmm(xe, p["w_up"])
    return torch.bmm(gate * up, p["w_down"])


def _moe_chunk(p, xt: torch.Tensor, moe_cfg, act: str):
    """One chunk of tokens through the routed experts.  xt: (N, D).
    Returns (out (N, D), (aux_loss, z_loss, drop_frac))."""
    n, d = xt.shape
    e = moe_cfg.n_experts
    cap = _capacity(n, moe_cfg)
    xt = ashard(xt, ("tokens_dp", None))

    logits, probs, gate_vals, expert_idx = _route(p, xt, moe_cfg)
    if SH.is_dtensor(xt):
        out, frac_tokens, drop = _dispatch_combine_sharded(p, xt, gate_vals, expert_idx,
                                                           e, cap, act)
    else:
        slot, keep, token_map, filled = _dispatch_indices(expert_idx, e, cap)

        # dispatch: gather tokens into the expert buffer (zero for unfilled slots)
        xe = torch.where(filled[:, None], xt[token_map],
                         torch.zeros((), dtype=xt.dtype, device=xt.device))
        ye = _experts_ffn(p, xe.reshape(e, cap, d), act).reshape(e * cap, d)

        # combine: add each slot's output back to its source token, weighted by
        # the gate (gates mapped onto slots the way the tokens were)
        weight = _slot_weights(slot, gate_vals, filled, e, cap).to(ye.dtype)
        out = torch.zeros((n, d), dtype=xt.dtype, device=xt.device)
        out.index_add_(0, token_map, ye * weight[:, None])
        frac_tokens = _frac_tokens(expert_idx, e)
        drop = 1.0 - keep.float().mean()

    # Switch-style router losses
    frac_probs = probs.mean(0)
    aux_loss = moe_cfg.aux_loss * e * torch.sum(frac_tokens * frac_probs)
    z_loss = moe_cfg.router_z_loss * torch.mean(torch.logsumexp(logits, dim=-1).square())
    return out, (aux_loss, z_loss, drop)


def _slot_weights(slot, gate_vals, filled, e: int, cap: int) -> torch.Tensor:
    """Each capacity slot's gate (0 where unfilled), f32 (E*C,)."""
    gate_map = torch.zeros(e * cap + 1, dtype=torch.float32, device=slot.device)
    gate_map[slot.reshape(-1)] = gate_vals.reshape(-1)
    return gate_map[:-1] * filled.float()


def _frac_tokens(expert_idx, e: int) -> torch.Tensor:
    """The share of tokens whose first choice is each expert."""
    n = expert_idx.shape[0]
    return torch.zeros(e, dtype=torch.float32, device=expert_idx.device).index_add_(
        0, expert_idx[:, 0], torch.ones(n, dtype=torch.float32, device=expert_idx.device)) / n


def _dispatch_combine_sharded(p, xt, gate_vals, expert_idx, e: int, cap: int, act: str):
    """Dispatch, experts and combine on DTensors.  Returns (out (N, D) on
    ``tokens_dp``, the first-choice shares, the dropped share)."""
    from torch.distributed.tensor import Partial, Replicate

    n, d = xt.shape
    whole = tuple(Replicate() for _ in xt.placements)

    def assign(idx, gates):  # the whole routing, the same on every rank
        slot, keep, token_map, filled = _dispatch_indices(idx, e, cap)
        return (token_map, filled, _slot_weights(slot, gates, filled, e, cap),
                _frac_tokens(idx, e), 1.0 - keep.float().mean())

    token_map, filled, weight, frac_tokens, drop = SH.local_call(
        assign, (expert_idx, gate_vals), (whole, whole), (whole,) * 5)

    def gather(x, tm, f):  # dispatch: the expert buffer, zero for unfilled slots
        return torch.where(f[:, None], x[tm], torch.zeros((), dtype=x.dtype, device=x.device))

    xe = SH.local_call(gather, (xt, token_map, filled), (whole,) * 3, (whole,))
    xe = ashard(xe.reshape(e, cap, d), ("expert", "seq", None))
    ye = ashard(_experts_ffn(p, xe, act), ("expert", "seq", None))

    # combine: each rank adds its slots' outputs into a partial (N, D) sum
    slots = tuple(ye.placements)
    partial = tuple(Partial() if pl.is_shard() else Replicate() for pl in slots)

    def combine(ye_l, tm_l, w_l):
        out = torch.zeros((n, d), dtype=ye_l.dtype, device=ye_l.device)
        out.index_add_(0, tm_l.reshape(-1),
                       (ye_l * w_l[..., None].to(ye_l.dtype)).reshape(-1, d))
        return out

    out = SH.local_call(combine, (ye, token_map.reshape(e, cap), weight.reshape(e, cap)),
                        (slots, slots, slots), (partial,))
    return ashard(out, ("tokens_dp", None)), frac_tokens, drop


def moe_apply(p, x: torch.Tensor, moe_cfg, act: str = "silu"
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (out, aux).  Slices the sequence into chunks of at
    least ``moe_cfg.dispatch_chunk`` tokens (capacity is per chunk) and
    averages the chunks' aux values, as the reference's scan does."""
    b, s, d = x.shape
    n = b * s
    chunk = moe_cfg.dispatch_chunk or n
    # largest seq-dim split with >= chunk tokens per slice
    n_chunks = max(1, n // chunk)
    while n_chunks > 1 and s % n_chunks != 0:
        n_chunks -= 1

    if n_chunks == 1:
        xt = ashard(x.reshape(n, d), ("tokens_dp", None))
        out, (aux_l, z_l, drop) = _moe_chunk(p, xt, moe_cfg, act)
    else:
        sl = s // n_chunks
        outs, auxes = [], []
        for i in range(n_chunks):
            # each chunk spans all batch shards (the reference's scan over
            # (None, "batch", None, None) slices)
            xc = ashard(x[:, i * sl:(i + 1) * sl], ("batch", None, None))
            o, a = _moe_chunk(p, xc.reshape(b * sl, d), moe_cfg, act)
            outs.append(ashard(o.reshape(b, sl, d), ("batch", None, None)))
            auxes.append(torch.stack(a))
        out = torch.cat(outs, dim=1).reshape(n, d)
        aux_l, z_l, drop = torch.stack(auxes).mean(0)

    if "shared" in p:
        out = out + mlp_apply(p["shared"], x.reshape(n, d), act)

    aux = {"moe_aux_loss": aux_l, "moe_z_loss": z_l, "moe_drop_frac": drop}
    return out.reshape(b, s, d), aux


def moe_ref_dense(p, x: torch.Tensor, moe_cfg, act: str = "silu") -> torch.Tensor:
    """Oracle: route every token through its top-k experts with NO capacity
    limit (a dense pass per expert).  Used by tests to check dispatch."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    _, _, gate_vals, expert_idx = _route(p, xt, moe_cfg)
    outs = []
    for e_i in range(moe_cfg.n_experts):
        g = _ACTS[act](xt @ p["w_gate"][e_i])
        outs.append((g * (xt @ p["w_up"][e_i])) @ p["w_down"][e_i])
    per_expert = torch.stack(outs, dim=1)  # (N, E, D)
    sel = torch.gather(per_expert, 1, expert_idx[..., None].expand(-1, -1, d))
    out = (sel * gate_vals[..., None].to(x.dtype)).sum(1)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], xt, act)
    return out.reshape(b, s, d)

