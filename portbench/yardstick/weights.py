"""Weights and inputs from the seed, made on the device in a few large calls.

Each kind of weight is one stacked tensor over the layers, drawn by its
own generator (seeded from the run's seed and the kind), in the type the
model is served in: so any one kind can be drawn again later without the
others, and the reference reads exactly the tensors the program was given.
The program's parameters are views of these tensors, in its layout.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

#: (kind, draw order); the order only names each kind's generator
KINDS = ("embed", "lm_head", "final_norm", "norm_attn", "norm_ffn",
         "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def sub_seed(seed: int, *parts: int) -> int:
    """A generator seed from the run's seed and small integers (a
    splitmix-style mix, so nearby seeds give unrelated streams)."""
    x = (int(seed) * _MIX) & _MASK
    for p in parts:
        x = ((x ^ (int(p) + 1)) * _MIX) & _MASK
        x ^= x >> 29
    return x


def generator(device: torch.device, seed: int, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *parts))


def shapes(model: Dict) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """Each kind's stacked shape and fan-in (0: a norm's gain)."""
    d, L, V, ff = model["d_model"], model["n_layers"], model["vocab"], model["d_ff"]
    hd = d // model["n_heads"]
    hq, hkv = model["n_heads"] * hd, model["n_kv_heads"] * hd
    return {"embed": ((V, d), 1), "lm_head": ((V, d), d), "final_norm": ((d,), 0),
            "norm_attn": ((L, d), 0), "norm_ffn": ((L, d), 0),
            "wq": ((L, d, hq), d), "wk": ((L, d, hkv), d), "wv": ((L, d, hkv), d),
            "wo": ((L, hq, d), hq), "w_gate": ((L, d, ff), d), "w_up": ((L, d, ff), d),
            "w_down": ((L, ff, d), ff)}


def draw(model: Dict, seed: int, kind: str, device: torch.device) -> torch.Tensor:
    """One kind's stacked weights: normal(0, 1 / sqrt(fan_in)) for a matrix
    (the embedding table normal(0, 1)), 1 + normal(0, 0.1) for a norm's
    gain; in the model's type."""
    shape, fan_in = shapes(model)[kind]
    dt = getattr(torch, model["dtype"])
    t = torch.randn(shape, generator=generator(device, seed, KINDS.index(kind)),
                    device=device, dtype=dt)
    if fan_in == 0:
        return t.mul_(0.1).add_(1.0)
    return t.mul_(1.0 / math.sqrt(fan_in))


def make(model: Dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    return {kind: draw(model, seed, kind, device) for kind in KINDS}


def port_params(w: Dict[str, torch.Tensor], model: Dict, trainable: bool):
    """The program's parameter tree (``models.transformer.make_params``)
    whose leaves are views of the stacked tensors ``w``."""
    from repro_torch.models import transformer as T

    top = {"embed": {"table": w["embed"]}, "final_norm": w["final_norm"],
           "lm_head": w["lm_head"]}
    blocks = [{"norm_attn": w["norm_attn"][l], "norm_ffn": w["norm_ffn"][l],
               "attn": {k: w[k][l] for k in ("wq", "wk", "wv", "wo")},
               "mlp": {k: w[k][l] for k in ("w_gate", "w_up", "w_down")}}
              for l in range(model["n_layers"])]
    return T.make_params(top, blocks, trainable)


def leaf_names(model: Dict):
    """(program leaf name, stacked kind, layer or None) for every leaf."""
    out = [("embed.table", "embed", None), ("final_norm", "final_norm", None),
           ("lm_head", "lm_head", None)]
    for l in range(model["n_layers"]):
        out += [(f"blocks.{l}.norm_attn", "norm_attn", l),
                (f"blocks.{l}.norm_ffn", "norm_ffn", l)]
        out += [(f"blocks.{l}.attn.{k}", k, l) for k in ("wq", "wk", "wv", "wo")]
        out += [(f"blocks.{l}.mlp.{k}", k, l) for k in ("w_gate", "w_up", "w_down")]
    return out


def prompt(model: Dict, seed: int, wave: int, batch: int, seq: int,
           device: torch.device) -> Dict[str, torch.Tensor]:
    """The inputs of one wave of ``batch`` prompts of ``seq`` positions:
    frame embeddings normal(0, 1) for an ``embeds`` front end, else token
    ids uniform over the vocabulary."""
    g = generator(device, seed, 1000, wave)
    if model["frontend"] == "embeds":
        return {"embeds": torch.randn((batch, seq, model["d_model"]), generator=g,
                                      device=device, dtype=getattr(torch, model["dtype"]))}
    return {"tokens": torch.randint(0, model["vocab"], (batch, seq), generator=g,
                                    device=device)}
