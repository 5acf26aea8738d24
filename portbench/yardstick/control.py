"""The control of each kind: the plain reference put in the program's
place, one precision below what the configuration states (bf16 -> fp8:
every product's operands rounded to float8 e4m3, one scale a tensor,
accumulated in f32), judged by the same numbers against the f32 reference.
A control that the limits pass would mean the limits cannot tell such a
step from the program; its readings set each limit's upper end.

The control needs no window: it reads the inputs a run of the seed would
have checked (the sampled waves, every contraction, the checked steps).
"""
from __future__ import annotations

import random
from typing import Dict

import torch

from . import compare as C
from . import weights as W
from .kinds import train as TRAIN
from .kinds import tune as TUNE


def prefill(cell, seed: int, device: torch.device) -> Dict[str, float]:
    model, traffic = cell.model, cell.traffic
    B, L = traffic["clients"], traffic["prompt_len"]
    ref = cell.reference()
    ref.no_tf32()
    w = W.make(model, seed, device)
    rng = random.Random(W.sub_seed(seed, 3000))
    sampled = sorted(rng.sample(range(traffic["sample_from"]), traffic["sampled_waves"]))
    worst = {"logits_rel": 0.0, "kv_rel": 0.0, "token_gap": 0.0}
    for i in sampled:
        inputs = W.prompt(model, seed, i, B, L, device)
        kv = {}
        want = ref.prefill(model, w, inputs, ref.ACT, all_positions=True,
                           on_kv=lambda l, k, v: kv.__setitem__(l, (k, v)))

        def on_kv(l, k, v):
            worst["kv_rel"] = max(worst["kv_rel"], C.rel_err(k, kv[l][0]),
                                  C.rel_err(v, kv[l][1]))

        got = ref.prefill(model, w, inputs, ref.ACT, matmul=C.fp8_matmul, all_positions=True,
                          on_kv=on_kv)
        for r in range(B):
            worst["logits_rel"] = max(worst["logits_rel"], C.rel_err(got[r, -1], want[r, -1]))
        worst["token_gap"] = max(worst["token_gap"], C.served_gap(want, got.argmax(dim=-1)))
        del kv, want, got
    return worst


def tune(cell, seed: int, device: torch.device) -> Dict[str, float]:
    torch.backends.cuda.matmul.allow_tf32 = False
    traffic = cell.traffic
    dt = getattr(torch, traffic["dtype"])
    worst = 0.0
    for i, (m, k, n) in enumerate(TUNE.contractions(traffic)):
        g = W.generator(device, seed, 5000, i)
        a = torch.randn((m, k), generator=g, device=device).to(dt)
        b = torch.randn((k, n), generator=g, device=device).to(dt)
        worst = max(worst, C.rel_err(C.fp8_matmul(a, b), a.float() @ b.float()))
    return {"served_rel": worst}


def train(cell, seed: int, device: torch.device) -> Dict[str, float]:
    """The fp8 reference's first steps in the program's place: its losses,
    first gradient norms and changes, against the f32 reference's."""
    side = TRAIN.reference_steps(cell, seed, device, C.fp8_matmul)
    return TRAIN.compared(*side, *TRAIN.reference_steps(cell, seed, device))


CONTROLS = {"prefill": prefill, "tune": tune, "train": train}
