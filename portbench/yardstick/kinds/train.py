"""The training step: ``models.steps.make_train_step`` with its model and
AdamW state, at ``batch`` x ``seq_len`` tokens a step.

Set-up builds the step, the parameters (views of the weights the seed
drew) and AdamW's state once, and drives them through the first
``checked_steps`` steps by the window's own call and feed: each step's
batch (inputs and labels) is drawn from the seed and the step's index, so
no two rows repeat.  The window then runs further steps of the same object
until ``--seconds`` have passed, reading each step's loss on the host.

End to end: ``train_tokens_per_s``, the tokens of every step of the window
over the window (a step whose loss is not finite fails the run).

Correct: once the window has closed and the program's state is freed, the
plain reference trains f32 weights drawn again from the seed through the
same first steps, and compared are (worst over steps or leaves): each
step's loss (``loss_rel``), each leaf's gradient norm as AdamW got it at
step one, read back from the program's first moment (``grad_norm_gap``),
and each leaf's norm of change over the checked steps, from the program's
f32 master (``update_norm_gap``).  A gap of norms is measured against the
larger of the leaf's reference norm and the median leaf's; the change
leaves out leaves whose reference gradient is under a thousandth of the
median leaf's (nought to rounding: they move by weight decay alone).
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from .. import port as P
from .. import weights as W
from ..measure import Run, profile_steps, span


def batch(model: Dict, traffic: Dict, seed: int, step: int, device) -> Dict[str, torch.Tensor]:
    b = W.prompt(model, seed, 10_000 + step, traffic["batch"], traffic["seq_len"], device)
    g = W.generator(device, seed, 6000, step)
    b["labels"] = torch.randint(0, model["vocab"], (traffic["batch"], traffic["seq_len"]),
                                generator=g, device=device)
    return b


def leaf_norms(tree: Dict[str, torch.Tensor], names: List[str], scale: float = 1.0
               ) -> torch.Tensor:
    return torch.stack([tree[n].float().norm() * scale for n in names]).cpu()


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        mark_window) -> Dict:
    from repro_torch.models import steps as S
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedules import constant

    model, traffic, opt = cell.model, cell.traffic, cell.config["optimizer"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = P.model_config(model)
    names = [n for n, _, _ in W.leaf_names(model)]
    params = W.port_params(W.make(model, seed, device), model, trainable=True)
    state = adamw_init(dict(params.named_parameters()), keep_master=model["dtype"] != "float32")
    step = S.make_train_step(cfg, constant(opt["lr"]), weight_decay=opt["weight_decay"],
                             max_grad_norm=opt["max_grad_norm"])

    def one(i: int) -> float:
        nonlocal params, state
        with span("portbench.batch"):
            feed = batch(model, traffic, seed, i, device)
        with span("portbench.train_step"):
            params, state, metrics = step(params, state, feed)
        with span("portbench.loss"):
            return float(metrics["loss"])

    losses, first_grads = [], None
    for i in range(traffic["checked_steps"]):
        losses.append(one(i))
        if i == 0:   # the first moment after one step is (1 - b1) g
            first_grads = leaf_norms(state.mu, names, 1.0 / (1.0 - opt["b1"]))
    changes = _changes(model, seed, state.master or dict(params.named_parameters()), device)
    sync()

    mark_window()
    t0 = time.perf_counter()
    done, bad = 0, 0
    while time.perf_counter() - t0 < seconds:
        loss = one(traffic["checked_steps"] + done)
        done += 1
        bad += int(loss != loss or abs(loss) == float("inf"))
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    B, L = traffic["batch"], traffic["seq_len"]
    run_rec = Run("train", model, traffic, window, done, B, L)
    if trace:
        n, base = traffic["traced_steps"], traffic["checked_steps"] + done
        run_rec.trace = profile_steps(lambda j: one(base + j), n, sync, cell.name)
        run_rec.traced_steps = n
    del params, state, step
    if on_card:
        torch.cuda.empty_cache()
    if bad:
        raise SystemExit(f"{bad} of {done} steps of the window gave a loss that is not finite")
    numbers = check(cell, seed, losses, first_grads, changes, device)
    return {"e2e": {"train_tokens_per_s": done * B * L / window}, "attempted": done,
            "failed": bad, "numbers": numbers, "memory_peak_bytes": peak, "run": run_rec}


def _changes(model: Dict, seed: int, master: Dict[str, torch.Tensor], device) -> torch.Tensor:
    """Each leaf's norm of change from the weights the seed drew, each kind
    drawn again on its own."""
    out = {}
    by_kind: Dict[str, list] = {}
    for name, kind, layer in W.leaf_names(model):
        by_kind.setdefault(kind, []).append((name, layer))
    for kind, leaves in by_kind.items():
        w0 = W.draw(model, seed, kind, device)
        for name, layer in leaves:
            p0 = w0 if layer is None else w0[layer]
            out[name] = (master[name].float() - p0.float()).norm()
        del w0
    return torch.stack([out[n] for n, _, _ in W.leaf_names(model)]).cpu()


def gap(prog: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor) -> float:
    """Worst leaf's |prog - ref| / max(ref, median ref) over ``keep``."""
    prog, ref = prog.detach().double()[keep], ref.detach().double()[keep]
    floor = ref.median()
    return float(((prog - ref).abs() / torch.maximum(ref, floor)).max())


def reference_steps(cell, seed: int, device, matmul=None):
    """The plain reference trained from the weights the seed drew through
    the checked steps, with ``matmul`` at every product (None: f32):
    (losses, first gradient norms as AdamW got them, norms of change), by
    leaf in ``weights.leaf_names`` order."""
    model, traffic, opt = cell.model, cell.traffic, cell.config["optimizer"]
    ref = cell.reference()
    ref.no_tf32()
    names = W.leaf_names(model)
    w = {k: W.draw(model, seed, k, device).float().requires_grad_() for k in W.KINDS}
    mu = {k: torch.zeros_like(t) for k, t in w.items()}
    nu = {k: torch.zeros_like(t) for k, t in w.items()}
    losses, first = [], None
    kw = {} if matmul is None else {"matmul": matmul}
    for i in range(traffic["checked_steps"]):
        feed = batch(model, traffic, seed, i, device)
        labels = feed.pop("labels")
        loss = ref.loss(model, w, feed, labels, ref.ACT, cell.config["z_loss"], **kw)
        loss.backward()
        losses.append(float(loss.detach()))
        grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t)) for k, t in w.items()}
        for t in w.values():
            t.grad = None
        gnorm = ref.adamw({k: t.data for k, t in w.items()}, grads, mu, nu, i + 1,
                          opt["lr"], opt)
        if i == 0:
            scale = min(1.0, opt["max_grad_norm"] / (gnorm + 1e-9))
            first = torch.stack([_leaf(grads, (k, l)).norm() * scale
                                 for _, k, l in names]).cpu()
        del grads
    changes = _changes(model, seed, {n: _leaf(w, (k, l)).detach() for n, k, l in names},
                       device)
    del w, mu, nu
    return losses, first, changes


def compared(losses, grads, changes, ref_losses, ref_grads, ref_changes) -> Dict[str, float]:
    """The three numbers of one side's readings against the reference's."""
    moved = ref_grads >= 1e-3 * ref_grads.median()
    keep_all = torch.ones(len(ref_grads), dtype=torch.bool)
    return {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "grad_norm_gap": gap(grads, ref_grads, keep_all),
            "update_norm_gap": gap(changes, ref_changes, moved)}


def check(cell, seed, losses, first_grads, changes, device) -> Dict[str, float]:
    return compared(losses, first_grads, changes, *reference_steps(cell, seed, device))


def _leaf(tree, kind_layer):
    kind, layer = kind_layer
    return tree[kind] if layer is None else tree[kind][layer]
