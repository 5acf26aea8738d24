"""Faults planted under the timed path, to show that ``correct`` catches
them: each is a context manager that breaks one program entry point while
it is open (the tests on the CPU; a fault's readings on the card).

- ``altered_answer("prefill")``: the prefill step returns the first
  request's last logits with its best entry pushed down (its first token
  altered where it is produced);
- ``altered_answer("tune")``: ``tuned_einsum`` returns its product with one
  entry altered;
- ``unchanged_state()``: the training step computes its loss and returns
  the parameters and optimizer state as they were;
- ``half_batch()``: the training step sees the first half of each batch's
  rows only, its loss the mean over them.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def altered_answer(kind: str):
    if kind == "prefill":
        from repro_torch.models import steps

        def make(real):
            def make_prefill_step(*a, **kw):
                prefill = real(*a, **kw)

                def broken(params, batch):
                    last, caches, n = prefill(params, batch)
                    last = last.clone()
                    last[0, last[0].argmax()] -= 2 * last[0].abs().max() + 1
                    return last, caches, n

                return broken

            return make_prefill_step

        return _patched(steps, "make_prefill_step", make)
    if kind == "tune":
        from repro_torch.kernels import ops

        def make(real):
            def tuned_einsum(*a, **kw):
                out = real(*a, **kw).clone()
                out.view(-1)[0] += out.abs().max()
                return out

            return tuned_einsum

        return _patched(ops, "tuned_einsum", make)
    raise ValueError(kind)


def unchanged_state():
    from repro_torch.models import steps

    def make(real):
        def make_train_step(cfg, lr_fn, **kw):
            loss_fn = steps.make_loss_fn(cfg)

            def broken(params, state, batch):
                with torch.no_grad():
                    _, metrics = loss_fn(params, batch)
                return params, state, metrics

            return broken

        return make_train_step

    return _patched(steps, "make_train_step", make)


def half_batch():
    from repro_torch.models import steps

    def make(real):
        def make_train_step(*a, **kw):
            step = real(*a, **kw)

            def broken(params, state, batch):
                half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
                return step(params, state, half)

            return broken

        return make_train_step

    return _patched(steps, "make_train_step", make)
