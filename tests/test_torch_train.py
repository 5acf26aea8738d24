"""The port's training step against the JAX package's, on the CPU.

For every architecture's smoke config (one period at d_model 64, f32):
JAX ``init_params`` weights carried across with ``params_from_jax``
(trainable), one batch from the data pipeline (equal in both packages),
then the loss, ce and aux of the port's ``make_loss_fn`` and every gradient
leaf against ``jax.value_and_grad(repro.models.steps.make_loss_fn(cfg))``.
The limit is 5e-4 relative per leaf (max |Δ| / max |g|), the JAX package's
own tolerance for its flash-attention gradient (tests/test_attention.py):
the two packages sum in other orders, and the port's attention backward is
the flash backward's plain version here.  The optimizer step, remat and
the kernels' gradients are in ``test_torch_train_step.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.data import make_dataset
from repro.models import steps as RS
from repro.models import transformer as RT
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import steps as TS
from repro_torch.models.convert import params_from_jax, to_jax_layout

GRAD_LIMIT = 5e-4
BATCH, SEQ = 2, 16


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _setup(arch, seed=0, seq=SEQ, batch=BATCH, **kw):
    r_cfg = dataclasses.replace(r_get_config(arch).smoke(), **kw)
    t_cfg = dataclasses.replace(get_config(arch).smoke(), **kw)
    params = RT.init_params(r_cfg, jax.random.PRNGKey(seed))
    batch_np = make_dataset(r_cfg, None, seed=seed, global_batch=batch, seq_len=seq).batch(1)
    return r_cfg, t_cfg, params, batch_np


def _port(t_cfg, params, batch_np):
    tp = params_from_jax(jax.tree.map(np.asarray, params), t_cfg, "cpu", trainable=True)
    return tp, {k: torch.from_numpy(v) for k, v in batch_np.items()}


def _port_grads(params, t_cfg):
    named = dict(params.named_parameters())
    return _leaves(to_jax_layout({k: p.grad if p.grad is not None else torch.zeros_like(p)
                                  for k, p in named.items()}, t_cfg))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_jax(arch):
    _check_loss_and_grads(*_setup(arch))


def _cut_gemma3(cfg):
    """gemma3-12b's smoke config at its published head dim 256, its period
    of five local layers (window cut to 8) and one global layer."""
    period = tuple(dataclasses.replace(spec, window=8) if spec.window else spec
                   for spec in cfg.period)
    return dataclasses.replace(cfg.smoke(), head_dim=256, period=period)


def test_gemma3_period_at_head_dim_256_matches_jax():
    """One period of gemma3-12b's 5:1 pattern at D = 256, on 2 x 32 tokens so
    that the local layers' window of 8 masks: the loss and every gradient
    leaf against the reference's (the flash backward's D = 256 path on both
    sides: the plain version here, the reference's ``_flash_bwd``)."""
    r_cfg, t_cfg = _cut_gemma3(r_get_config("gemma3-12b")), _cut_gemma3(get_config("gemma3-12b"))
    assert [spec.window for spec in t_cfg.period] == [8] * 5 + [None]
    assert (t_cfg.head_dim_, t_cfg.n_heads, t_cfg.n_kv_heads) == (256, 4, 2)
    params = RT.init_params(r_cfg, jax.random.PRNGKey(0))
    batch_np = make_dataset(r_cfg, None, seed=0, global_batch=BATCH, seq_len=32).batch(1)
    _check_loss_and_grads(r_cfg, t_cfg, params, batch_np)


def _check_loss_and_grads(r_cfg, t_cfg, params, batch_np):
    (loss, m), grads = jax.value_and_grad(RS.make_loss_fn(r_cfg), has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch_np.items()})
    tp, batch = _port(t_cfg, params, batch_np)
    t_loss, t_m = TS.make_loss_fn(t_cfg)(tp, batch)
    t_loss.backward()
    for key, want in (("loss", loss), ("ce", m["ce"]), ("aux", m["aux"])):
        assert abs(float(t_m[key].detach()) - float(want)) <= 1e-5 * max(1.0, abs(float(want))), key
    want, got = _leaves(grads), _port_grads(tp, t_cfg)
    assert got.keys() == want.keys()
    worst = {k: _rel(got[k], want[k]) for k in want if np.abs(want[k]).max() > 0}
    bad = {k: e for k, e in worst.items() if not e <= GRAD_LIMIT}
    assert not bad, bad
    for k in want:  # a leaf the loss does not read has zero gradient in both
        if np.abs(want[k]).max() == 0:
            assert np.abs(got[k]).max() == 0, k
