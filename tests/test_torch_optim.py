"""The port's optimizer and gradient compression against the JAX package's.

The same numpy inputs through ``repro.optim`` / ``repro.runtime.compress``
and ``repro_torch.optim`` / ``repro_torch.runtime.compress``:

* the learning-rate schedules at every step 0-200 (both f32): the warmup
  and ``constant`` equal, the cosine within 1e-6 relative (XLA's and
  torch's f32 cos differ in the last bit at a few steps: 2.9e-7 at most);
* one and three AdamW steps, f32 without a master copy (clipping active,
  weight decay 0.1): parameters and moments within 1e-6 relative (the grad
  norm is a sum taken in another order, so its last bits may differ);
  bf16 parameters with an f32 master (clipping off, so that the step is the
  same f32 arithmetic leaf by leaf): the master within 1e-6 relative and the
  bf16 parameters equal after the cast;
* ``clip_by_global_norm`` within 1e-6 relative;
* ``ef_init`` and three steps of ``compress_grads`` (int8, error feedback)
  equal: both round half to even, elementwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro.runtime import compress as RC
from repro_torch import optim as TO
from repro_torch.runtime import compress as TC

SHAPES = {"a": (7, 5), "b": (33,), "c": (4, 3, 6)}


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("name", ["constant", "cosine"])
def test_schedules_equal(name):
    if name == "constant":
        r, t = RO.constant(3e-3), TO.constant(3e-3)
    else:
        r = RO.cosine_with_warmup(3e-3, 10, 150)
        t = TO.cosine_with_warmup(3e-3, 10, 150)
    steps = np.arange(201, dtype=np.int32)
    want = np.array([np.float32(r(jnp.asarray(s))) for s in steps])
    got = t(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy()[:11], want[:11])  # constant, or the warmup
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert t(37) == float(got[37])  # an int step gives a float, the same f32 value


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_f32_matches_jax(n_steps):
    params = _grads(0)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    rs, ts = RO.adamw_init(rp), TO.adamw_init(tp)
    assert ts.master is None
    for i in range(n_steps):
        g = _grads(10 + i, scale=3.0)  # global norm ~25: clipped to 1
        rp, rs, rn = RO.adamw_update({k: jnp.asarray(v) for k, v in g.items()}, rs, rp, 1e-2,
                                     weight_decay=0.1, max_grad_norm=1.0)
        tp, ts, tn = TO.adamw_update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
                                     1e-2, weight_decay=0.1, max_grad_norm=1.0)
        assert _rel(tn, rn) <= 1e-6
    assert int(ts.step) == int(rs.step) == n_steps
    for k in SHAPES:
        assert _rel(tp[k], rp[k]) <= 1e-6, k
        assert _rel(ts.mu[k], rs.mu[k]) <= 1e-6, k
        assert _rel(ts.nu[k], rs.nu[k]) <= 1e-6, k


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_bf16_master_matches_jax(n_steps):
    params = _grads(1)
    rp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()).to(torch.bfloat16) for k, v in params.items()}
    rs, ts = RO.adamw_init(rp, keep_master=True), TO.adamw_init(tp, keep_master=True)
    for i in range(n_steps):
        g = _grads(20 + i)
        rp, rs, _ = RO.adamw_update({k: jnp.asarray(v).astype(jnp.bfloat16)
                                     for k, v in g.items()}, rs, rp, 1e-2, weight_decay=0.1)
        tp, ts, tn = TO.adamw_update({k: torch.from_numpy(v).to(torch.bfloat16)
                                      for k, v in g.items()}, ts, tp, 1e-2, weight_decay=0.1)
        assert float(tn) == 0.0  # no clipping: the reference returns a zero norm
    for k in SHAPES:
        assert tp[k].dtype == torch.bfloat16
        assert _rel(ts.master[k], rs.master[k]) <= 1e-6, k
        np.testing.assert_array_equal(tp[k].float().numpy(),
                                      np.asarray(rp[k].astype(jnp.float32)), err_msg=k)


def test_clip_by_global_norm_matches_jax():
    g = _grads(3, scale=2.0)
    rg, rn = RO.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 0.5)
    tg, tn = TO.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 0.5)
    assert _rel(tn, rn) <= 1e-6
    for k in SHAPES:
        assert _rel(tg[k], rg[k]) <= 1e-6


def test_compress_grads_equal():
    params = _grads(4)
    ref = RC.ef_init({k: jnp.asarray(v) for k, v in params.items()})
    ef = TC.ef_init({k: torch.from_numpy(v) for k, v in params.items()})
    for k in SHAPES:
        np.testing.assert_array_equal(ef[k].numpy(), np.asarray(ref[k]))
    for i in range(3):
        g = _grads(30 + i)
        # a value exactly half-way between two int8 steps rounds to even in both
        g["b"][:4] = np.float32([0.5, 1.5, -2.5, 127.0]) * (np.abs(g["b"]).max() / 127.0)
        rdeq, ref = RC.compress_grads({k: jnp.asarray(v) for k, v in g.items()}, ref)
        tdeq, ef = TC.compress_grads({k: torch.from_numpy(v) for k, v in g.items()}, ef)
        for k in SHAPES:
            np.testing.assert_array_equal(tdeq[k].numpy(), np.asarray(rdeq[k]), err_msg=k)
            np.testing.assert_array_equal(ef[k].numpy(), np.asarray(ref[k]), err_msg=k)
    q, scale = TC.quantize_int8(torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0]))
    assert q.dtype == torch.int8 and q.tolist() == [0, 2, 2, 0, 127]
