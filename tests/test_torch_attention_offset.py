"""The port's attention of a block of queries over a cache, and its
chunk-folded ``local_attention``, on the CPU against the JAX package's.

``repro_torch.models.layers.attention`` at S > 1 with a ``q_offset`` or a
``kv_len`` (the blocked form in plain torch ops) and ``local_attention``
against ``repro.models.layers.attention`` and ``local_attention`` on the
same numpy inputs from a seed: values at the tolerances of
``tests/test_torch_attention.py`` (3e-5 f32, 3e-2 bf16), and the gradients
of q, k and v (torch autograd against ``jax.grad`` of the reference's
custom VJP) at 5e-4 in f32, the JAX package's flash-gradient tolerance
(``tests/test_attention.py``), and at the bf16 value tolerance in bf16.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as TL

TOL = {"float32": 3e-5, "bfloat16": 3e-2}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 3e-2}

# (B, S, T, H, HKV, D, q_offset, kv_len, window, softcap, dtype)
CASES = {
    "offset5": (2, 8, 16, 4, 4, 16, 5, None, None, None, "float32"),
    "offset9_kv_len": (2, 7, 20, 4, 2, 16, 9, 14, None, None, "float32"),
    "window_softcap20_gqa4": (1, 12, 24, 4, 1, 8, 9, 21, 6, 20.0, "float32"),
    "bf16_gqa2": (2, 8, 16, 4, 2, 16, 5, 13, None, 20.0, "bfloat16"),
    "bf16_window": (1, 9, 24, 4, 4, 32, 9, None, 5, None, "bfloat16"),
    # S > q_block (512) pads the queries; T > kv_block (1024) pads the keys
    "s600_padded": (1, 600, 1100, 2, 1, 8, 500, 1050, None, None, "float32"),
    "s600_window": (1, 600, 700, 2, 2, 8, 100, None, 64, 20.0, "float32"),
    # rows at positions 6 and 7 see no key (kv_len 5, window 2)
    "no_visible_key": (1, 6, 8, 2, 2, 16, 2, 5, 2, None, "float32"),
}


def _arrays(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    if dtype == "bfloat16":  # both packages see the same rounded values
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    return arrs


def _torch(a, grad=False):
    t = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
         if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a))
    return t.requires_grad_(grad)


def _close(out, ref, tol):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _check(t_fn, r_fn, arrs, dtype, seed, check_dv=True):
    """Values, then the gradients of sum(out * w) for a random w; returns
    (out, w, the port's gradients, the reference's)."""
    tq = [_torch(a, grad=True) for a in arrs]
    out = t_fn(*tq)
    w = np.random.default_rng(seed + 100).standard_normal(tuple(out.shape), dtype=np.float32)

    def loss(*xs):
        ref = r_fn(*xs)
        return jnp.sum(ref.astype(jnp.float32) * w), ref

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a) for a in arrs))
    assert tuple(out.shape) == ref.shape and out.dtype == tq[2].dtype
    _close(out, ref, TOL[dtype])
    (out.float() * torch.from_numpy(w)).sum().backward()
    for t, g in list(zip(tq, grads))[:3 if check_dv else 2]:
        _close(t.grad, g, GRAD_TOL[dtype])
    return out, w, [t.grad for t in tq], grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_at_an_offset_matches(name):
    b, s, t, h, hkv, d, off, kv_len, window, softcap, dtype = CASES[name]
    arrs = _arrays(((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)), dtype, seed=len(name))
    kw = dict(causal=True, q_offset=off, kv_len=kv_len, window=window, softcap=softcap)
    blind = name == "no_visible_key"
    out, w, tgrads, rgrads = _check(lambda q, k, v: TL.attention(q, k, v, **kw),
                                    lambda q, k, v: RL.attention(q, k, v, **kw), arrs,
                                    dtype, len(name), check_dv=not blind)
    if blind:
        # such a row averages v over the kv length (T <= kv_block: no padding)
        rows = np.arange(s) + off >= kv_len + window - 1
        assert rows.sum() == 2
        np.testing.assert_allclose(out[:, rows].detach().numpy(),
                                   np.broadcast_to(arrs[2].mean(axis=1, keepdims=True),
                                                   (b, 2, h, d)), rtol=1e-6, atol=1e-6)
        # autograd gives each key 1/T of such a row's cotangent; the
        # reference's backward recomputes p = exp(-1e30 - lse) with lse =
        # -1e30 + log T rounded to -1e30, so it gives each key all of it
        # (ROADMAP.md §C): dv differs by exactly (1 - 1/T) of their sum
        extra = (1.0 - 1.0 / t) * w[:, rows].sum(axis=1, keepdims=True)
        extra = extra.reshape(b, 1, hkv, h // hkv, d).sum(axis=3)
        np.testing.assert_allclose(np.asarray(rgrads[2]) - tgrads[2].numpy(),
                                   np.broadcast_to(extra, (b, t, hkv, d)),
                                   rtol=5e-4, atol=5e-4)


def test_offset_takes_a_0dim_tensor():
    b, s, t, h, hkv, d, off, kv_len, window, softcap, dtype = CASES["offset9_kv_len"]
    q, k, v = (_torch(a) for a in _arrays(((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)),
                                          dtype, seed=3))
    as_int = TL.attention(q, k, v, q_offset=off, kv_len=kv_len)
    as_tensor = TL.attention(q, k, v, q_offset=torch.tensor(off, dtype=torch.int32),
                             kv_len=torch.tensor(kv_len, dtype=torch.int32))
    assert torch.equal(as_int, as_tensor)


@pytest.mark.parametrize("s,w", [(64, 16), (100, 32), (48, 48), (40, 64)])
def test_local_attention_matches(s, w):
    arrs = _arrays(((2, s, 4, 8), (2, s, 2, 8), (2, s, 2, 8)), "float32", seed=s + w)
    _check(lambda q, k, v: TL.local_attention(q, k, v, window=w),
           lambda q, k, v: RL.local_attention(q, k, v, window=w), arrs, "float32", s)


def test_local_attention_softcap_bf16_matches():
    arrs = _arrays(((1, 70, 4, 16), (1, 70, 2, 16), (1, 70, 2, 16)), "bfloat16", seed=9)
    _check(lambda q, k, v: TL.local_attention(q, k, v, window=24, softcap=20.0),
           lambda q, k, v: RL.local_attention(q, k, v, window=24, softcap=20.0),
           arrs, "bfloat16", 9)


def test_kv_positions_takes_one_query_row():
    q, k, v = (torch.zeros(1, n, 2, 16) for n in (4, 8, 8))
    with pytest.raises(NotImplementedError, match="S == 1"):
        TL.attention(q, k, v, q_offset=3, kv_positions=torch.arange(8))
