"""The port's MoE FFN on the CPU against the JAX package's.

``_dispatch_indices`` against JAX's as integers (slot, keep, token map,
filled), at capacity factor 1.25, where tokens drop, and 8.0, where none do;
``moe_apply``'s output and aux values (aux loss, z loss, drop fraction)
against ``models/moe.py`` at 1e-5 in f32 and against ``moe_ref_dense`` when
nothing drops; the sequence-chunked dispatch and the shared expert.  Inputs
come from numpy with a seed, weights from JAX's initialiser.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as RMoE
from repro.models import moe as RX
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.models import moe as TX

TOL = 1e-5       # max abs diff / max abs, f32
BF16_TOL = 3e-2  # the same in bf16


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


_moe_apply = jax.jit(RX.moe_apply, static_argnums=(2, 3))


def _cfgs(**kw):
    kw = {"n_experts": 4, "top_k": 2, "d_ff_expert": 32, **kw}
    return RMoE(**kw), TMoE(**kw)


def _params(r_cfg, d, dtype="float32", seed=1):
    p = RX.moe_params(jax.random.PRNGKey(seed), d, r_cfg, getattr(jnp, dtype))

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        t = torch.from_numpy(np.array(tree, np.float32))
        return t.to(torch.bfloat16) if tree.dtype == jnp.bfloat16 else t

    return p, conv(p)


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    return jnp.asarray(x), torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("factor,n,e,k", [(1.25, 40, 4, 2), (8.0, 40, 4, 2), (1.25, 4, 16, 2),
                                          (1.25, 64, 16, 2), (1.0, 33, 8, 1)])
def test_dispatch_indices_equal_jax(factor, n, e, k):
    """The same routing gives the same slots, kept assignments, inverse
    token map and filled slots, integer for integer; (1.25, 4, 16, 2) is
    jamba's decode at batch 4 (capacity 2)."""
    cap = RX._capacity(n, RMoE(n_experts=e, top_k=k, d_ff_expert=8, capacity_factor=factor))
    assert cap == TX._capacity(n, TMoE(n_experts=e, top_k=k, d_ff_expert=8,
                                       capacity_factor=factor))
    # top-k of random router scores, with the last expert first choice of
    # the first cap + 1 tokens: it overflows wherever cap < n
    scores = np.random.default_rng(n * e + k).random((n, e))
    scores[:cap + 1, e - 1] += 10.0
    expert_idx = np.argsort(-scores, axis=1)[:, :k]
    want = RX._dispatch_indices(jnp.asarray(expert_idx, jnp.int32), e, cap)
    got = TX._dispatch_indices(torch.from_numpy(expert_idx), e, cap)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy().astype(np.int64),
                                      np.asarray(w_).astype(np.int64))
    keep = np.asarray(want[1])
    assert keep.all() == (factor == 8.0)  # drops at the low factors only


@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(factor, dtype):
    r_cfg, t_cfg = _cfgs(capacity_factor=factor)
    p, tp = _params(r_cfg, 64, dtype)
    jx, tx = _x((2, 12, 64), dtype, seed=2)
    want, waux = _moe_apply(p, jx, r_cfg)
    got, gaux = TX.moe_apply(tp, tx, t_cfg)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= (
        TOL if dtype == "float32" else BF16_TOL)
    assert set(gaux) == set(waux) == {"moe_aux_loss", "moe_z_loss", "moe_drop_frac"}
    for name in gaux:
        assert gaux[name].dtype == torch.float32
        np.testing.assert_allclose(gaux[name].item(), float(waux[name]), rtol=1e-5, atol=1e-7)
    assert (gaux["moe_drop_frac"].item() > 0) == (factor == 1.25)


def test_moe_apply_matches_the_dense_oracle_when_nothing_drops():
    r_cfg, t_cfg = _cfgs(capacity_factor=8.0)
    p, tp = _params(r_cfg, 64, seed=3)
    jx, tx = _x((2, 10, 64), "float32", seed=3)
    got, aux = TX.moe_apply(tp, tx, t_cfg)
    assert aux["moe_drop_frac"].item() == 0.0
    dense = TX.moe_ref_dense(tp, tx, t_cfg)
    assert _rel(got.numpy(), dense.numpy()) <= TOL
    assert _rel(dense.numpy(), np.asarray(RX.moe_ref_dense(p, jx, r_cfg))) <= TOL


@pytest.mark.parametrize("shared", [False, True])
def test_chunked_dispatch_and_shared_expert_match_jax(shared):
    """A dispatch chunk below the token count slices the sequence (capacity
    per chunk, aux values averaged); a shared expert adds a dense MLP."""
    r_cfg, t_cfg = _cfgs(capacity_factor=1.25, dispatch_chunk=16, shared_expert=shared)
    p, tp = _params(r_cfg, 32, seed=4)
    assert ("shared" in tp) == shared
    jx, tx = _x((2, 24, 32), "float32", seed=4)
    want, waux = _moe_apply(p, jx, r_cfg)
    got, gaux = TX.moe_apply(tp, tx, t_cfg)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL
    for name in gaux:
        np.testing.assert_allclose(gaux[name].item(), float(waux[name]), rtol=1e-5, atol=1e-7)


def test_moe_params_make_each_leaf_as_jax_does():
    """Names, shapes and dtypes of a bf16 MoE layer: the router stays f32."""
    r_cfg, t_cfg = _cfgs(shared_expert=True)
    shapes = jax.eval_shape(lambda key: RX.moe_params(key, 32, r_cfg, jnp.bfloat16),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    got = TX.moe_params(None, 32, t_cfg, torch.bfloat16, "meta")
    flat = {**{k: v for k, v in got.items() if k != "shared"},
            **{f"shared.{k}": v for k, v in got["shared"].items()}}
    want = {**{k: v for k, v in shapes.items() if k != "shared"},
            **{f"shared.{k}": v for k, v in shapes["shared"].items()}}
    assert set(flat) == set(want)
    for name, t in flat.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype) == f"torch.{want[name].dtype}", name
