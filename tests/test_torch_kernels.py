"""The port's kernel layer on the CPU: the tiled matmul's plain version over
a shape/block/order sweep with tails, ``_parse_matmul_spec`` and
``tuned_einsum``'s counters against the JAX package's.  The kernel itself
is held against its plain version in ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import LoopTuner as RTuner
from repro.kernels import ops as rops
from repro.kernels.matmul import matmul as jax_matmul
from repro_torch.core import LoopTuner as TTuner
from repro_torch.core import matmul_benchmark
from repro_torch.kernels import ops as tops
from repro_torch.kernels.matmul import matmul, matmul_plain

SWEEP = [(m, k, n, blk, order)
         for (m, k, n) in [(1, 1, 1), (7, 13, 5), (33, 64, 17), (64, 48, 96),
                           (130, 70, 33)]
         for blk in [(8, 8, 16), (32, 64, 128), (128, 128, 128), (4, 1, 64)]
         for order in ("mn", "nm")]


def _operands(m, k, n, seed=0, trans_b=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((n, k) if trans_b else (k, n), dtype=np.float32)
    return a, b


@pytest.mark.parametrize("m,k,n,blk,order", SWEEP)
def test_plain_tiled_matmul_sweep(m, k, n, blk, order):
    a, b = _operands(m, k, n, seed=m * 7 + k)
    bm, bk, bn = blk
    for trans_b in (False, True):
        bb = np.ascontiguousarray(b.T) if trans_b else b
        out = matmul_plain(torch.from_numpy(a), torch.from_numpy(bb), bm=bm,
                           bk=bk, bn=bn, grid_order=order, trans_b=trans_b)
        assert out.shape == (m, n) and out.dtype == torch.float32
        # f32 accumulation in another order than one f32 product
        np.testing.assert_allclose(out.numpy(), a @ b, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("m,k,n,blk,order", SWEEP[::5])
def test_plain_tiled_matmul_matches_pallas_interpret(m, k, n, blk, order):
    a, b = _operands(m, k, n, seed=3)
    bm, bk, bn = blk
    out = matmul(torch.from_numpy(a), torch.from_numpy(b), bm=bm, bk=bk, bn=bn,
                 grid_order=order)  # CPU tensors: the plain version
    ref = jax_matmul(jnp.asarray(a), jnp.asarray(b), bm=bm, bk=bk, bn=bn,
                     grid_order=order, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        matmul(a, torch.zeros(7, 3))
    with pytest.raises(TypeError):
        matmul(a.double(), torch.zeros(8, 3).double())
    with pytest.raises(ValueError):
        matmul(a, torch.zeros(8, 3), grid_order="km")
    with pytest.raises(ValueError):
        matmul(a, torch.zeros(8, 3), bm=0)


SPECS = [("...k,kn->...n", (2, 3, 8), (8, 5)), ("abk,kn->abn", (2, 3, 8), (8, 5)),
         ("bsd,vd->bsv", (2, 3, 8), (5, 8)), ("mk,kn->mn", (4, 8), (8, 5)),
         ("mk,nk->mn", (4, 8), (5, 8)), ("bsk,kn->bsn", (1, 4, 16), (16, 32)),
         ("km,kn->mn", (8, 4), (8, 5)), ("mk,kn->nm", (4, 8), (8, 5)),
         ("bmk,bkn->bmn", (2, 4, 8), (2, 8, 5)), ("mk,kn", (4, 8), (8, 5)),
         ("...k,...kn->...n", (2, 8), (8, 5)), ("k...,kn->...n", (8, 2), (8, 5)),
         ("mk,kn,nj->mj", (4, 8), (8, 5)), ("mkk,kn->mn", (4, 8, 8), (8, 5)),
         ("...,kn->...n", (2, 8), (8, 5)), ("mk,mn->kn", (4, 8), (4, 5))]


@pytest.mark.parametrize("spec,a_shape,b_shape", SPECS)
def test_parse_matmul_spec_matches(spec, a_shape, b_shape):
    assert tops._parse_matmul_spec(spec, a_shape, b_shape) == \
        rops._parse_matmul_spec(spec, a_shape, b_shape)


def _tuned_registries(m, k, n):
    kw = dict(policy="search", backend="tpu", surrogate="off")
    t = TTuner(**kw)
    r = RTuner(**kw)
    t.tune(matmul_benchmark(m, k, n), max_evals=12, budget_s=600.0)
    r.tune(matmul_benchmark(m, k, n), max_evals=12, budget_s=600.0)
    return t.registry, r.registry


@pytest.mark.parametrize("spec,b_shape", [("bsk,kn->bsn", (64, 48)),
                                          ("bsd,vd->bsv", (48, 64))])
def test_tuned_einsum_counts_and_values_match(spec, b_shape):
    treg, rreg = _tuned_registries(2 * 16, 64, 48)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 64), dtype=np.float32)
    w = rng.standard_normal(b_shape, dtype=np.float32)
    miss = rng.standard_normal((1, 3, 64), dtype=np.float32)
    tops.reset_serving_stats()
    rops.reset_serving_stats()
    with tops.serving(treg):
        t_out = tops.tuned_einsum(spec, torch.from_numpy(x), torch.from_numpy(w))
        t_on = tops.tuned_einsum(spec, torch.from_numpy(x), torch.from_numpy(w),
                                 kernel="on")
        tops.tuned_einsum(spec, torch.from_numpy(miss), torch.from_numpy(w))
    with rops.serving(rreg):
        r_out = rops.tuned_einsum(spec, jnp.asarray(x), jnp.asarray(w))
        rops.tuned_einsum(spec, jnp.asarray(x), jnp.asarray(w))
        rops.tuned_einsum(spec, jnp.asarray(miss), jnp.asarray(w))
    t_stats, r_stats = tops.serving_stats(), rops.serving_stats()
    assert (t_stats["hits"], t_stats["misses"]) == (r_stats["hits"], r_stats["misses"]) \
        == (2, 1)
    assert r_stats["routed"] == 0  # JAX routes only on a TPU
    assert t_stats["routed"] == 1  # kernel="on" forces the route on the CPU
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t_on.numpy(), np.asarray(r_out), rtol=2e-5, atol=2e-5)
