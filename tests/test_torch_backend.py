"""The card executor against the JAX package's executors, run on the CPU.

``TorchBackend(device="cpu")`` runs the same lowering the card runs: the
slab path in plain torch ops (``kernel="off"``) and the tiled-matmul route
(``kernel="on"``, which on a CPU tensor takes the kernel's plain version).
Both are held against ``cpu_backend.execute`` and ``execute_jax``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import actions as RA
from repro.core import cpu_backend as RCB
from repro.core import env as RE
from repro.core import loop_ir as RL
from repro.core.jax_backend import execute_jax
from repro.kernels.matmul import matmul as jax_matmul
from repro_torch.core import actions as TA
from repro_torch.core import cpu_backend as TCB
from repro_torch.core import env as TE
from repro_torch.core import loop_ir as TL
from repro_torch.core import make_backend
from repro_torch.core.torch_backend import (TorchBackend, execute_torch,
                                            matmul_launch_args)
from repro_torch.kernels.matmul import matmul_plain

BENCHES = [("matmul", (48, 40, 56)), ("matmul", (33, 17, 64)),
           ("conv2d", (16, 16, 3, 3)), ("reduction", (32, 96)),
           ("transpose", (24, 40))]


def _pair(kind, dims, seed, steps=8):
    rn = RL.LoopNest(getattr(RL, f"{kind}_benchmark")(*dims))
    tn = TL.LoopNest(getattr(TL, f"{kind}_benchmark")(*dims))
    r_acts, t_acts = RA.build_action_space(), TA.build_action_space()
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        ai = int(rng.integers(len(r_acts)))
        RA.apply_action(rn, r_acts[ai])
        TA.apply_action(tn, t_acts[ai])
    assert rn.key() == tn.key()
    return rn, tn


@pytest.mark.parametrize("kind,dims", BENCHES)
@pytest.mark.parametrize("seed", [0, 1])
def test_slab_path_matches_reference_executors(kind, dims, seed):
    rn, tn = _pair(kind, dims, seed)
    arrays = TCB.make_inputs(tn.contraction, seed)
    r_arrays = RCB.make_inputs(rn.contraction, seed)
    for name in arrays:
        np.testing.assert_array_equal(arrays[name], r_arrays[name])
    be = TorchBackend(device="cpu", kernel="off", seed=seed)
    out = be.execute(tn)
    # vec_cap 64 keeps several slabs per section at these sizes
    small = execute_torch(tn, arrays, vec_cap=64, device="cpu")
    ref = RCB.execute_reference(rn.contraction, r_arrays)
    for other in (TCB.execute(tn, arrays), RCB.execute(rn, r_arrays),
                  execute_jax(rn, r_arrays), ref):
        assert np.abs(out - other).max() <= 1e-5
    assert np.abs(small - ref).max() <= 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_route_matches_pallas_kernel_at_the_same_block(seed):
    rn, tn = _pair("matmul", (48, 40, 56), seed, steps=10)
    kw = matmul_launch_args(tn)
    be = TorchBackend(device="cpu", kernel="on", seed=seed)
    assert be._route(tn.contraction) == "matmul"
    out = be.execute(tn)
    arrays = RCB.make_inputs(rn.contraction, seed)
    ref = np.asarray(jax_matmul(jnp.asarray(arrays["A"]), jnp.asarray(arrays["B"]),
                                bm=kw["bm"], bk=kw["bk"], bn=kw["bn"],
                                grid_order=kw["grid_order"], interpret=True))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["mn", "nm"])
def test_plain_version_matches_pallas_kernel_by_dtype(dtype, order):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((72, 40), dtype=np.float32)
    b = rng.standard_normal((40, 48), dtype=np.float32)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    out = matmul_plain(ta, tb, bm=32, bk=16, bn=32, grid_order=order)
    ref = jax_matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype), bm=32, bk=16,
                     bn=32, grid_order=order, interpret=True)
    assert str(out.dtype) == f"torch.{dtype}"
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_torch_backend_measures_on_cpu_when_asked():
    be = make_backend("torch", device="cpu", repeats=2)
    nest = TL.LoopNest(TL.matmul_benchmark(32, 32, 32))
    g = be.evaluate(nest)
    assert g > 0 and be.measurement_for(nest).repeats >= 2
    assert be.peak() > 0
    assert be.stats()["compile"]["compile_misses"] == 1


def test_card_executor_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError):
        TorchBackend()
    with pytest.raises(RuntimeError):
        make_backend("auto")


def test_pool_measurement_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        TorchBackend(device="cpu", measure="pool")


def test_env_rewards_match_on_the_analytical_backend():
    rb = RL.matmul_benchmark(128, 64, 96)
    tb = TL.matmul_benchmark(128, 64, 96)
    r_env = RE.LoopTuneEnv([rb], "tpu")
    t_env = TE.LoopTuneEnv([tb], "tpu")
    np.testing.assert_array_equal(t_env.reset(0), r_env.reset(0))
    rng = np.random.default_rng(3)
    for _ in range(12):
        a = int(rng.integers(t_env.n_actions))
        np.testing.assert_array_equal(t_env.action_mask(), r_env.action_mask())
        t_obs, t_r, t_done, t_info = t_env.step(a)
        r_obs, r_r, r_done, r_info = r_env.step(a)
        np.testing.assert_array_equal(t_obs, r_obs)
        assert (t_r, t_done, t_info["gflops"]) == (r_r, r_done, r_info["gflops"])


def _route_spy(monkeypatch):
    """Record the operand dtypes each launch of the matmul route sees."""
    import importlib

    mm = importlib.import_module("repro_torch.kernels.matmul")
    real, seen = mm.matmul, []

    def spy(a, b, **kw):
        seen.append((a.dtype, b.dtype))
        return real(a, b, **kw)

    monkeypatch.setattr(mm, "matmul", spy)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rewards_launch_the_route_at_the_record_dtype(monkeypatch, dtype):
    """A "bfloat16" record's rewards hand bf16 operands to the matmul route
    (the seeded f32 inputs rounded once), the default f32 ones."""
    from repro_torch.core import LoopTuner

    seen = _route_spy(monkeypatch)
    tuner = LoopTuner(backend=TorchBackend(device="cpu", kernel="on", repeats=1))
    entry = tuner.tune(TL.matmul_benchmark(32, 48, 40), dtype=dtype, max_evals=4,
                       budget_s=600.0)
    assert entry["gflops"] > 0 and tuner.registry.get("mm", (32, 48, 40), dtype)
    want = getattr(torch, dtype)
    assert seen and all(d == (want, want) for d in seen)
    c = TL.matmul_benchmark(32, 48, 40)
    a, b = tuner.backend._inputs(dataclasses.replace(c, dtype=dtype))
    ref = TCB.make_inputs(c, 0)
    np.testing.assert_array_equal(a.float().numpy(),
                                  torch.from_numpy(ref["A"]).to(want).float().numpy())


def test_f32_and_bf16_tunes_share_no_cached_evaluation():
    """One tuner, one contraction, tuned as an f32 then a bf16 record: the
    shared evaluation cache, the operand cache and the lowered-function
    cache key on the dtype, so the bf16 tune measures every schedule
    itself."""
    from repro_torch.core import LoopTuner

    be = TorchBackend(device="cpu", kernel="on", repeats=1)
    tuner = LoopTuner(backend=be)
    bench = TL.matmul_benchmark(32, 48, 40)
    tuner.tune(bench, max_evals=5, budget_s=600.0)
    f32_keys = {k for k, _ in tuner.cache.entries()}
    misses, compiles = tuner.cache.misses, be.compiles
    tuner.tune(bench, dtype="bfloat16", max_evals=5, budget_s=600.0)
    bf16_keys = {k for k, _ in tuner.cache.entries()} - f32_keys
    assert f32_keys and bf16_keys
    assert all(k[0] == "mm_32_48_40" for k in f32_keys)
    assert all(k[0] == "mm_32_48_40:bfloat16" for k in bf16_keys)
    # the base schedule of both tunes has the same loop body, measured twice
    assert {k[1:] for k in f32_keys} & {k[1:] for k in bf16_keys}
    assert tuner.cache.misses - misses == len(bf16_keys)
    assert be.compiles - compiles == len(bf16_keys)
    assert set(be._inputs_cache._data) == {("mm_32_48_40", "float32"),
                                           ("mm_32_48_40", "bfloat16")}
