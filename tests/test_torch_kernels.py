"""The port's kernel layer on the CPU: the tiled matmul's plain version over
a shape/block/order sweep with tails, against the Pallas kernel in
interpret mode (f32 and bf16 operands), its launch plan (route, and the
tensor-core and SIMT tiles, in pure Python), ``_parse_matmul_spec`` and
``tuned_einsum``'s counters against the JAX package's, and the kernel
build's library path (its hash of the headers a source includes).  The
kernels themselves are held against their plain versions in
``test_torch_cuda.py``."""
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
from repro_torch.kernels.matmul import launch_plan, matmul, matmul_plain
from test_torch_matmul_persistent import committed_schedules

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


@pytest.mark.parametrize("in_dt,out_dt", [("float32", None), ("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("m,k,n,blk,order", SWEEP[::5])
def test_plain_tiled_matmul_matches_pallas_interpret(m, k, n, blk, order, in_dt, out_dt):
    """bf16 operands (the tensor-core route's) too: both accumulate the exact
    products in f32 (2e-5); a bf16 output rounds once (1e-2, PERF.md §2)."""
    a, b = _operands(m, k, n, seed=3)
    bm, bk, bn = blk
    ta, tb = (torch.from_numpy(x).to(getattr(torch, in_dt)) for x in (a, b))
    out = matmul(ta, tb, bm=bm, bk=bk, bn=bn, grid_order=order,
                 out_dtype=getattr(torch, out_dt) if out_dt else None)  # CPU: the plain version
    ref = jax_matmul(jnp.asarray(a, in_dt), jnp.asarray(b, in_dt), bm=bm, bk=bk, bn=bn,
                     grid_order=order, interpret=True,
                     out_dtype=jnp.dtype(out_dt) if out_dt else None)
    assert str(out.dtype) == f"torch.{out_dt or in_dt}" and ref.dtype == jnp.dtype(out_dt or in_dt)
    tol = 1e-2 if (out_dt or in_dt) == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mkn,dtype,route", [
    ((1024, 2048, 2048), torch.float32, "simt"),     # every f32 launch: TF32 misses 1e-5
    ((1024, 2048, 2048), torch.bfloat16, "wgmma"),
    ((4, 2048, 2048), torch.bfloat16, "wgmma"),      # M < 64: decode too
    ((1, 8, 8), torch.bfloat16, "wgmma"),
    ((33, 36, 96), torch.bfloat16, "simt"),          # K off a multiple of 8
    ((33, 200, 98), torch.bfloat16, "simt"),         # N off a multiple of 8
    ((1, 1, 1), torch.bfloat16, "simt"),
])
def test_launch_plan_route_rules(mkn, dtype, route):
    for blk in [(1, 2048, 1), (128, 128, 128), (256, 512, 256)]:
        for order in ("mn", "nm"):
            assert launch_plan(*mkn, *blk, order, dtype=dtype)["route"] == route


# the thin blocks an f32-timed search picked for musicgen-large and the
# default 128^3, at the model's shapes:
# (m, k, n), block -> kernel, tile, k chunks a stage, stages, tiles, CTAs
# (at 132 SMs, the count where no card is visible), k-split warpgroups
TILE_CASES = [
    ((1024, 2048, 2048), (1, 2048, 1), "persistent", (64, 64), 4, 3, 512, 132, 1),
    ((1024, 2048, 8192), (4, 2048, 1), "persistent", (64, 64), 4, 3, 2048, 132, 1),
    ((1024, 8192, 2048), (1, 8192, 1), "persistent", (64, 64), 4, 3, 512, 132, 1),
    ((1024, 2048, 2048), (128, 128, 128), "persistent", (128, 128), 2, 3, 128, 128, 1),
    ((1024, 8192, 2048), (128, 64, 256), "persistent", (128, 256), 1, 4, 64, 64, 1),
    ((1024, 2048, 8192), (65, 65, 65), "persistent", (128, 128), 2, 3, 512, 132, 1),
    ((4, 2048, 2048), (1, 2048, 1), "split_k", (64, 64), 2, 7, 32, 32, 2),  # decode: K split in two
    ((4, 8192, 2048), (128, 128, 128), "split_k", (64, 128), 2, 4, 16, 16, 2),
    ((4, 2048, 8192), (4, 64, 256), "split_k", (64, 256), 1, 5, 32, 32, 1),
    ((200, 1000, 200), (64, 1000, 1000), "persistent", (64, 256), 1, 5, 4, 4, 1),  # clamped
    ((33, 8, 72), (128, 128, 128), "split_k", (64, 128), 2, 3, 1, 1, 2),  # one chunk, zero filled
]


@pytest.mark.parametrize("mkn,blk,design,tile,kc,stages,tiles,ctas,ks", TILE_CASES)
def test_launch_plan_maps_blocks_onto_warpgroup_tiles(mkn, blk, design, tile, kc, stages,
                                                      tiles, ctas, ks):
    plan = launch_plan(*mkn, *blk, dtype=torch.bfloat16)
    assert plan == {"route": "wgmma", "design": design, "tile": tile, "k_chunks": kc,
                    "stages": stages, "tiles": tiles, "ctas": ctas, "k_split": ks}
    # the ring fits in the 227 KB a block may use, with the alignment slack
    # (and the persistent kernel's two mbarriers a stage)
    assert 1024 + stages * kc * (tile[0] + tile[1]) * 128 + 16 * stages <= 232448
    # the grid order changes no tile
    assert launch_plan(*mkn, *blk, "nm", dtype=torch.bfloat16) == plan


# the committed schedules (M = 8,192) -> tile, stages: one k chunk a stage
# and as many stages as fit; every one on the persistent kernel
COMMITTED_PLANS = [((64, 128), 9)] * 4 + [((64, 64), 14), ((64, 128), 9), ((64, 256), 5)]


@pytest.mark.parametrize("i", range(len(COMMITTED_PLANS)))
def test_committed_schedules_take_the_persistent_kernel(i):
    """Each committed prefill schedule keeps its tile (the block-to-tile map
    is the split-K era's) and runs the persistent kernel, its grid one CTA
    an SM, every SM with several tiles."""
    (m, k, n), (bm, bk, bn), order = committed_schedules()[i]
    tile, stages = COMMITTED_PLANS[i]
    plan = launch_plan(m, k, n, bm, bk, bn, order, dtype=torch.bfloat16)
    tiles = -(-m // tile[0]) * -(-n // tile[1])
    assert plan == {"route": "wgmma", "design": "persistent", "tile": tile, "k_chunks": 1,
                    "stages": stages, "tiles": tiles, "ctas": 132, "k_split": 1}
    assert tiles > 132 * 10


@pytest.mark.parametrize("m,design", [(1, "split_k"), (64, "split_k"), (65, "persistent"),
                                      (8192, "persistent")])
def test_launch_plan_picks_the_tensor_core_kernel_by_m_alone(m, design, monkeypatch):
    """M alone picks the kernel: the block, the grid order and the B layout
    do not; the persistent grid is min(tiles, SMs), the split-K one a CTA a
    tile; the SIMT route has no kernel field."""
    import importlib

    MM = importlib.import_module("repro_torch.kernels.matmul")
    monkeypatch.setattr(MM, "sm_count", lambda: 17)  # a card of 17 SMs
    assert MM.tc_design(m) == design
    for blk in [(1, 1, 1), (64, 64, 64), (128, 512, 256)]:
        for order in ("mn", "nm"):
            plan = launch_plan(m, 1024, 2048, *blk, order, dtype=torch.bfloat16)
            assert plan["design"] == design
            assert plan["ctas"] == (min(plan["tiles"], 17) if design == "persistent"
                                    else plan["tiles"])
    assert "design" not in launch_plan(m, 1024, 2048, dtype=torch.float32)


@pytest.mark.parametrize("mkn,blk,tiles,ctas", [
    ((65, 64, 64), (128, 64, 64), 1, 1),       # one tile, one CTA
    ((192, 64, 64), (64, 64, 64), 3, 3),       # a CTA a tile
    ((64 * 133, 64, 64), (64, 64, 64), 133, 132),  # CTA 0 takes two
    ((8192, 64, 8192), (64, 64, 128), 8192, 132),
])
def test_persistent_grid_is_one_cta_an_sm_at_most(mkn, blk, tiles, ctas):
    plan = launch_plan(*mkn, *blk, dtype=torch.bfloat16)
    assert (plan["tiles"], plan["ctas"]) == (tiles, ctas)


# the SIMT route (every f32 launch, bf16 off a multiple of 8): (m, k, n),
# dtype, block -> tile, k values a ring stage, stages, CTAs, k-split groups
SIMT_CASES = [
    # musicgen-large's six contractions at the thin blocks an f32 search
    # picks and at 128^3: a thin block no longer gives thin CTAs
    ((1024, 2048, 2048), torch.float32, (1, 2048, 1), (64, 64), 64, 2, 512, 1),
    ((1024, 2048, 8192), torch.float32, (4, 2048, 1), (64, 64), 64, 2, 2048, 1),
    ((1024, 8192, 2048), torch.float32, (1, 8192, 1), (64, 64), 64, 2, 512, 1),
    ((1024, 2048, 2048), torch.float32, (128, 128, 128), (128, 128), 64, 3, 128, 1),
    ((1024, 2048, 8192), torch.float32, (128, 128, 128), (128, 128), 64, 3, 512, 1),
    ((1024, 8192, 2048), torch.float32, (128, 16, 100), (128, 128), 16, 4, 128, 1),
    ((1024, 2048, 8192), torch.float32, (65, 8, 64), (128, 64), 8, 4, 1024, 1),
    # decode (M <= 16): one m tile, K split over 1024 / tn thread groups, the
    # n tile no wider than leaves 128 CTAs to stream B
    ((4, 2048, 2048), torch.float32, (1, 2048, 1), (4, 16), 256, 4, 128, 64),
    ((4, 8192, 2048), torch.float32, (4, 2048, 1), (4, 16), 256, 4, 128, 64),
    ((4, 2048, 8192), torch.float32, (1, 2048, 1), (4, 16), 256, 4, 512, 64),
    ((4, 2048, 2048), torch.float32, (128, 128, 128), (4, 16), 256, 4, 128, 64),
    ((4, 2048, 8192), torch.float32, (128, 128, 128), (4, 64), 64, 4, 128, 16),
    ((4, 8192, 32768), torch.float32, (4, 16, 256), (4, 128), 32, 4, 256, 8),
    ((16, 8192, 8192), torch.float32, (16, 64, 32), (16, 32), 128, 4, 256, 32),
    ((9, 100, 33), torch.float32, (4, 8, 8), (16, 16), 256, 3, 3, 64),
    # ragged M, K and N; blocks clamped to the shape
    ((33, 200, 96), torch.float32, (32, 32, 32), (64, 64), 32, 4, 2, 1),
    ((200, 1000, 200), torch.float32, (200, 1000, 200), (128, 128), 64, 3, 4, 1),
    ((130, 70, 33), torch.float32, (4, 1, 64), (64, 64), 8, 4, 3, 1),
    # f32 with K off a multiple of 4 (4-byte copies)
    ((33, 37, 96), torch.float32, (64, 64, 64), (64, 64), 64, 2, 2, 1),
    # bf16 off a multiple of 8 (loads through registers)
    ((33, 36, 96), torch.bfloat16, (128, 128, 128), (64, 128), 64, 4, 1, 1),
    ((200, 200, 98), torch.bfloat16, (128, 128, 128), (128, 128), 64, 3, 2, 1),
    ((1, 1, 1), torch.bfloat16, (1, 1, 1), (4, 16), 256, 4, 1, 64),
]


@pytest.mark.parametrize("mkn,dtype,blk,tile,kd,stages,ctas,ks", SIMT_CASES)
def test_launch_plan_keeps_the_simt_plan(mkn, dtype, blk, tile, kd, stages, ctas, ks):
    """The SIMT route maps the block onto a CTA tile from a small family
    (m 64/128, n 64/128, a stage k depth of 8-64), or, at M <= 16, onto the
    decode plan; the ring fits in the 227 KB a block may use (a 64 x 64
    tile's in a third of it, three CTAs an SM; the decode plan's in half of
    it, two CTAs an SM); the route rules are unchanged; neither the grid
    order nor the B layout changes the plan."""
    from repro_torch.kernels.matmul import SIMT_DECODE_SMEM, SMEM, route_for, simt_stage_bytes

    plan = launch_plan(*mkn, *blk, dtype=dtype)
    assert plan == {"route": "simt", "tile": tile, "k_depth": kd, "stages": stages,
                    "ctas": ctas, "k_split": ks}
    assert plan["route"] == route_for(mkn[1], mkn[2], dtype)
    assert launch_plan(*mkn, *blk, "nm", dtype=dtype) == plan
    budget = (SIMT_DECODE_SMEM if ks > 1 else
              SMEM // 3 - 1024 if tile == (64, 64) else SMEM)
    ring = stages * simt_stage_bytes(*tile, kd)
    assert 2 <= stages and ring <= budget <= SMEM
    if ks > 1:  # the partial tiles, summed in the ring's place
        assert ks * tile[1] == 1024 and kd == 4 * ks and 4 * ks * tile[0] * tile[1] <= ring


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


def test_lib_path_hashes_the_headers_a_source_includes(tmp_path):
    """An edited header a source includes (``#include "..."``, followed
    through headers) changes the library path, so no stale library loads;
    a mutant copy elsewhere finds its headers in ``csrc/``."""
    from repro_torch.kernels import _build

    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// v1\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\nint f() { return 0; }\n')
    assert _build._headers(src) == [tmp_path / "outer.cuh", tmp_path / "inner.cuh"]
    first = _build._lib_path(src)
    assert first == _build._lib_path(src) and first.parent == _build.BUILD_DIR
    (tmp_path / "inner.cuh").write_text("// v2\n")
    second = _build._lib_path(src)
    assert second != first and second.name.startswith("libk-")
    # the flash kernel's source includes csrc/hopper.cuh; a copy of it in
    # another directory resolves the header in csrc/ and hashes alike
    flash = _build.CSRC / "flash_attention.cu"
    assert _build._headers(flash) == [_build.CSRC / "hopper.cuh"]
    copy = tmp_path / "flash_attention.cu"
    copy.write_bytes(flash.read_bytes())
    assert _build._lib_path(copy) == _build._lib_path(flash)
    (tmp_path / "bad.cu").write_text('#include "missing.cuh"\n')
    with pytest.raises(FileNotFoundError, match="missing.cuh"):
        _build._lib_path(tmp_path / "bad.cu")
