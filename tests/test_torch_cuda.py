"""The port's CUDA kernels against their plain versions, and model steps, on
the card.

These tests import no JAX, so they run on a host with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere they skip (the kernels have no CPU mode).
"""
import pytest
import torch

from repro_torch.kernels.matmul import matmul, matmul_plain
from repro_torch.kernels.ref import matmul_ref


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["mn", "nm"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_the_card(order, trans_b, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    for (m, k, n) in [(1, 1, 1), (33, 200, 96), (4, 8192, 256), (200, 64, 1024)]:
        for blk in [(4, 64, 64), (32, 32, 32), (96, 64, 96), (64, 8192, 256)]:
            a = torch.randn(m, k, generator=g, device="cuda").to(dt)
            b = torch.randn(*((n, k) if trans_b else (k, n)), generator=g,
                            device="cuda").to(dt)
            kw = dict(bm=blk[0], bk=blk[1], bn=blk[2], grid_order=order,
                      trans_b=trans_b)
            before = matmul.launches
            out = matmul(a, b, **kw)
            torch.cuda.synchronize()
            assert matmul.launches == before + 1
            ref = matmul_plain(a, b, **kw).float()
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            assert err <= (1e-5 if dtype == "float32" else 1e-2)
            ref32 = matmul_ref(a, b.t() if trans_b else b, out_dtype=torch.float32)
            assert torch.allclose(out.float(), ref32, rtol=2e-2, atol=2e-2)


# the tensor-core route: ragged M (1, 4, 33, 200), K and N multiples of 8
# but not of 64, and blocks that reach every (m tile, n tile) pair and 1-4
# k chunks a stage
TC_SHAPES = [(1, 64, 64), (4, 200, 1000), (33, 1000, 200), (200, 8, 72), (130, 520, 264),
             (4, 2048, 128)]
TC_BLOCKS = [(4, 64, 64), (64, 128, 100), (64, 512, 256), (96, 128, 128), (128, 200, 64),
             (128, 256, 256)]
#: f32 out at these K (<= 2048): products of bf16 values are exact in f32 and
#: only the order of summation differs; the route reads <= 4e-6 here (its own
#: limit, 3e-5, is for K = 8192, where the tensor cores' truncating
#: accumulation reaches ~1.2e-5: PERF.md §2)
TC_F32_OUT_LIMIT = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_tensor_core_route_matches_plain_version_on_the_card(trans_b, out_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.matmul import kernel_plan, launch_plan

    odt = getattr(torch, out_dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    for (m, k, n) in TC_SHAPES:
        for order, (bm, bk, bn) in zip(("mn", "nm") * 3, TC_BLOCKS):
            a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
            b = torch.randn(*((n, k) if trans_b else (k, n)), generator=g,
                            device="cuda").bfloat16()
            kw = dict(bm=bm, bk=bk, bn=bn, grid_order=order, out_dtype=odt,
                      trans_b=trans_b)
            plan = launch_plan(m, k, n, bm, bk, bn, order, dtype=torch.bfloat16)
            assert plan["route"] == "wgmma"
            assert plan == kernel_plan(m, k, n, bm, bk, bn, order, dtype=torch.bfloat16)
            before = dict(matmul.route_launches)
            out = matmul(a, b, **kw)
            torch.cuda.synchronize()
            assert matmul.route_launches == {**before, "wgmma": before["wgmma"] + 1}
            ref = matmul_plain(a, b, **kw).float()
            assert out.dtype == odt and out.shape == (m, n)
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            assert err <= (TC_F32_OUT_LIMIT if out_dtype == "float32" else 1e-2), \
                ((m, k, n), (bm, bk, bn), plan, err)


@pytest.mark.cuda
def test_routes_and_plans_on_the_card():
    """f32, and bf16 with K or N off a multiple of 8, stay on the SIMT
    route; the kernel's own plan equals launch_plan on both routes; an
    unaligned bf16 operand raises and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.matmul import kernel_plan, launch_plan

    for (m, k, n), dt, route in [((33, 200, 96), torch.float32, "simt"),
                                 ((33, 36, 96), torch.bfloat16, "simt"),
                                 ((33, 200, 98), torch.bfloat16, "simt"),
                                 ((33, 200, 96), torch.bfloat16, "wgmma")]:
        for blk in [(1, 2048, 1), (4, 64, 64), (128, 128, 128), (256, 512, 256)]:
            plan = launch_plan(m, k, n, *blk, dtype=dt)
            assert plan["route"] == route
            assert plan == kernel_plan(m, k, n, *blk, dtype=dt)
        a = torch.randn(m, k, device="cuda").to(dt)
        b = torch.randn(k, n, device="cuda").to(dt)
        before = dict(matmul.route_launches)
        matmul(a, b)
        torch.cuda.synchronize()
        assert matmul.route_launches == {**before, route: before[route] + 1}
    a = torch.randn(4 * 200 + 1, device="cuda").bfloat16()[1:].view(4, 200)
    before = matmul.launches
    with pytest.raises(ValueError, match="16-byte"):
        matmul(a, torch.randn(200, 96, device="cuda").bfloat16())
    assert matmul.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
def test_simt_route_at_the_model_shapes_on_the_card(trans_b):
    """musicgen-large's six f32 contractions on the SIMT route, at the thin
    blocks an f32 search picks, at 128^3 and at a decode block: against the
    plain version at 1e-5, the kernel's own plan equal to launch_plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.matmul import kernel_plan, launch_plan

    g = torch.Generator(device="cuda").manual_seed(2)
    for (m, k, n) in [(4, 2048, 2048), (4, 2048, 8192), (4, 8192, 2048), (1024, 2048, 2048),
                      (1024, 2048, 8192), (1024, 8192, 2048)]:
        a = torch.randn(m, k, generator=g, device="cuda")
        b = torch.randn(*((n, k) if trans_b else (k, n)), generator=g, device="cuda")
        for blk in [(1, 2048, 1), (4, 64, 64), (128, 128, 128)]:
            plan = launch_plan(m, k, n, *blk)
            assert plan["route"] == "simt" and plan == kernel_plan(m, k, n, *blk)
            kw = dict(bm=blk[0], bk=blk[1], bn=blk[2], trans_b=trans_b)
            before = dict(matmul.route_launches)
            out = matmul(a, b, **kw)
            torch.cuda.synchronize()
            assert matmul.route_launches == {**before, "simt": before["simt"] + 1}
            ref = matmul_plain(a, b, **kw)
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            assert err <= 1e-5, ((m, k, n), blk, plan, err)


@pytest.mark.cuda
def test_card_executor_rewards_launch_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import numpy as np

    from repro_torch.core import (LoopNest, TorchBackend, execute_reference,
                                  make_inputs, matmul_benchmark)

    be = TorchBackend()
    nest = LoopNest(matmul_benchmark(96, 200, 160))
    nest.split(0, 32)
    before = matmul.launches
    out = be.execute(nest)
    ref = execute_reference(nest.contraction, make_inputs(nest.contraction, 0))
    assert np.abs(out - ref).max() / np.abs(ref).max() <= 1e-5
    assert be.evaluate(nest) > 0
    assert matmul.launches >= before + 3  # execute, warm-up, timed repeats


@pytest.mark.cuda
def test_tuned_einsum_routes_to_the_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.core import LoopTuner, matmul_benchmark
    from repro_torch.kernels import ops

    tuner = LoopTuner(backend="torch")
    tuner.tune(matmul_benchmark(8, 256, 128), max_evals=8)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 4, 256, generator=g, device="cuda")
    w = torch.randn(256, 128, generator=g, device="cuda")
    ops.reset_serving_stats()
    before = matmul.launches
    with ops.serving(tuner.registry):
        y = ops.tuned_einsum("bsk,kn->bsn", x, w)
        yt = ops.tuned_einsum("bsd,vd->bsv", x, w.t().contiguous())
    torch.cuda.synchronize()
    assert ops.serving_stats()["routed"] == 2 and matmul.launches == before + 2
    ref = matmul_ref(x.reshape(8, 256), w)
    for out in (y, yt):
        err = (out.reshape(8, 128) - ref).abs().max() / ref.abs().max()
        assert err.item() <= 1e-5


# (B, S, T, H, HKV, D, causal, window, softcap, bq, bk, q_view); q_view: q is
# a strided view into a fused (B, S, 3, H, D) buffer, as a fused projection
# would pass it
FLASH_CASES = [
    (2, 37, 37, 4, 4, 16, True, None, None, 128, 128, False),
    (1, 45, 20, 2, 1, 32, True, None, None, 128, 128, False),
    (2, 20, 45, 2, 2, 8, False, None, None, 16, 16, False),
    (1, 48, 48, 4, 2, 16, True, 8, None, 128, 128, False),
    (1, 48, 48, 4, 2, 16, True, 16, 50.0, 32, 48, False),
    (1, 40, 24, 2, 2, 16, True, 8, None, 128, 16, False),   # rows with no visible key
    (2, 130, 130, 4, 4, 64, True, None, None, 128, 128, False),
    (1, 70, 70, 2, 2, 64, False, None, 20.0, 8, 64, False),
    (2, 70, 70, 8, 2, 128, True, None, None, 128, 128, False),  # jamba's D and GQA group
] + [  # the tensor-core route's (bf16 at D = 64, 128): ragged S != T, GQA 4, 5, 8,
    # a window with blind rows, softcaps, every kv tile (bk 16, 32, 48 -> 64,
    # 128 -> 128 at D = 128) and q tile (bq <= 64, > 64), a strided q view
    (b, s, t, h, hkv, d, causal, window, softcap, bq, bk, q_view)
    for d in (64, 128)
    for (b, s, t, h, hkv, causal, window, softcap, bq, bk, q_view) in (
        (1, 70, 150, 8, 2, False, None, None, 64, 64, False),
        (1, 150, 70, 8, 2, True, None, None, 128, 32, False),
        (1, 120, 90, 4, 1, True, 24, None, 128, 16, False),   # rows 113-119 see no key
        (2, 130, 130, 4, 2, True, None, 30.0, 64, 128, False),
        (2, 96, 96, 8, 2, True, None, None, 100, 48, False),
        (2, 77, 77, 8, 2, True, None, None, 128, 128, True),
        (1, 150, 150, 10, 2, True, None, 50.0, 128, 64, False),  # llama4-scout's group
        (2, 90, 130, 16, 2, False, None, None, 64, 128, False))]  # command-r's group


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_plain,
                                                     kernel_plan, launch_plan)

    dt = getattr(torch, dtype)
    tol = 3e-5 if dtype == "float32" else 3e-2
    g = torch.Generator(device="cuda").manual_seed(0)
    for (b, s, t, h, hkv, d, causal, window, softcap, bq, bk, q_view) in FLASH_CASES:
        if q_view:
            q = torch.randn(b, s, 3, h, d, generator=g, device="cuda").to(dt)[:, :, 0]
        else:
            q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
        k = torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt)
        kw = dict(causal=causal, window=window, softcap=softcap, bq=bq, bk=bk)
        plan = launch_plan(s, t, bq, bk, d=d, dtype=dt)
        assert plan == kernel_plan(s, t, bq, bk, d=d, dtype=dt)  # the kernel's own plan
        tensor_core = dtype == "bfloat16" and d in (64, 128)
        assert plan["route"] == ("wgmma" if tensor_core else "simt")
        before = flash_attention.launches
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref = flash_attention_plain(q, k, v, **kw)
        assert out.dtype == dt and out.shape == ref.shape
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_two_layer_model_step_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("musicgen-large").smoke(), n_layers=2)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = copy.deepcopy(params).to("cuda")
    g = torch.Generator().manual_seed(1)
    embeds = torch.randn(2, 12, cfg.d_model, generator=g)
    step = torch.randn(2, 1, cfg.d_model, generator=g)
    prefill, decode = S.make_prefill_step(cfg, 24), S.make_decode_step(cfg)

    want, caches, n = prefill(params, {"embeds": embeds})
    _, want_step, _ = decode(params, {"embeds": step}, caches, n)
    before = flash_attention.launches
    got, caches, n = prefill(on_card, {"embeds": embeds.cuda()})
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    _, got_step, _ = decode(on_card, {"embeds": step.cuda()}, caches, n)
    for g_, w_ in ((got, want), (got_step, want_step)):
        assert torch.isfinite(g_).all()
        err = (g_.cpu() - w_).abs().max() / w_.abs().max()
        assert err.item() <= 1e-4


# (B, S, H, N, chunk)
RWKV_CASES = [(1, 1, 1, 4, 4), (2, 37, 1, 8, 16), (1, 70, 3, 16, 64), (2, 200, 2, 64, 128),
              (2, 300, 2, 64, 64), (1, 45, 2, 32, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv_scan_kernel_matches_plain_version_on_the_card(dtype, with_s0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.rwkv6_scan import (launch_plan, rwkv6_chunk_scan,
                                                rwkv6_chunk_scan_plain_heads)

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    for (b, s, h, n, chunk) in RWKV_CASES:
        r, k, v = ((0.5 * torch.randn(b, s, h, n, generator=g, device="cuda")).to(dt)
                   for _ in range(3))
        logw = -torch.exp(torch.randn(b, s, h, n, generator=g, device="cuda") - 2.0)
        u = 0.3 * torch.randn(h, n, generator=g, device="cuda")
        s0 = (0.1 * torch.randn(b, h, n, n, generator=g, device="cuda")
              if with_s0 else None)
        before = rwkv6_chunk_scan.launches
        y, st = rwkv6_chunk_scan(r, k, v, logw, u, chunk=chunk, s0=s0)
        torch.cuda.synchronize()
        assert rwkv6_chunk_scan.launches == before + 1
        want_y, want_s = rwkv6_chunk_scan_plain_heads(
            r, k, v, logw, u, chunk=launch_plan(s, chunk)["chunk"], s0=s0)
        # the JAX kernel test's tolerance; bf16 inputs are widened to f32 by both
        torch.testing.assert_close(y, want_y, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(st, want_s, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv_scan_kernel_at_the_model_shape_on_the_card(with_s0):
    """rwkv6-7b's prefill scan, (4, 1024, 64, 64) bf16 r/k/v at chunk 128,
    through strided views of one (B, S, 3D) projection as the model's
    heads are: both passes (2048 and 512 CTAs) against the plain version
    at 2e-4; one wrapper call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.rwkv6_scan import (launch_plan, rwkv6_chunk_scan,
                                                rwkv6_chunk_scan_plain_heads)

    b, s, h, n = 4, 1024, 64, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    proj = (0.5 * torch.randn(b, s, 3 * h * n, generator=g, device="cuda")).bfloat16()
    r, k, v = (proj[..., i * h * n:(i + 1) * h * n].view(b, s, h, n) for i in range(3))
    logw = -torch.exp(torch.randn(b, s, h, n, generator=g, device="cuda") - 2.0)
    u = 0.3 * torch.randn(h, n, generator=g, device="cuda")
    s0 = 0.1 * torch.randn(b, h, n, n, generator=g, device="cuda") if with_s0 else None
    assert launch_plan(s, 128, b=b, h=h, n=n)["pass1_ctas"] == 2048
    before = rwkv6_chunk_scan.launches
    y, st = rwkv6_chunk_scan(r, k, v, logw, u, chunk=128, s0=s0)
    torch.cuda.synchronize()
    assert rwkv6_chunk_scan.launches == before + 1
    want_y, want_s = rwkv6_chunk_scan_plain_heads(r, k, v, logw, u, chunk=128, s0=s0)
    torch.testing.assert_close(y, want_y, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st, want_s, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_scan_kernel_holds_at_trained_decay_speeds_on_the_card(dtype):
    """logw = -e^{2z}, z standard normal, so that 128-token chunks sum logw
    below -300 (trained decays pass -88 within a few dozen tokens): the
    kernel stays finite and equals the token-by-token recurrence at 2e-4,
    at chunks 128 and 64 and from a carried state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.ref import rwkv6_ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_chunk_scan, to_streams

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    b, s, h, n = 2, 300, 2, 64
    r, k, v = ((0.5 * torch.randn(b, s, h, n, generator=g, device="cuda")).to(dt)
               for _ in range(3))
    logw = -torch.exp(2.0 * torch.randn(b, s, h, n, generator=g, device="cuda"))
    u = 0.3 * torch.randn(h, n, generator=g, device="cuda")
    streams = [to_streams(t).float() for t in (r, k, v, logw)]
    assert streams[3][:, :256].reshape(b * h, 2, 128, n).sum(2).min() < -300
    want_y, want_s = rwkv6_ref(*streams, u.repeat(b, 1))
    for chunk in (128, 64):
        y, st = rwkv6_chunk_scan(r, k, v, logw, u, chunk=chunk)
        torch.cuda.synchronize()
        assert torch.isfinite(y).all() and torch.isfinite(st).all()
        torch.testing.assert_close(to_streams(y), want_y, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(st.reshape(b * h, n, n), want_s, rtol=2e-4, atol=2e-4)
    y1, s1 = rwkv6_chunk_scan(*(t[:, :100] for t in (r, k, v, logw)), u, chunk=128)
    y2, s2 = rwkv6_chunk_scan(*(t[:, 100:] for t in (r, k, v, logw)), u, chunk=128, s0=s1)
    torch.testing.assert_close(to_streams(torch.cat([y1, y2], 1)), want_y, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s2.reshape(b * h, n, n), want_s, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_two_layer_rwkv_model_step_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan import rwkv6_chunk_scan
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("rwkv6-7b").smoke(), n_layers=2, rwkv_head_dim=16)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = copy.deepcopy(params).to("cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 140), generator=torch.Generator().manual_seed(1))
    step = torch.randint(0, cfg.vocab, (2, 1), generator=torch.Generator().manual_seed(2))
    prefill, decode = S.make_prefill_step(cfg, 141), S.make_decode_step(cfg)

    want, caches, n = prefill(params, {"tokens": tokens})
    _, want_step, want_caches = decode(params, {"tokens": step}, caches, n)
    before = rwkv6_chunk_scan.launches
    got, caches, n = prefill(on_card, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    assert rwkv6_chunk_scan.launches == before + cfg.n_layers
    _, got_step, caches = decode(on_card, {"tokens": step.cuda()}, caches, n)
    for g_, w_ in ((got, want), (got_step, want_step), (caches[0]["s"], want_caches[0]["s"])):
        assert torch.isfinite(g_).all()
        err = (g_.cpu() - w_).abs().max() / w_.abs().max()
        assert err.item() <= 1e-4


# (B, S, C, N, chunk, bd)
MAMBA_CASES = [(1, 1, 8, 4, 4, 8), (2, 37, 20, 8, 8, 16), (2, 40, 32, 4, 32, 128),
               (1, 200, 300, 16, 64, 128), (2, 130, 520, 16, 32, 256), (3, 65, 100, 16, 16, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_kernel_matches_plain_version_on_the_card(dtype, with_h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.mamba_scan import launch_plan, mamba_scan, mamba_scan_plain_model

    dt_ = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    for (b, s, ch, n, chunk, bd) in MAMBA_CASES:
        def rand(*shape):
            return torch.randn(*shape, generator=g, device="cuda")

        x = rand(b, s, ch).to(dt_)
        dt = torch.exp(0.5 * rand(b, s, ch) - 3.5).to(dt_)
        a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda")[None].repeat(ch, 1)
        proj = (0.5 * rand(b, s, 4 + 2 * n)).to(dt_)  # b and c: strided views
        bm, cm = proj[..., 4:4 + n], proj[..., 4 + n:]
        h0 = 0.1 * rand(b, ch, n) if with_h0 else None
        before = mamba_scan.launches
        y, h = mamba_scan(x, dt, a, bm, cm, chunk=chunk, bd=bd, h0=h0)
        torch.cuda.synchronize()
        assert mamba_scan.launches == before + 1
        want_y, want_h = mamba_scan_plain_model(
            x, dt, a, bm, cm, chunk=launch_plan(s, ch, chunk, bd)["l"], h0=h0)
        # the JAX kernel test's tolerance; both widen to f32 at the load
        torch.testing.assert_close(y, want_y, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(h, want_h, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_jamba_smoke_model_step_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T

    cfg = get_config("jamba-v0.1-52b").smoke()  # one period: 7 Mamba layers, 1 attention
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = copy.deepcopy(params).to("cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 70), generator=torch.Generator().manual_seed(1))
    step = torch.randint(0, cfg.vocab, (2, 1), generator=torch.Generator().manual_seed(2))
    prefill, decode = S.make_prefill_step(cfg, 71), S.make_decode_step(cfg)

    want, caches, n = prefill(params, {"tokens": tokens})
    _, want_step, want_caches = decode(params, {"tokens": step}, caches, n)
    before = (mamba_scan.launches, flash_attention.launches)
    got, caches, n = prefill(on_card, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    assert (mamba_scan.launches, flash_attention.launches) == (before[0] + 7, before[1] + 1)
    _, got_step, caches = decode(on_card, {"tokens": step.cuda()}, caches, n)
    for g_, w_ in ((got, want), (got_step, want_step), (caches[0]["h"], want_caches[0]["h"])):
        assert torch.isfinite(g_).all()
        err = (g_.cpu() - w_).abs().max() / w_.abs().max()
        assert err.item() <= 1e-4


# (B, S, C, chunk, bd): S off the token tile and C off the CTA's channels,
# at every CTA width (bd 32, 64, 128 and 256, which clamps to 128)
MAMBA_RAGGED = [(2, 77, 100, 16, 64), (1, 130, 300, 64, 128), (3, 5, 33, 8, 32),
                (2, 200, 130, 64, 256)]


def _mamba_case(b, s, ch, n, dt_, g, *, offset=0, pad=0, rank=4, with_h0=False):
    """x, dt (B, S, C) as views ``offset`` elements into a buffer with rows
    of C + pad; a = -(1..N) e^{0.1 N(0, 1)}; b and c views of one (B, S,
    rank + 2N) projection; h0 0.1 N(0, 1) or None."""
    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    def view(t):
        flat = torch.zeros(offset + b * s * (ch + pad), device="cuda", dtype=dt_)
        out = flat[offset:].view(b, s, ch + pad)[..., :ch]
        out.copy_(t)
        return out

    x = view(rand(b, s, ch).to(dt_))
    dt = view(torch.exp(0.5 * rand(b, s, ch) - 3.5).to(dt_))
    a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda") * torch.exp(0.1 * rand(ch, n))
    proj = (0.5 * rand(b, s, rank + 2 * n)).to(dt_)
    h0 = 0.1 * rand(b, ch, n) if with_h0 else None
    return x, dt, a, proj[..., rank:rank + n], proj[..., rank + n:], h0


def _check_mamba_on_the_card(case_args, chunk, bd):
    from repro_torch.kernels.mamba_scan import (kernel_plan, launch_plan, mamba_scan,
                                                mamba_scan_plain_model)

    x, dt, a, bm, cm, h0 = case_args
    s, ch = x.shape[1], x.shape[2]
    plan = launch_plan(s, ch, chunk, bd)
    assert plan == kernel_plan(s, ch, chunk, bd)  # the kernel's own plan
    before = mamba_scan.launches
    y, h = mamba_scan(x, dt, a, bm, cm, chunk=chunk, bd=bd, h0=h0)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1
    want_y, want_h = mamba_scan_plain_model(x, dt, a, bm, cm, chunk=plan["l"], h0=h0)
    # the JAX kernel test's tolerance; both widen to f32 at the load
    torch.testing.assert_close(y, want_y, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, want_h, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_mamba_scan_kernel_over_ragged_shapes_and_state_dims_on_the_card(n, dtype, with_h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(n)
    for (b, s, ch, chunk, bd) in MAMBA_RAGGED:
        _check_mamba_on_the_card(
            _mamba_case(b, s, ch, n, getattr(torch, dtype), g, with_h0=with_h0), chunk, bd)


@pytest.mark.cuda
@pytest.mark.parametrize("offset,pad", [(1, 3), (2, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_reads_operands_off_16_bytes_on_the_card(dtype, offset, pad):
    """x and dt off a 16-byte boundary (bf16 at offset 1 off 4 bytes too: the
    kernel then stages them through registers; at offset 2 with even rows by
    4-byte copies), b and c at odd element offsets with odd row strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(offset)
    for (b, s, ch, chunk, bd) in MAMBA_RAGGED[:2]:
        args = _mamba_case(b, s, ch, 16, getattr(torch, dtype), g, offset=offset, pad=pad,
                           rank=3, with_h0=True)
        assert args[0].data_ptr() % 16 and args[3].data_ptr() % 16
        _check_mamba_on_the_card(args, chunk, bd)


# (B, S, T, H, HKV, causal, window, softcap, bq, bk, odd_kv): each SIMT tile
# (q 64/128 x kv 16/32/64), ragged S != T, GQA 4, a window whose rows
# 113-119 see no key, softcaps, and k, v views with rows of D + 1 (4-byte
# copies)
SIMT_CASES = [(2, 100, 100, 4, 4, True, None, None, 128, 128, False),
              (1, 70, 150, 8, 2, False, None, None, 64, 64, False),
              (1, 150, 70, 8, 2, True, None, None, 128, 32, False),
              (1, 120, 90, 4, 1, True, 24, None, 128, 16, False),
              (2, 130, 130, 4, 2, True, None, 30.0, 64, 128, False),
              (1, 200, 200, 4, 4, False, 40, 20.0, 16, 16, False),
              (1, 33, 20, 2, 1, True, None, None, 100, 48, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", d) for d in (8, 16, 32, 64, 128)] +
                         [("bfloat16", d) for d in (8, 16, 32)])
def test_flash_simt_route_on_the_card(dtype, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_plain,
                                                     kernel_plan, launch_plan)

    dt = getattr(torch, dtype)
    tol = 3e-5 if dtype == "float32" else 3e-2
    g = torch.Generator(device="cuda").manual_seed(d)
    for (b, s, t, h, hkv, causal, window, softcap, bq, bk, odd_kv) in SIMT_CASES:
        q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(b, t, hkv, d + odd_kv, generator=g, device="cuda").to(dt)[..., :d]
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap, bq=bq, bk=bk)
        plan = launch_plan(s, t, bq, bk, d=d, dtype=dt)
        assert plan["route"] == "simt" and plan == kernel_plan(s, t, bq, bk, d=d, dtype=dt)
        before = flash_attention.launches
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref = flash_attention_plain(q, k, v, **kw)
        assert out.dtype == dt and out.shape == ref.shape
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# (B, S, T, H, HKV, causal, window, softcap, bq, bk, q_view) at the zoo's head
# dims 96 (phi3-mini) and 256 (gemma3-12b): GQA groups 5 (llama4-scout) and 8
# (command-r), ragged S != T, a window whose rows 113-119 see no key, a
# softcap, every kv tile of both routes, a non-causal T off any tile (the
# cross-attention's form) and a strided q view
ZOO_FLASH_CASES = [(1, 100, 100, 5, 1, True, None, None, 128, 128, False),
                   (1, 70, 150, 8, 1, False, None, None, 64, 64, False),
                   (1, 150, 70, 10, 2, True, None, None, 128, 32, False),
                   (1, 120, 90, 4, 1, True, 24, None, 128, 16, False),
                   (2, 130, 130, 4, 2, True, None, 30.0, 64, 128, False),
                   (2, 64, 100, 5, 1, False, None, None, 128, 128, False),
                   (1, 77, 77, 8, 1, True, None, None, 128, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [96, 256])
def test_flash_kernel_at_the_zoo_head_dims_on_the_card(d, dtype):
    """bf16 on the tensor cores' warp-specialised kernel (flash_fwd_ws: TMA
    loads into an mbarrier ring, D = 96 at its own width), f32 on the SIMT
    route, each case with the kernel's own plan; the lse against the plain
    version's at 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_plain,
                                                     kernel_plan, launch_plan)

    dt = getattr(torch, dtype)
    tol = 3e-5 if dtype == "float32" else 3e-2
    g = torch.Generator(device="cuda").manual_seed(d)
    for (b, s, t, h, hkv, causal, window, softcap, bq, bk, q_view) in ZOO_FLASH_CASES:
        if q_view:
            q = torch.randn(b, s, 3, h, d, generator=g, device="cuda").to(dt)[:, :, 0]
        else:
            q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt) for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap, bq=bq, bk=bk)
        plan = launch_plan(s, t, bq, bk, d=d, dtype=dt)
        assert plan == kernel_plan(s, t, bq, bk, d=d, dtype=dt)
        assert plan["route"] == ("wgmma" if dtype == "bfloat16" else "simt")
        assert plan["kernel"] == ("flash_fwd_ws" if dtype == "bfloat16" else "flash_fwd_simt")
        before = flash_attention.launches
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref, ref_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
        assert out.dtype == dt and out.shape == ref.shape
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_launch_refuses_a_head_dim_without_an_instance_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.zeros(1, 4, 2, 12, device="cuda")
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head_dim 12"):
        flash_attention(q, q, q)
    assert flash_attention.launches == before


# ---------------------------------------------------------------------------
# the policy path on the card
# ---------------------------------------------------------------------------


def _queued_updates(n_updates: int, rows: int):
    """Queue ``n_updates`` APEX learner updates of ``rows`` transitions on
    the card, as a trainer leaves them, without reading anything back."""
    import numpy as np

    from repro_torch.core import EncoderConfig, build_network
    from repro_torch.core.dqn import batch_to_device, q_update
    from repro_torch.core.networks import make_adam

    net = build_network("dueling", EncoderConfig(), 10)
    online, target = net.init(0), net.init(1)
    opt = make_adam(online, 1e-3)
    rng = np.random.default_rng(0)
    batch = batch_to_device((rng.standard_normal((rows, 320)), rng.integers(0, 10, rows),
                             rng.standard_normal(rows), rng.standard_normal((rows, 320)),
                             np.zeros(rows), rng.random((rows, 10)) < 0.8,
                             np.full(rows, 0.97)), net.device)
    w = torch.ones(rows, device=net.device)
    torch.cuda.synchronize()
    for _ in range(n_updates):
        q_update(online, target, opt, batch, w)
    return net.device


@pytest.mark.cuda
def test_reward_after_learner_updates_times_an_idle_card():
    """A reward's clock is a host clock around a launch that synchronises
    only after it, so queued learner work would land in it: the trainers
    synchronise after each burst of updates (``rl_common.sync_device``),
    after which the stream is idle and a reward lies within the spread of
    the same reward timed on an idle card.  Unsynchronised, the first timed
    launch absorbs the queue."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import time

    from repro_torch.core import LoopNest, TorchBackend, matmul_benchmark
    from repro_torch.core.rl_common import sync_device

    be = TorchBackend()
    # large enough that the kernel, not the host's ~60 us of launch and
    # clock, sets the reward (at 256^3 the host's noise alone moved a
    # synchronised reward 35 % off the idle one)
    nest = LoopNest(matmul_benchmark(2048, 2048, 2048))
    be.measure(nest)  # lowered and warm
    idle = be.measure(nest)
    # batches far above a trainer's 64 rows, so that the card falls behind
    # the host and the updates stay queued when the loop returns
    sync_device(_queued_updates(20, 262144))
    assert torch.cuda.current_stream().query()
    after = be.measure(nest)
    slack = max(idle.spread, be.policy.spread_threshold)
    assert after.best_s <= idle.best_s * (1 + slack), (after, idle)
    _queued_updates(20, 262144)
    t0 = time.perf_counter()
    be.run_once(nest)
    leaked = time.perf_counter() - t0
    assert leaked > 10 * idle.times[-1], (leaked, idle)


@pytest.mark.cuda
def test_train_apex_rewards_launch_the_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import numpy as np

    from repro_torch.core import (CPU_SPLITS, ApexConfig, LoopTuneEnv, build_action_space,
                                  matmul_benchmark, train_apex)

    env = LoopTuneEnv([matmul_benchmark(*s) for s in ((64, 128, 96), (128, 64, 160))],
                      "torch", actions=build_action_space(CPU_SPLITS))
    before = matmul.launches
    res = train_apex(lambda i: env, 3, ApexConfig(hidden=(64, 64), n_actors=4,
                                                  warmup_steps=40))
    assert matmul.launches > before
    assert res.extra["updates"] > 0 and np.isfinite(res.rewards).all()
    assert res.meta["backend"] == "torch" and next(res.params.parameters()).is_cuda


@pytest.mark.cuda
def test_load_policy_on_the_card_acts_as_on_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import numpy as np

    from repro_torch.core import (ApexConfig, LoopTuneEnv, VecLoopTuneEnv, load_policy,
                                  matmul_benchmark, train_apex)

    benches = [matmul_benchmark(*s) for s in ((64, 128, 96), (128, 64, 160), (96, 96, 96))]
    res = train_apex(lambda i: LoopTuneEnv(benches, "tpu"), 4,
                     ApexConfig(hidden=(64, 64), n_actors=4, warmup_steps=40))
    path = str(tmp_path / "apex.pkl")
    res.save(path)
    venv = VecLoopTuneEnv(benches, "tpu", 8)
    rng = np.random.default_rng(0)
    obs, masks = [venv.reset()], [venv.action_mask()]
    for _ in range(9):
        o, _, _, _ = venv.step([int(rng.choice(np.flatnonzero(m))) for m in masks[-1]])
        obs.append(o)
        masks.append(venv.action_mask())
    obs, mask = np.concatenate(obs), np.concatenate(masks)
    on_card, _, _ = load_policy(path, device="cuda")
    on_cpu, _, _ = load_policy(path, device="cpu")
    with torch.no_grad():
        q = res.params(torch.as_tensor(obs, dtype=torch.float32, device="cuda")).cpu().numpy()
    top2 = np.sort(np.where(mask, q, -np.inf), axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-3 * np.abs(q).max(axis=1)
    assert clear.sum() >= len(obs) // 2
    np.testing.assert_array_equal(np.asarray(on_card(obs, mask))[clear],
                                  np.asarray(on_cpu(obs, mask))[clear])
    np.testing.assert_array_equal(np.asarray(on_card(obs, mask)), np.asarray(res.act(obs, mask)))


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["ppo", "a2c", "impala"])
def test_actor_critic_trainers_launch_the_kernel_on_the_card(algo):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import numpy as np

    from repro_torch import core as C

    train, cfg = {"ppo": (C.train_ppo, C.PPOConfig(hidden=(64, 64), n_envs=4, rollout_len=8)),
                  "a2c": (C.train_a2c, C.A2CConfig(hidden=(64, 64), n_envs=4)),
                  "impala": (C.train_impala, C.ImpalaConfig(hidden=(64, 64), n_envs=4,
                                                            rollout_len=8))}[algo]
    env = C.LoopTuneEnv([C.matmul_benchmark(*s) for s in ((64, 128, 96), (128, 64, 160))],
                        "torch", actions=C.build_action_space(C.CPU_SPLITS))
    before = matmul.launches
    res = train(lambda i: env, 3, cfg)
    assert matmul.launches > before
    assert res.extra["updates"] > 0 and np.isfinite(res.rewards).all()
    assert res.meta["backend"] == "torch" and next(res.params.parameters()).is_cuda


@pytest.mark.cuda
def test_tune_model_then_serve_from_its_file_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.core.registry import ScheduleRegistry, current_hardware
    from repro_torch.launch.serve import serve_once
    from repro_torch.launch.tune import tune_model

    cfg = get_config("musicgen-large").smoke()
    path = str(tmp_path / "reg.json")
    before = matmul.launches
    report = tune_model(cfg, registry_path=path, batch=2, prompt_len=8, max_len=16,
                        budget_s=2.0, eval_budget=64)
    assert report["n_tuned"] == report["n_harvested"] == 8 and matmul.launches > before
    reg = ScheduleRegistry(path)
    for c in report["contractions"]:
        entry = reg.get("mm", (c["m"], c["k"], c["n"]), c["dtype"],
                        hardware=current_hardware(), exact=True)
        assert entry and entry["backend"] == "torch"
    summary = serve_once(cfg, requests=2, batch=2, prompt_len=8, gen_len=2, max_len=16,
                         registry=reg)
    serving = summary["registry"]["serving"]
    assert serving["misses"] == 0 and serving["routed"] == serving["hits"] > 0


@pytest.mark.cuda
def test_pool_measures_in_a_spawned_worker_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.core import LoopNest, make_backend, matmul_benchmark
    from repro_torch.kernels.matmul import matmul as wrapper

    nest = LoopNest(matmul_benchmark(4, 2048, 2048))
    be = make_backend("torch", measure="pool")
    before = wrapper.launches
    try:
        m = be.measure(nest)
        pool = be.measure_stats()["pool"]
    finally:
        be.close()
    assert m.gflops > 0 and m.worker == 0 and not m.remeasured
    assert pool["start_method"] == "spawn" and pool["workers"] == torch.cuda.device_count()
    assert pool["worker_info"][0]["device"] == "cuda:0"
    assert wrapper.launches == before  # the parent launched nothing


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64, 96, 128, 256])
def test_flash_backward_kernel_matches_plain_version_on_the_card(d, dtype):
    """The backward kernel against ``flash_attention_bwd_plain`` on the same
    inputs (allclose: f32 5e-4, the JAX package's flash-gradient tolerance;
    bf16 3e-2, the forward's), causal with GQA 4 and ragged S != T, a window
    and softcap 50; one launch counted a call; bf16 at D >= 64 on the
    "wgmma" route, the rest on "simt", and the kernel's own plan equal to
    ``bwd_launch_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import (bwd_launch_plan, flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_plain, kernel_bwd_plan)

    dt = getattr(torch, dtype)
    lim = 5e-4 if dtype == "float32" else 3e-2
    g = torch.Generator(device="cuda").manual_seed(d)
    for (b, s, t, h, hkv, causal, window, softcap) in [(2, 100, 100, 8, 2, True, None, None),
                                                       (1, 70, 150, 4, 4, False, None, None),
                                                       (1, 130, 130, 4, 1, True, 40, 50.0)]:
        q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt) for _ in range(2))
        dout = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        plan = bwd_launch_plan(s, t, d=d, dtype=dt)
        assert plan["route"] == ("wgmma" if dtype == "bfloat16" and d >= 64 else "simt")
        assert kernel_bwd_plan(s, t, d=d, dtype=dt) == plan
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        before = flash_attention_bwd.launches
        got = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        torch.cuda.synchronize()
        assert flash_attention_bwd.launches == before + 1
        for a, w in zip(got, flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)):
            assert a.dtype == dt
            torch.testing.assert_close(a.float(), w.float(), rtol=lim, atol=lim)


@pytest.mark.cuda
def test_training_step_launches_both_flash_kernels_on_the_card():
    """Two train steps of musicgen-large's smoke config on the card: the
    loss is finite and falls on a repeated batch, each step launches flash
    forward twice a layer (forward and block recompute) and its backward
    once, every parameter gets a gradient through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.data import make_dataset
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.models import steps as S
    from repro_torch.optim.schedules import constant

    cfg = get_config("musicgen-large").smoke()
    params, opt = S.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_dataset(cfg, None, global_batch=2, seq_len=64).batch(0).items()}
    step = S.make_train_step(cfg, constant(1e-3))
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    losses = []
    for _ in range(3):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    assert flash_attention.launches - fwd == 3 * 2 * cfg.n_layers
    assert flash_attention_bwd.launches - bwd == 3 * cfg.n_layers
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]


@pytest.mark.cuda
def test_one_rank_nccl_train_step_under_a_mesh_on_the_card(tmp_path):
    """One nccl rank, a (1, 1) mesh: two train steps of musicgen-large's
    smoke config with DTensor parameters and AdamW state launch flash
    forward twice a layer and its backward once a step, and give the same
    losses as the steps without a mesh from the same seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import make_dataset
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import steps as S
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime import sharding as SH

    cfg = get_config("musicgen-large").smoke()
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_dataset(cfg, None, global_batch=2, seq_len=64).batch(0).items()}
    step = S.make_train_step(cfg, constant(1e-3))
    params, opt = S.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    want = [float(step(params, opt, batch)[2]["loss"]) for _ in range(2)]
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        params, opt = S.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                                         "cuda", mesh=mesh)
        fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
        with SH.use_mesh(mesh):
            got = [float(step(params, opt, S.distribute_batch(batch, mesh))[2]["loss"])
                   for _ in range(2)]
        torch.cuda.synchronize()
        assert flash_attention.launches - fwd == 2 * 2 * cfg.n_layers
        assert flash_attention_bwd.launches - bwd == 2 * cfg.n_layers
        assert all(SH.is_dtensor(p) for p in params.parameters())
    finally:
        dist.destroy_process_group()
    assert got == pytest.approx(want, rel=1e-6)
