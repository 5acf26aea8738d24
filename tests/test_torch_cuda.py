"""The port's CUDA kernels against their plain versions, on the card.

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
