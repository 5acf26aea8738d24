"""The tiled matmul's persistent tensor-core kernel (``tc_matmul_ws``, bf16
at M > 64) against its plain version, on the card.

These tests import no JAX, so they run on a host with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_matmul_persistent.py

Elsewhere they skip (the kernel has no CPU mode).  Every case holds the
kernel's own plan equal to ``launch_plan`` and counts one launch of its
design (``matmul.tc_design_launches``); the limits are the route's: 1e-5
relative with f32 out (K <= 3072 here), 1e-2 with bf16 out.
"""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.matmul import matmul, matmul_plain

F32_OUT_LIMIT, BF16_OUT_LIMIT = 1e-5, 1e-2
CONFIGS = Path(__file__).resolve().parents[1] / "portbench" / "configs"


def committed_schedules() -> list:
    """The prefill schedules the benchmark's configuration files commit:
    ((m, k, n), block, grid order) as ``tuned_einsum`` launches them."""
    from repro_torch.kernels.ops import _entry_schedule

    out = []
    for name in ("musicgen-large.json", "phi3-mini-3.8b.json"):
        for e in json.loads((CONFIGS / name).read_text())["schedules"]["entries"]:
            block, order = _entry_schedule(e)
            out.append(((e["m"], e["k"], e["n"]), (block["m"], block["k"], block["n"]), order))
    return out


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _check(mkn, blk, order, trans_b, out_dtype, g, design="persistent"):
    """One launch against the plain version (one f32 product over the whole
    of K: the same function, summed in another order)."""
    from repro_torch.kernels.matmul import kernel_plan, launch_plan

    m, k, n = mkn
    bm, bk, bn = blk
    a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
    b = torch.randn(*((n, k) if trans_b else (k, n)), generator=g, device="cuda").bfloat16()
    plan = launch_plan(m, k, n, bm, bk, bn, order, dtype=torch.bfloat16)
    assert plan["design"] == design, (mkn, blk, plan)
    assert plan == kernel_plan(m, k, n, bm, bk, bn, order, dtype=torch.bfloat16)
    before = dict(matmul.tc_design_launches)
    out = matmul(a, b, bm=bm, bk=bk, bn=bn, grid_order=order, out_dtype=out_dtype,
                 trans_b=trans_b)
    torch.cuda.synchronize()
    assert matmul.tc_design_launches == {**before, design: before[design] + 1}
    ref = matmul_plain(a, b, bk=k, out_dtype=torch.float32, trans_b=trans_b)
    assert out.dtype == out_dtype and out.shape == (m, n)
    err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
    limit = F32_OUT_LIMIT if out_dtype == torch.float32 else BF16_OUT_LIMIT
    assert err <= limit, (mkn, blk, order, trans_b, out_dtype, plan, err)


# the committed schedules with bf16 out in both B layouts, and with f32 out
# (the logits' form) where K <= 3072
COMMITTED = [(i, trans_b, out)
             for i, ((_, k, _), _, _) in enumerate(committed_schedules())
             for trans_b in (False, True)
             for out in ("bfloat16", "float32") if out == "bfloat16" or k <= 3072]


@pytest.mark.cuda
@pytest.mark.parametrize("i,trans_b,out_dtype", COMMITTED)
def test_committed_schedules_on_the_card(i, trans_b, out_dtype):
    _card()
    mkn, blk, order = committed_schedules()[i]
    g = torch.Generator(device="cuda").manual_seed(i)
    _check(mkn, blk, order, trans_b, getattr(torch, out_dtype), g)


# blocks reaching every (m tile, n tile) pair, at one and at four k chunks
TILE_BLOCKS = [(bm, bk, bn) for bm in (64, 128) for bn in (64, 128, 256) for bk in (64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_every_tile_layout_order_and_out_dtype(trans_b, out_dtype):
    """Each (m tile, n tile) pair in both grid orders, at ragged M and N
    (1000: off multiples of 64 and 128) and K = 520 (a partial last chunk)."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    for blk in TILE_BLOCKS:
        for order in ("mn", "nm"):
            _check((1000, 520, 1000), blk, order, trans_b, getattr(torch, out_dtype), g)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
def test_ragged_shapes(trans_b):
    """M, N and K off multiples of 64 in both grid orders: one chunk of 8
    values, tiles past M and N, a last k step with fewer chunks than the
    stage holds."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(2)
    for mkn in [(65, 8, 72), (130, 520, 264), (200, 1000, 200), (1000, 72, 1032),
                (333, 1336, 8)]:
        for i, blk in enumerate([(64, 64, 64), (64, 200, 128), (128, 256, 256), (96, 130, 72)]):
            for out_dtype in (torch.bfloat16, torch.float32):
                _check(mkn, blk, ("mn", "nm")[i % 2], trans_b, out_dtype, g)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
def test_grids_around_the_sm_count(trans_b):
    """One tile (one CTA, whose second ping-pong consumer has none); fewer
    tiles than SMs, even and odd (a CTA a tile); at 64-row tiles two more
    than twice the SMs (the first two CTAs take three tiles, so one
    ping-pong consumer takes two); at 128-row tiles one more than the SMs
    (CTA 0 takes two, cooperatively); and a tile count no multiple of the
    grid.  Both grid orders."""
    from repro_torch.kernels.matmul import launch_plan, sm_count

    _card()
    sms = sm_count()
    g = torch.Generator(device="cuda").manual_seed(3)
    for (m, n, blk) in [(100, 72, (128, 64, 64)), (256, 128, (64, 64, 64)),
                        (320, 64, (64, 64, 64)), (64 * (2 * sms + 2), 64, (64, 64, 64)),
                        (128 * (sms + 1), 64, (128, 128, 64)), (2048, 2048, (64, 64, 128))]:
        plan = launch_plan(m, 256, n, *blk, dtype=torch.bfloat16)
        assert plan["ctas"] == min(plan["tiles"], sms)
        for order in ("mn", "nm"):
            for out_dtype in (torch.bfloat16, torch.float32):
                _check((m, 256, n), blk, order, trans_b, out_dtype, g)


@pytest.mark.cuda
def test_split_k_keeps_m_up_to_64():
    """M <= 64 runs the split-K kernel and counts under ``split_k``; M = 65
    the persistent one."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(4)
    for m in (1, 4, 33, 64):
        for trans_b in (False, True):
            _check((m, 2048, 2048), (4, 64, 64), "mn", trans_b, torch.bfloat16, g,
                   design="split_k")
    _check((65, 2048, 2048), (4, 64, 64), "mn", False, torch.bfloat16, g)
