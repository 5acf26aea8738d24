"""The port's Mamba path on the CPU against the JAX package's.

``mamba_scan_plain`` (what the scan wrapper runs for CPU tensors, and what
the CUDA kernel is held against on the card) against the Pallas kernel in
interpret mode and the token-by-token ``mamba_scan_ref`` over the JAX kernel
test's ranges, at 2e-4 (that test's tolerance); the wrapper on the model's
layout (strided views of one projection, bf16 dt, a carried state), the
``"mamba"`` registry block and the launch plan; and ``mamba_apply``,
``mamba_decode`` and ``mamba_reference`` against ``models/mamba.py`` at 1e-5
in f32 and 3e-2 in bf16.  Inputs come from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import ScheduleRegistry as RRegistry
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.mamba_scan import mamba_scan as pallas_scan
from repro.models import mamba as RM
from repro_torch.core import ScheduleRegistry as TRegistry
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mamba_scan import (
    LANES,
    MAX_CC,
    MAX_L,
    launch_plan,
    mamba_scan,
    mamba_scan_plain,
    mamba_scan_plain_model,
)
from repro_torch.models import mamba as TM

TOL = 2e-4       # tests/test_kernels.py's for the scan
MODEL_TOL = 1e-5  # max abs diff / max abs, f32 through one Mamba layer
BF16_TOL = 3e-2   # the same in bf16: 8-bit mantissa, roundings placed alike

# (S, C, N, chunk, bd): the JAX sweep's ranges (S 1-40, C 8/20/32, N 4/8,
# chunks 4/8/32, bd 8/16/128, ragged tails), then N = 16 (jamba's)
SCAN_CASES = [(1, 8, 4, 4, 8), (5, 20, 8, 4, 16), (17, 32, 4, 8, 128), (40, 20, 8, 32, 8),
              (33, 8, 8, 8, 16), (40, 32, 4, 4, 128), (23, 20, 16, 8, 128),
              (64, 32, 16, 32, 16)]


def _scan_inputs(s, c, n, seed, b=2):
    """dtx, da, b, c as the JAX kernel test draws them."""
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    dtx = rand(b, s, c, scale=0.3)
    da = -np.exp(rand(b, s, c, n) - 2.0)
    return dtx, da, rand(b, s, n, scale=0.5), rand(b, s, n, scale=0.5)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "s{}_c{}_n{}_l{}_bd{}".format(*c))
def test_plain_scan_matches_pallas_and_ref(case):
    s, c, n, chunk, bd = case
    arrs = _scan_inputs(s, c, n, seed=s * 11 + c)
    y, h = mamba_scan_plain(*_t(*arrs), chunk=chunk)
    yp, hp = pallas_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk, bd=bd, interpret=True)
    yr, hr = rref.mamba_scan_ref(*(jnp.asarray(a) for a in arrs))
    assert y.shape == (2, s, c) and y.dtype == torch.float32 and h.shape == (2, c, n)
    for want_y, want_h in ((yp, hp), (yr, hr)):
        np.testing.assert_allclose(y.numpy(), want_y, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(h.numpy(), want_h, rtol=TOL, atol=TOL)


def test_port_ref_matches_jax_ref():
    arrs = _scan_inputs(29, 20, 8, seed=5)
    y, h = tref.mamba_scan_ref(*_t(*arrs))
    yr, hr = rref.mamba_scan_ref(*(jnp.asarray(a) for a in arrs))
    np.testing.assert_allclose(y.numpy(), yr, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), hr, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("split,chunk", [(13, 8), (32, 32), (1, 4)])
def test_carried_state_splits_the_scan(split, chunk):
    """Scanning two parts, the second from the first's final state, equals
    scanning the whole (chunking is exact in real arithmetic)."""
    dtx, da, b, c = _t(*_scan_inputs(50, 20, 8, seed=split))
    y, h = mamba_scan_plain(dtx, da, b, c, chunk=chunk)
    y1, h1 = mamba_scan_plain(*(t[:, :split] for t in (dtx, da, b, c)), chunk=chunk)
    y2, h2 = mamba_scan_plain(*(t[:, split:] for t in (dtx, da, b, c)), chunk=chunk, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=TOL, atol=TOL)


def _model_inputs(bsz, s, ch, n, seed, dtype=torch.float32, rank=4):
    """x, dt (B, S, C); a (C, N); b and c as views of one (B, S, R + 2N)
    projection, as ``_ssm_inputs`` makes them; h0 (B, C, N).  dt is a
    small positive step (softplus around the init's 0.01)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((bsz, s, ch)).astype(np.float32))
    dt = torch.from_numpy(np.exp(0.5 * rng.standard_normal((bsz, s, ch)) - 3.5)
                          .astype(np.float32))
    a = -torch.arange(1, n + 1, dtype=torch.float32)[None].repeat(ch, 1)
    proj = torch.from_numpy(
        (0.5 * rng.standard_normal((bsz, s, rank + 2 * n))).astype(np.float32))
    h0 = torch.from_numpy((0.1 * rng.standard_normal((bsz, ch, n))).astype(np.float32))
    x, dt, proj = (t.to(dtype) for t in (x, dt, proj))
    _, b, c = torch.split(proj, [rank, n, n], dim=-1)
    return x, dt, a, b, c, h0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_wrapper_takes_the_model_layout_on_cpu(dtype, with_h0):
    """The wrapper on x, bf16 dt, a and strided b/c views computes what the
    plain version computes on dtx and da formed in f32; a CPU tensor
    launches nothing."""
    bsz, s, ch, n = 2, 45, 40, 16
    x, dt, a, b, c, h0 = _model_inputs(bsz, s, ch, n, seed=7, dtype=getattr(torch, dtype))
    assert b.stride(1) == 4 + 2 * n and not b.is_contiguous()
    h0 = h0 if with_h0 else None
    before = mamba_scan.launches
    y, h = mamba_scan(x, dt, a, b, c, chunk=16, h0=h0)
    assert mamba_scan.launches == before
    dt32 = dt.float()
    want_y, want_h = mamba_scan_plain(dt32 * x.float(), dt32[..., None] * a, b, c,
                                      chunk=16, h0=h0)
    assert y.shape == (bsz, s, ch) and y.dtype == torch.float32
    assert h.shape == (bsz, ch, n) and h.dtype == torch.float32
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)
    # and the token-by-token oracle on the same f32 operands
    yr, hr = tref.mamba_scan_ref(dt32 * x.float(), dt32[..., None] * a, b.float(), c.float())
    if with_h0:  # the oracle starts at zero: scan h0's decayed share separately
        yz, hz = mamba_scan_plain(torch.zeros_like(dt32), dt32[..., None] * a, b, c,
                                  chunk=16, h0=h0)
        yr, hr = yr + yz, hr + hz
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), rtol=TOL, atol=TOL)


def test_launch_plan_clamps_the_block():
    """Tokens a tile, channels a CTA (a multiple of 32 up to 128) and
    LANES = 2 threads a channel."""
    assert LANES == 2 and MAX_CC == 128
    assert launch_plan(1024, 8192, 64, 128) == {"l": 64, "cc": 128, "threads": 256,
                                                "n_tiles": 16, "n_ctas": 64}
    assert launch_plan(40, 20, 32, 128) == {"l": 32, "cc": 32, "threads": 64, "n_tiles": 2,
                                            "n_ctas": 1}
    assert launch_plan(5, 8192, 32, 8) == {"l": 5, "cc": 32, "threads": 64, "n_tiles": 1,
                                           "n_ctas": 256}
    assert launch_plan(300, 1000, 256, 1000) == {"l": MAX_L, "cc": MAX_CC,
                                                 "threads": MAX_CC * LANES, "n_tiles": 5,
                                                 "n_ctas": 8}
    assert launch_plan(10, 100, 4, 33)["cc"] == 64
    with pytest.raises(ValueError):
        launch_plan(0, 8)


@pytest.mark.parametrize("s,c,chunk,bd", [(1, 1, 1, 1), (1024, 8192, 64, 128),
                                          (300, 1000, 256, 1000), (7, 33, 3, 31),
                                          (64, 129, 64, 97), (2000, 50, 100, 64)])
def test_launch_plan_covers_every_token_and_channel(s, c, chunk, bd):
    plan = launch_plan(s, c, chunk, bd)
    assert 1 <= plan["l"] <= min(s, MAX_L, chunk)
    assert plan["n_tiles"] * plan["l"] >= s > (plan["n_tiles"] - 1) * plan["l"]
    assert plan["cc"] % 32 == 0 and 32 <= plan["cc"] <= MAX_CC
    assert plan["n_ctas"] * plan["cc"] >= c > (plan["n_ctas"] - 1) * plan["cc"]
    # whole warps, and a channel's two lanes in one warp
    assert plan["threads"] == LANES * plan["cc"] and plan["threads"] % 64 == 0


# (S, C, N, chunk, bd): blocks that reach each token tile and CTA width
# (chip_smoke.py's MAMBA_SWEEP among them), ragged S and C
PLAN_CASES = [(70, 100, 16, 64, 128), (70, 100, 16, 64, 32), (70, 100, 16, 16, 128),
              (45, 200, 8, 32, 256), (9, 40, 4, 64, 64)]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "s{}_c{}_n{}_l{}_bd{}".format(*c))
def test_wrapper_at_the_plan_tile_matches_pallas(case):
    """The wrapper on the model's layout (strided b/c views) at the plan's
    tile, against the Pallas kernel in interpret mode at the same block on
    dtx and da formed in f32 (2e-4)."""
    s, ch, n, chunk, bd = case
    x, dt, a, b, c, _ = _model_inputs(2, s, ch, n, seed=s + ch)
    a = a * torch.from_numpy(np.exp(0.1 * np.random.default_rng(n).standard_normal(
        (ch, n))).astype(np.float32))
    y, h = mamba_scan(x, dt, a, b, c, chunk=chunk, bd=bd)
    dtx, da = (dt * x).numpy(), (dt[..., None] * a).numpy()
    yp, hp = pallas_scan(jnp.asarray(dtx), jnp.asarray(da), jnp.asarray(b.numpy()),
                         jnp.asarray(c.numpy()), chunk=chunk, bd=bd, interpret=True)
    np.testing.assert_allclose(y.numpy(), yp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), hp, rtol=TOL, atol=TOL)


def test_a_chunk_above_the_tile_runs_at_the_tile():
    """A requested chunk above 64 (a registry block) runs at 64: the same
    function, to rounding, as the TPU kernel at the requested chunk."""
    x, dt, a, b, c, _ = _model_inputs(1, 150, 16, 8, seed=3)
    y, h = mamba_scan(x, dt, a, b, c, chunk=128)
    dtx = (dt * x).numpy()
    da = (dt[..., None] * a).numpy()
    yp, hp = pallas_scan(jnp.asarray(dtx), jnp.asarray(da), jnp.asarray(b.numpy()),
                         jnp.asarray(c.numpy()), chunk=128, interpret=True)
    np.testing.assert_allclose(y.numpy(), yp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), hp, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bad", ["state_dim", "dtypes", "a_dtype", "a_shape", "h0_shape",
                                 "h0_dtype", "rank", "empty"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, dt, a, b, c, h0 = _model_inputs(1, 8, 16, 8, seed=1)
    kw = {"h0": h0}
    if bad == "state_dim":
        b, c, a, kw["h0"] = b[..., :6], c[..., :6], a[:, :6], h0[..., :6]
    elif bad == "dtypes":
        dt = dt.bfloat16()
    elif bad == "a_dtype":
        a = a.bfloat16()
    elif bad == "a_shape":
        a = a[:4]
    elif bad == "h0_shape":
        kw["h0"] = h0[:, :1]
    elif bad == "h0_dtype":
        kw["h0"] = h0.bfloat16()
    elif bad == "rank":
        x, dt = x[0], dt[0]
    elif bad == "empty":
        x, dt, b, c = (t[:, :0] for t in (x, dt, b, c))
    with pytest.raises((ValueError, TypeError)):
        mamba_scan(x, dt, a, b, c, **kw)


@pytest.mark.parametrize("chunk,bd", [(8, 16), (32, 128)])
def test_mamba_registry_block_sets_the_chunk(chunk, bd):
    """The "mamba" block {l, c} (workload (S, C)) reaches the scan in both
    packages alike; on the CPU ``l`` is the plain version's chunk."""
    bsz, s, ch, n = 2, 40, 20, 8
    x, dt, a, b, c, _ = _model_inputs(bsz, s, ch, n, seed=4)
    treg, rreg = TRegistry(), RRegistry()
    for reg in (treg, rreg):
        reg.put("mamba", (s, ch), 1.0, [])
        reg.get("mamba", (s, ch))["block"] = {"l": chunk, "c": bd}
    tops.set_registry(treg)
    rops.set_registry(rreg)
    dt32 = dt.float()
    try:
        y, h = tops.mamba_scan(x, dt, a, b, c)
        yr, hr = rops.mamba_scan(jnp.asarray((dt32 * x).numpy()),
                                 jnp.asarray((dt32[..., None] * a).numpy()),
                                 jnp.asarray(b.numpy()), jnp.asarray(c.numpy()))
    finally:
        tops.set_registry(None)
        rops.set_registry(None)
    want_y, want_h = mamba_scan_plain_model(x, dt, a, b, c, chunk=chunk)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)
    np.testing.assert_allclose(y.numpy(), yr, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), hr, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the Mamba layer against models/mamba.py
# ---------------------------------------------------------------------------


def _params(d, n, dtype, seed=0):
    """JAX's mamba_params and the same values as torch tensors."""
    p = RM.mamba_params(jax.random.PRNGKey(seed), d, n, 4, 2, getattr(jnp, dtype))
    return p, {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in p.items()}


def _x(shape, dtype, seed):
    x = (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(x), tx


def _close(got, want, dtype):
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= (
        MODEL_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches_jax(dtype):
    """Output, h and the conv window from a zero start and from a carried
    state (h and conv from a first call), at d_model 16, N 8; 70 tokens
    span two of the reference's chunks of 64."""
    s = 70
    p, tp = _params(16, 8, dtype)
    jx, tx = _x((2, s, 16), dtype, seed=s)
    apply = jax.jit(RM.mamba_apply)
    want = apply(p, jx)
    got = TM.mamba_apply(tp, tx)
    assert got[1].h.dtype == torch.float32
    for g_, w_ in ((got[0], want[0]), (got[1].h, want[1].h), (got[1].conv, want[1].conv)):
        _close(g_, w_, dtype)
    jx2, tx2 = _x((2, 9, 16), dtype, seed=s + 1)
    want2 = apply(p, jx2, want[1])
    got2 = TM.mamba_apply(tp, tx2, TM.MambaState(torch.from_numpy(np.array(want[1].h)),
                                                  got[1].conv))
    for g_, w_ in ((got2[0], want2[0]), (got2[1].h, want2[1].h),
                   (got2[1].conv, want2[1].conv)):
        _close(g_, w_, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_and_reference_match_jax(dtype):
    p, tp = _params(16, 8, dtype, seed=1)
    jx, tx = _x((2, 6, 16), dtype, seed=2)
    want = RM.mamba_reference(p, jx)
    got = TM.mamba_reference(tp, tx)
    for g_, w_ in ((got[0], want[0]), (got[1].h, want[1].h), (got[1].conv, want[1].conv)):
        _close(g_, w_, dtype)


def test_mamba_apply_matches_the_token_by_token_recurrence():
    """The check chip_smoke.py makes on the card at full width, here small
    and in f32: the prefill (the scan) against the plain decode recurrence,
    at the JAX test's 2e-3 (tests/test_moe.py)."""
    _, tp = _params(32, 16, "float32", seed=3)
    _, tx = _x((2, 100, 32), "float32", seed=4)
    out, st = TM.mamba_apply(tp, tx)
    out_r, st_r = TM.mamba_reference(tp, tx)
    assert _rel(out.numpy(), out_r.numpy()) <= 2e-3
    assert _rel(st.h.numpy(), st_r.h.numpy()) <= 2e-3
    # the window holds in_proj outputs, which a whole-sequence product and
    # one-token products round alike only to f32 precision
    assert _rel(st.conv.numpy(), st_r.conv.numpy()) <= MODEL_TOL
