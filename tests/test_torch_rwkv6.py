"""The port's RWKV-6 path on the CPU against the JAX package's.

``rwkv6_chunk_scan_plain`` (what the scan wrapper runs for CPU tensors, and
what the CUDA kernel is held against on the card) against the Pallas kernel
in interpret mode and the token-by-token ``rwkv6_ref`` over the JAX kernel
test's ranges plus N = 64 at chunk 128, at 2e-4 (that test's tolerance);
the kernel's two-pass decomposition, written here in plain torch, against
both, and its launch plan; the wrapper's layout, carried state and
``"rwkv6"`` registry block; the
time-mix and channel-mix against ``models/rwkv6.py``; the whole rwkv6-7b
smoke model (prefill + 4 decode steps) against the JAX steps at 1e-4 in f32
with equal greedy tokens; the converter's per-leaf dtypes; and the serve
loop on the CPU.  Inputs come from numpy with a seed, or JAX weights carried
across with ``params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.core import ScheduleRegistry as RRegistry
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.rwkv6_scan import rwkv6_chunk_scan as pallas_scan
from repro.models import rwkv6 as RR
from repro.models import steps as RS
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.core import ScheduleRegistry as TRegistry
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rwkv6_scan import (
    MAX_CHUNK,
    launch_plan,
    rwkv6_chunk_scan,
    rwkv6_chunk_scan_plain,
    rwkv6_chunk_scan_plain_heads,
    to_streams,
)
from repro_torch.launch import serve as SV
from repro_torch.models import rwkv6 as TR
from repro_torch.models import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax

TOL = 2e-4  # tests/test_kernels.py's for the scan
MODEL_TOL = 1e-4  # max abs diff / max abs, f32 through the model

# (BH, S, N, chunk): the JAX sweep's ranges (S 1-70, N 4/8/16, chunks
# 4/16/64, BH 1-4, ragged tails), then N = 64 at chunks 64 and 128
SCAN_CASES = [(1, 1, 4, 4), (2, 5, 8, 16), (3, 17, 16, 4), (4, 64, 4, 64),
              (1, 70, 16, 16), (2, 70, 8, 64), (4, 33, 16, 16), (1, 130, 64, 64),
              (2, 200, 64, 128)]


def _scan_inputs(bh, s, n, seed):
    """r, k, v, logw, u as the JAX kernel test draws them."""
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    r, k, v = (rand(bh, s, n, scale=0.5) for _ in range(3))
    logw = -np.exp(rand(bh, s, n) - 2.0)
    return r, k, v, logw, rand(bh, n, scale=0.3)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "bh{}_s{}_n{}_l{}".format(*c))
def test_plain_scan_matches_pallas_and_ref(case):
    bh, s, n, chunk = case
    arrs = _scan_inputs(bh, s, n, seed=s * 17 + n)
    y, st = rwkv6_chunk_scan_plain(*_t(*arrs), chunk=chunk)
    yp, sp = pallas_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk, interpret=True)
    yr, sr = rref.rwkv6_ref(*(jnp.asarray(a) for a in arrs))
    assert y.shape == (bh, s, n) and y.dtype == torch.float32 and st.shape == (bh, n, n)
    for want_y, want_s in ((yp, sp), (yr, sr)):
        np.testing.assert_allclose(y.numpy(), want_y, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(st.numpy(), want_s, rtol=TOL, atol=TOL)


def _fast_decay_inputs(bh, s, n, seed):
    """r, k, v and u as :func:`_scan_inputs` draws them, with logw = -e^{2z},
    z standard normal: decays from about 1 to e^-1000 a token, so that
    128-token chunks sum logw far below -88 (where e^{-cum} leaves f32)."""
    r, k, v, _, u = _scan_inputs(bh, s, n, seed)
    z = np.random.default_rng(seed + 1).standard_normal((bh, s, n))
    return r, k, v, (-np.exp(2.0 * z)).astype(np.float32), u


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_plain_scan_holds_at_trained_decay_speeds(chunk):
    """Chunk sums of logw below -300 (a trained checkpoint's decays pass -88
    within a few dozen tokens): the plain version, and the wrapper at its
    tile, stay finite and equal the token-by-token recurrence at 2e-4."""
    bh, s, n = 3, 200, 16
    r, k, v, logw, u = _t(*_fast_decay_inputs(bh, s, n, seed=chunk))
    tile = min(chunk, s)
    sums = torch.nn.functional.pad(logw, (0, 0, 0, -s % tile)).reshape(bh, -1, tile, n).sum(2)
    assert sums.min() < -300
    want_y, want_s = tref.rwkv6_ref(r, k, v, logw, u)
    y, st = rwkv6_chunk_scan_plain(r, k, v, logw, u, chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y, want_y, rtol=TOL, atol=TOL)
    torch.testing.assert_close(st, want_s, rtol=TOL, atol=TOL)
    heads = [t.reshape(1, bh, s, n).transpose(1, 2) for t in (r, k, v, logw)]
    y, st = rwkv6_chunk_scan(*heads, u[:1].expand(bh, n).contiguous(), chunk=chunk)
    want_y, want_s = tref.rwkv6_ref(r, k, v, logw, u[:1].expand(bh, n))
    torch.testing.assert_close(to_streams(y), want_y, rtol=TOL, atol=TOL)
    torch.testing.assert_close(st[0], want_s, rtol=TOL, atol=TOL)


def test_port_ref_matches_jax_ref():
    arrs = _scan_inputs(3, 29, 8, seed=5)
    y, st = tref.rwkv6_ref(*_t(*arrs))
    yr, sr = rref.rwkv6_ref(*(jnp.asarray(a) for a in arrs))
    np.testing.assert_allclose(y.numpy(), yr, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.numpy(), sr, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("split,chunk", [(40, 16), (64, 64), (1, 4)])
def test_carried_state_splits_the_scan(split, chunk):
    """Scanning two parts, the second from the first's final state, equals
    scanning the whole (chunking is exact in real arithmetic)."""
    r, k, v, logw, u = _t(*_scan_inputs(2, 100, 16, seed=split))
    y, st = rwkv6_chunk_scan_plain(r, k, v, logw, u, chunk=chunk)
    y1, s1 = rwkv6_chunk_scan_plain(*(t[:, :split] for t in (r, k, v, logw)), u,
                                    chunk=chunk)
    y2, s2 = rwkv6_chunk_scan_plain(*(t[:, split:] for t in (r, k, v, logw)), u,
                                    chunk=chunk, s0=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s2.numpy(), st.numpy(), rtol=TOL, atol=TOL)


def _heads_inputs(b, s, h, n, seed, dtype=torch.float32):
    """(B, S, H, N) r, k, v, logw, u (H, N) and s0 (B, H, N, N)."""
    r, k, v, logw, _ = _t(*_scan_inputs(b * h, s, n, seed))
    rng = np.random.default_rng(seed + 1)
    u = torch.from_numpy((0.3 * rng.standard_normal((h, n))).astype(np.float32))
    s0 = torch.from_numpy((0.1 * rng.standard_normal((b, h, n, n))).astype(np.float32))
    heads = [t.reshape(b, h, s, n).transpose(1, 2) for t in (r, k, v, logw)]
    return [t.to(dtype) for t in heads[:3]] + [heads[3], u, s0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wrapper_takes_the_model_layout_on_cpu(dtype, with_s0):
    """The wrapper's (B, S, H, N) streams, per-head u and s0 compute what
    the plain version computes on (BH, S, N) streams with u per stream; a
    CPU tensor launches nothing."""
    b, s, h, n = 2, 45, 3, 16
    r, k, v, logw, u, s0 = _heads_inputs(b, s, h, n, seed=7, dtype=getattr(torch, dtype))
    s0 = s0 if with_s0 else None
    before = rwkv6_chunk_scan.launches
    y, st = rwkv6_chunk_scan(r, k, v, logw, u, chunk=16, s0=s0)
    assert rwkv6_chunk_scan.launches == before
    want_y, want_s = rwkv6_chunk_scan_plain(
        *(to_streams(t) for t in (r, k, v, logw)), u.repeat(b, 1), chunk=16,
        s0=None if s0 is None else s0.reshape(b * h, n, n))
    assert y.shape == (b, s, h, n) and y.dtype == torch.float32
    assert st.shape == (b, h, n, n) and st.dtype == torch.float32
    torch.testing.assert_close(to_streams(y), want_y, rtol=0, atol=0)
    torch.testing.assert_close(st.reshape(b * h, n, n), want_s, rtol=0, atol=0)
    heads_y, heads_s = rwkv6_chunk_scan_plain_heads(r, k, v, logw, u, chunk=16, s0=s0)
    torch.testing.assert_close(y, heads_y, rtol=0, atol=0)
    torch.testing.assert_close(st, heads_s, rtol=0, atol=0)


def test_launch_plan_clamps_the_chunk():
    def tile(s, chunk):
        plan = launch_plan(s, chunk)
        return {"chunk": plan["chunk"], "n_chunks": plan["n_chunks"]}

    assert tile(1024, 128) == {"chunk": 128, "n_chunks": 8}
    assert tile(70, 64) == {"chunk": 64, "n_chunks": 2}
    assert tile(5, 64) == {"chunk": 5, "n_chunks": 1}
    assert tile(300, 256) == {"chunk": MAX_CHUNK, "n_chunks": 3}
    with pytest.raises(ValueError):
        launch_plan(0, 64)


def test_launch_plan_reports_the_passes_at_the_model_shape():
    """rwkv6-7b's prefill, (B, S, H, N) = (4, 1024, 64, 64) at chunk 128:
    pass 1 one CTA per (stream, chunk), pass 2 one per (stream, 32 state
    columns), the chunks' increments and decays and r_dec in scratch."""
    assert launch_plan(1024, 128, b=4, h=64, n=64, dtype=torch.bfloat16) == {
        "chunk": 128, "n_chunks": 8, "pass1_ctas": 2048, "pass2_ctas": 512,
        "slice_cols": 32,
        "scratch_bytes": 4 * (4 * 64 * 8 * (64 * 64 + 64) + 4 * 1024 * 64 * 64),
        "smem_bytes": (222208, 71936)}
    # f32 r, k and v are staged in place
    assert launch_plan(1024, 128, b=4, h=64, n=64)["smem_bytes"] == (185344, 71936)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("s,chunk", [(1, 64), (5, 4), (37, 16), (70, 64), (300, 100),
                                     (1024, 128), (200, 256)])
def test_launch_plan_fits_every_head_dim_and_tile(n, s, chunk, dtype):
    """Both passes fit the 227 KB a block may use at every head dim, tile
    and dtype; pass 2 at most 75 KB (three CTAs an SM); the slices cover the
    state's columns; the scratch holds an N x N increment and N decays a
    chunk and stream, and r_dec for every token."""
    plan = launch_plan(s, chunk, b=2, h=3, n=n, dtype=dtype)
    pass1, pass2 = plan["smem_bytes"]
    assert pass1 <= 232448 and pass2 <= 233472 // 3 - 1024
    assert plan["slice_cols"] * plan["pass2_ctas"] == 2 * 3 * n
    assert plan["pass1_ctas"] == 2 * 3 * plan["n_chunks"]
    assert plan["scratch_bytes"] == 4 * (plan["pass1_ctas"] * (n * n + n) + 2 * s * 3 * n)
    assert plan["chunk"] * plan["n_chunks"] >= s > plan["chunk"] * (plan["n_chunks"] - 1)


def _chunk_parallel(r, k, v, logw, u, chunk, s0=None):
    """The kernel's two passes in plain torch, f32.  Pass 1, every chunk at
    once, in sub-chunks of 16 rows (zero-padded): c, the cumsum of logw
    within each sub-chunk, c' the row before's, G the chunk's sum before the
    sub-chunk; the pairs' products A_ts = sum_n r k e^{c'_t - c_s}; r_dec =
    r e^{G + c'}; then a walk over the sub-chunks from a zero state D: y =
    r e^{c'} D + A v + (sum r u k) v, D = diag(e^{c_last}) D + (k
    e^{c_last - c})^T v.  The chunk's increment is the last D and its decay
    e^{G_end}.  Pass 2, in chunk order from s0: the inter-chunk term r_dec
    S_{c-1}, then S_c = diag(decay) S_{c-1} + dS_c."""
    bh, s, n = r.shape
    L = min(chunk, s)
    nc = -(-s // L)
    lt = 16 * -(-L // 16)
    streams = []
    for t in (r, k, v, logw):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, nc * L - s)).reshape(bh, nc, L, n)
        streams.append(torch.nn.functional.pad(t, (0, 0, 0, lt - L))
                       .reshape(bh, nc, lt // 16, 16, n))
    r, k, v, lw = streams                                    # (BH, C, I, 16, N)
    cum = torch.cumsum(lw, dim=3)
    cum_ex = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]], dim=3)
    last = cum[..., -1:, :]
    g = torch.cumsum(last, dim=2) - last                     # the chunk's sum before I
    strict = torch.ones(16, 16, dtype=torch.bool).tril(-1)
    expo = (cum_ex[..., :, None, :] - cum[..., None, :, :]).masked_fill(
        ~strict[..., None], float("-inf"))
    att = (r[..., :, None, :] * k[..., None, :, :] * torch.exp(expo)).sum(-1)
    diag = (r * u.float()[:, None, None, None, :] * k).sum(-1, keepdim=True)
    r_dec = r * torch.exp(g + cum_ex)
    y = att @ v + diag * v                                   # pass 1
    d = torch.zeros(bh, nc, n, n)
    for i in range(lt // 16):
        y[:, :, i] += (r[:, :, i] * torch.exp(cum_ex[:, :, i])) @ d
        d = (torch.exp(last[:, :, i, 0])[..., None] * d
             + (k[:, :, i] * torch.exp(last[:, :, i] - cum[:, :, i])).transpose(-1, -2)
             @ v[:, :, i])
    decay = torch.exp(g[:, :, -1, 0] + last[:, :, -1, 0])    # (BH, C, N)
    y, r_dec = (t.reshape(bh, nc, lt, n)[:, :, :L] for t in (y, r_dec))
    state = torch.zeros(bh, n, n) if s0 is None else s0.float()
    for c in range(nc):                                      # pass 2
        y[:, c] += r_dec[:, c] @ state
        state = decay[:, c, :, None] * state + d[:, c]
    return y.reshape(bh, nc * L, n)[:, :s], state


@pytest.mark.parametrize("n", [4, 16, 64])
@pytest.mark.parametrize("chunk", [4, 16, 64])
@pytest.mark.parametrize("with_s0", [False, True])
def test_chunk_parallel_passes_match_pallas_and_plain(n, chunk, with_s0):
    """The two-pass decomposition the kernel computes equals the TPU
    kernel's sequential chunk loop (Pallas, interpret mode) and the port's
    plain version, at 2e-4 (f32; the tolerance of the JAX kernel test).
    With s0, the Pallas kernel (which starts from zeros) scans a prefix of
    two chunks first and its final state is s0: its outputs past the prefix
    are the scan from s0."""
    bh, s = 2, 70
    pre = 2 * chunk if with_s0 else 0
    arrs = _scan_inputs(bh, pre + s, n, seed=chunk * 7 + n + pre)
    want_y, want_s = pallas_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk, interpret=True)
    r, k, v, logw, u = _t(*arrs)
    s0 = None
    if with_s0:
        _, s0 = pallas_scan(*(jnp.asarray(a[:, :pre]) for a in arrs[:4]), jnp.asarray(arrs[4]),
                            chunk=chunk, interpret=True)
        s0 = torch.from_numpy(np.array(s0))
    r, k, v, logw = (t[:, pre:] for t in (r, k, v, logw))
    y, st = _chunk_parallel(r, k, v, logw, u, chunk, s0=s0)
    plain_y, plain_s = rwkv6_chunk_scan_plain(r, k, v, logw, u, chunk=chunk, s0=s0)
    for got_y, got_s in ((y, st), (plain_y, plain_s)):
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y)[:, pre:], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=TOL, atol=TOL)
    torch.testing.assert_close(y, plain_y, rtol=TOL, atol=TOL)
    torch.testing.assert_close(st, plain_s, rtol=TOL, atol=TOL)


def test_a_chunk_above_the_tile_runs_at_the_tile():
    """A requested chunk above 128 (a registry block) runs at 128: the
    same function, to rounding, as the TPU kernel at the requested chunk."""
    r, k, v, logw, u, _ = _heads_inputs(1, 300, 2, 8, seed=3)
    y, st = rwkv6_chunk_scan(r, k, v, logw, u, chunk=256)
    yp, sp = pallas_scan(*(jnp.asarray(to_streams(t).numpy()) for t in (r, k, v, logw)),
                         jnp.asarray(u.numpy()), chunk=256, interpret=True)
    np.testing.assert_allclose(to_streams(y).numpy(), yp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(st.reshape(2, 8, 8).numpy(), sp, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bad", ["head_dim", "dtypes", "logw_dtype", "u_shape",
                                 "s0_shape", "rank", "empty"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    r, k, v, logw, u, s0 = _heads_inputs(1, 8, 2, 8, seed=1)
    kw = {"s0": s0}
    if bad == "head_dim":
        r, k, v, logw = (t[..., :6] for t in (r, k, v, logw))
        u, kw["s0"] = u[:, :6], s0[..., :6, :6]
    elif bad == "dtypes":
        k = k.bfloat16()
    elif bad == "logw_dtype":
        logw = logw.bfloat16()
    elif bad == "u_shape":
        u = u[:1]
    elif bad == "s0_shape":
        kw["s0"] = s0[:, :1]
    elif bad == "rank":
        r, k, v, logw = (to_streams(t) for t in (r, k, v, logw))
    elif bad == "empty":
        r, k, v, logw = (t[:, :0] for t in (r, k, v, logw))
    with pytest.raises((ValueError, TypeError)):
        rwkv6_chunk_scan(r, k, v, logw, u, **kw)


@pytest.mark.parametrize("chunk", [8, 32])
def test_rwkv6_registry_block_sets_the_chunk(chunk):
    """The "rwkv6" block "l" (workload (S, N)) reaches the scan in both
    packages alike."""
    b, s, h, n = 1, 40, 2, 8
    r, k, v, logw, u, _ = _heads_inputs(b, s, h, n, seed=4)
    treg, rreg = TRegistry(), RRegistry()
    for reg in (treg, rreg):
        reg.put("rwkv6", (s, n), 1.0, [])
        reg.get("rwkv6", (s, n))["block"] = {"l": chunk}
    tops.set_registry(treg)
    rops.set_registry(rreg)
    try:
        y, st = tops.rwkv6_chunk_scan(r, k, v, logw, u)
        yr, sr = rops.rwkv6_chunk_scan(
            *(jnp.asarray(to_streams(t).numpy()) for t in (r, k, v, logw)),
            jnp.asarray(u.repeat(b, 1).numpy()))
    finally:
        tops.set_registry(None)
        rops.set_registry(None)
    want_y, want_s = rwkv6_chunk_scan_plain_heads(r, k, v, logw, u, chunk=chunk)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(st, want_s, rtol=0, atol=0)
    np.testing.assert_allclose(to_streams(y).numpy(), yr, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(st.reshape(b * h, n, n).numpy(), sr, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# time-mix and channel-mix against models/rwkv6.py
# ---------------------------------------------------------------------------


def _params_np(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("head_dim", [16, 64])
@pytest.mark.parametrize("s,chunk", [(40, 16), (64, 64)])
def test_time_mix_chunked_matches_jax(head_dim, s, chunk):
    d, b = 64, 2
    p = RR.rwkv_time_mix_params(jax.random.PRNGKey(head_dim), d, head_dim, jnp.float32)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    h = d // head_dim
    state = (0.1 * rng.standard_normal((b, h, head_dim, head_dim))).astype(np.float32)
    x_prev = rng.standard_normal((b, d)).astype(np.float32)
    want = RR.time_mix_chunked(p, jnp.asarray(x), head_dim, chunk=chunk,
                               state=jnp.asarray(state), x_prev=jnp.asarray(x_prev))
    got = TR.time_mix_chunked(_params_np(p), torch.from_numpy(x), head_dim, chunk=chunk,
                              state=torch.from_numpy(state),
                              x_prev=torch.from_numpy(x_prev))
    for g_, w_ in zip(got, want):
        assert tuple(g_.shape) == w_.shape
        assert _rel(g_.numpy(), w_) <= MODEL_TOL
    # no carries given: zero state and zero shift, as the reference
    want0 = RR.time_mix_chunked(p, jnp.asarray(x), head_dim, chunk=chunk)
    got0 = TR.time_mix_chunked(_params_np(p), torch.from_numpy(x), head_dim, chunk=chunk)
    for g_, w_ in zip(got0, want0):
        assert _rel(g_.numpy(), w_) <= MODEL_TOL


@pytest.mark.parametrize("head_dim", [16, 64])
def test_time_mix_decode_and_reference_match_jax(head_dim):
    d, b, s = 64, 2, 6
    p = RR.rwkv_time_mix_params(jax.random.PRNGKey(1), d, head_dim, jnp.float32)
    x = np.random.default_rng(2).standard_normal((b, s, d)).astype(np.float32)
    want = RR.time_mix_reference(p, jnp.asarray(x), head_dim)
    got = TR.time_mix_reference(_params_np(p), torch.from_numpy(x), head_dim)
    for g_, w_ in zip(got, want):
        assert _rel(g_.numpy(), w_) <= MODEL_TOL
    # the chunked prefill computes what the recurrence computes
    chunked = TR.time_mix_chunked(_params_np(p), torch.from_numpy(x), head_dim)
    for g_, w_ in zip(chunked, got):
        assert _rel(g_.numpy(), w_.numpy()) <= MODEL_TOL


def test_channel_mix_matches_jax():
    d, f, b, s = 64, 96, 2, 9
    p = RR.channel_mix_params(jax.random.PRNGKey(3), d, f, jnp.float32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    x_prev = rng.standard_normal((b, d)).astype(np.float32)
    for xp in (None, x_prev):
        want = RR.channel_mix(p, jnp.asarray(x), None if xp is None else jnp.asarray(xp))
        got = TR.channel_mix(_params_np(p), torch.from_numpy(x),
                             None if xp is None else torch.from_numpy(xp))
        for g_, w_ in zip(got, want):
            assert _rel(g_.numpy(), w_) <= MODEL_TOL


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

B, DECODES = 2, 4


def _cfgs(head_dim=64, **kw):
    """(JAX config, port config) of rwkv6-7b's smoke model at two layers."""
    kw = dict(n_layers=2, rwkv_head_dim=head_dim, **kw)
    return (dataclasses.replace(r_get_config("rwkv6-7b").smoke(), **kw),
            dataclasses.replace(get_config("rwkv6-7b").smoke(), **kw))


@pytest.mark.parametrize("head_dim,prompt", [(64, 12), (64, 140), (16, 140)])
def test_prefill_and_decode_match_jax(head_dim, prompt):
    """Last logits and the s/xt/xc caches after prefill and after each of 4
    decode steps within 1e-4 (f32); equal greedy tokens.  A 140-token
    prompt pads to two chunks of 128."""
    r_cfg, t_cfg = _cfgs(head_dim)
    max_len = prompt + DECODES
    params = RT.init_params(r_cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), t_cfg, "cpu")
    tokens = np.random.default_rng(prompt).integers(0, t_cfg.vocab, (B, prompt))

    r_last, r_caches, _ = RS.make_prefill_step(r_cfg, max_len)(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    t_last, t_caches, t_len = TS.make_prefill_step(t_cfg, max_len)(
        tparams, {"tokens": torch.tensor(tokens)})
    assert t_len == prompt

    def compare(t_logits, r_logits):
        assert _rel(t_logits.numpy(), r_logits) <= MODEL_TOL
        for name in ("s", "xt", "xc"):
            got, want = t_caches[0][name], r_caches[0][name]
            assert tuple(got.shape) == want.shape
            assert _rel(got.numpy(), want) <= MODEL_TOL

    compare(t_last, r_last)
    assert t_caches[0]["s"].dtype == torch.float32
    tok = np.asarray(r_last).argmax(-1)
    np.testing.assert_array_equal(t_last.argmax(-1).numpy(), tok)
    r_step, t_step = RS.make_decode_step(r_cfg), TS.make_decode_step(t_cfg)
    for i in range(DECODES):
        r_nxt, r_logits, r_caches = r_step(params, {"tokens": jnp.asarray(tok[:, None])},
                                           r_caches, jnp.int32(prompt + i))
        t_nxt, t_logits, t_caches = t_step(tparams, {"tokens": torch.tensor(tok[:, None])},
                                           t_caches, prompt + i)
        assert t_logits.shape == (B, 1, t_cfg.vocab)
        compare(t_logits, r_logits)
        np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(r_nxt))
        tok = np.asarray(r_nxt)


def test_prefill_matches_the_token_by_token_recurrence():
    """The check chip_smoke.py makes on the card, here in f32: the prefill
    (the scan) against the same prompt fed through decode_step from a zero
    cache (the plain recurrence)."""
    _, cfg = _cfgs(16)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab, (B, 30)))
    last, caches, _ = TS.make_prefill_step(cfg, 30)(params, {"tokens": tokens})
    step = TS.make_decode_step(cfg)
    rec = TT.init_cache(cfg, B, 30, device="cpu")
    for t in range(tokens.shape[1]):
        _, logits, rec = step(params, {"tokens": tokens[:, t:t + 1]}, rec, t)
    assert _rel(last.numpy(), logits[:, -1].numpy()) <= MODEL_TOL
    for name in ("s", "xt", "xc"):
        assert _rel(caches[0][name].numpy(), rec[0][name].numpy()) <= MODEL_TOL


def test_params_from_jax_keeps_each_leaf_dtype():
    """A bf16 rwkv pytree keeps its f32 leaves (decay, bonus, mixing and
    group-norm parameters) in f32 and its bf16 weights in bf16, with the
    same values."""
    r_cfg, t_cfg = _cfgs(16, dtype="bfloat16")
    params = RT.init_params(r_cfg, jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), t_cfg, "cpu")
    f32_names = {"mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0", "w_lora_a", "w_lora_b",
                 "u", "ln_w", "ln_b"}
    for i, blk in enumerate(tparams["blocks"]):
        for group in ("rwkv", "cmix"):
            for name, t in blk[group].named_parameters():
                want = np.asarray(params["blocks"][0][group][name][i])
                wants_f32 = group == "rwkv" and name in f32_names or name.startswith("mu_")
                assert want.dtype == (np.float32 if wants_f32 else ml_dtypes.bfloat16)
                assert t.dtype == (torch.float32 if wants_f32 else torch.bfloat16)
                np.testing.assert_array_equal(t.float().numpy(), want.astype(np.float32))
    assert tparams["lm_head"].dtype == torch.bfloat16


def test_init_params_makes_each_leaf_as_jax_does():
    """Names, shapes and dtypes of the port's initialiser against JAX's,
    for a bf16 model (JAX stacks each block leaf over n_periods)."""
    r_cfg, t_cfg = _cfgs(16, dtype="bfloat16")
    shapes = jax.eval_shape(lambda key: RT.init_params(r_cfg, key),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = {".".join(str(k.key) for k in path if isinstance(k, jax.tree_util.DictKey)): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    got = dict(TT.init_params(t_cfg, None, "meta").named_parameters())
    names = set()
    for name, t in got.items():
        parts = name.split(".")
        in_block = parts[0] == "blocks"
        key = ".".join(["blocks"] + parts[2:]) if in_block else name
        leaf = want[key]
        assert tuple(t.shape) == (leaf.shape[1:] if in_block else leaf.shape), name
        assert str(t.dtype) == f"torch.{leaf.dtype}", name
        names.add(key)
    assert names == set(want)


@pytest.mark.parametrize("arch_cfg", ["smoke", "full"])
def test_param_count_matches_jax(arch_cfg):
    r_cfg, t_cfg = r_get_config("rwkv6-7b"), get_config("rwkv6-7b")
    if arch_cfg == "smoke":
        r_cfg, t_cfg = r_cfg.smoke(), t_cfg.smoke()
    assert t_cfg.param_count() == r_cfg.param_count()
    if arch_cfg == "full":
        assert t_cfg.param_count() == 7_526_289_408


def test_serve_once_rwkv_on_cpu():
    cfg = get_config("rwkv6-7b").smoke()
    before = rwkv6_chunk_scan.launches
    s = SV.serve_once(cfg, requests=3, batch=2, prompt_len=6, gen_len=3, max_len=12,
                      device="cpu")
    assert s["arch"] == "rwkv6-7b-smoke" and s["logits_finite"]
    assert s["requests"] == 3 and s["tokens"] == 9 and s["prefill_waves"] == 2
    assert s["decode_steps"] == 4
    assert rwkv6_chunk_scan.launches == before  # CPU tensors run the plain version


def test_serve_main_rwkv_on_cpu(capsys):
    assert SV.main(["--arch", "rwkv6-7b", "--requests", "2", "--batch", "2",
                    "--prompt-len", "5", "--gen-len", "2", "--max-len", "8",
                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"arch": "rwkv6-7b-smoke"' in out and '"logits_finite": true' in out
