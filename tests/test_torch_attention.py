"""The port's attention on the CPU against the JAX package's.

``flash_attention_plain`` (what the flash-attention wrapper runs for CPU
tensors, and what the CUDA kernel is held against on the card) against the
Pallas kernel in interpret mode and against ``models.layers.attention``;
the port's ``attention``, ``attention_ref`` and the ``"fa"`` registry
lookup against theirs.  Inputs come from numpy with a seed.  Tolerances:
3e-5 in f32 (the JAX kernel tests'), 3e-2 in bf16 (8-bit mantissa; the
JAX model path also rounds p and the scaled q to bf16).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import ScheduleRegistry as RRegistry
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as RL
from repro_torch.core import ScheduleRegistry as TRegistry
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS, BWD_TC_TILES, HEAD_DIMS,
                                                 SIMT_SMEM_MAX, WS_HEAD_DIMS,
                                                 bwd_launch_plan, check_aligned,
                                                 flash_attention, flash_attention_plain,
                                                 launch_plan, simt_smem_bytes, ws_kv_tile,
                                                 ws_smem_bytes, ws_stages)
from repro_torch.models import layers as TL

TOL = {"float32": 3e-5, "bfloat16": 3e-2}

# (B, S, T, H, HKV, D, causal, window, softcap, dtype)
CASES = {
    "self_causal": (2, 37, 37, 4, 4, 16, True, None, None, "float32"),
    "ragged_s_lt_t": (2, 20, 45, 2, 2, 8, False, None, None, "float32"),
    "ragged_s_gt_t_causal": (1, 45, 20, 2, 1, 32, True, None, None, "float32"),
    "gqa_groups2": (2, 48, 48, 4, 2, 16, True, None, None, "float32"),
    "gqa_groups4_noncausal": (1, 33, 33, 4, 1, 32, False, None, None, "float32"),
    "window8": (1, 48, 48, 4, 2, 16, True, 8, None, "float32"),
    "softcap20": (1, 48, 48, 4, 2, 16, True, None, 20.0, "float32"),
    "window16_softcap50": (1, 48, 48, 4, 2, 16, True, 16, 50.0, "float32"),
    "two_kv_blocks_d64": (1, 130, 130, 2, 2, 64, True, None, None, "float32"),
    "bf16": (1, 64, 64, 4, 4, 16, True, None, None, "bfloat16"),
    "bf16_gqa_window": (2, 40, 40, 4, 2, 32, True, 12, None, "bfloat16"),
    # rows 31..39 see no key (the window ends before T): every version
    # gives the mean of v there (T <= bk, so the padded kv range is T)
    "no_visible_key": (1, 40, 24, 2, 2, 16, True, 8, None, "float32"),
    # jamba-v0.1-52b's head dim and GQA group (32 q heads over 8 kv heads)
    "d128_gqa_groups4": (1, 40, 40, 8, 2, 128, True, None, None, "float32"),
    "bf16_d128_gqa_groups4": (2, 33, 33, 4, 1, 128, True, None, None, "bfloat16"),
}


def _inputs(b, s, t, h, hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d))]
    if dtype == "bfloat16":  # both packages see the same rounded values
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    return arrs


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _close(out, ref, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_kernel_and_model_attention(name):
    b, s, t, h, hkv, d, causal, window, softcap, dtype = CASES[name]
    q, k, v = _inputs(b, s, t, h, hkv, d, dtype, seed=len(name))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = flash_attention_plain(_torch(q), _torch(k), _torch(v), **kw)
    assert out.shape == (b, s, h, d) and out.dtype == _torch(q).dtype
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(out, pallas_flash(jq, jk, jv, interpret=True, **kw), dtype)
    _close(out, RL.attention(jq, jk, jv, **kw), dtype)
    # the wrapper takes the plain version for CPU tensors
    wrapped = flash_attention(_torch(q), _torch(k), _torch(v), **kw)
    assert torch.equal(wrapped, out)


def test_no_visible_key_rows_are_the_mean_of_v():
    b, s, t, h, hkv, d, causal, window, softcap, dtype = CASES["no_visible_key"]
    q, k, v = _inputs(b, s, t, h, hkv, d, dtype, seed=1)
    out = flash_attention_plain(_torch(q), _torch(k), _torch(v), causal=causal,
                                window=window)
    blind = np.arange(s) >= t + window - 1
    assert blind.sum() == 9
    np.testing.assert_allclose(out[:, blind].numpy(),
                               np.broadcast_to(v.mean(axis=1, keepdims=True),
                                               (b, int(blind.sum()), h, d)),
                               rtol=1e-6, atol=1e-6)
    # ... where the one-softmax oracle gives 0
    ref = tref.attention_ref(_torch(q), _torch(k), _torch(v), causal=causal,
                             window=window)
    assert torch.count_nonzero(ref[:, blind]) == 0


@pytest.mark.parametrize("bk", [16, 128])
def test_fa_registry_block_sets_the_padded_kv_range(bk):
    """The "fa" block reaches the kernel: a row with no visible key is
    sum(v) / (cdiv(T, bk) * bk), in both packages alike."""
    b, s, t, h, hkv, d = 1, 40, 24, 2, 2, 16
    q, k, v = _inputs(b, s, t, h, hkv, d, "float32", seed=2)
    treg, rreg = TRegistry(), RRegistry()
    for reg in (treg, rreg):
        reg.put("fa", (s, t, d), 1.0, [])
        reg.get("fa", (s, t, d))["block"] = {"q": 16, "k": bk}
    tops.set_registry(treg)
    rops.set_registry(rreg)
    try:
        out = tops.flash_attention(_torch(q), _torch(k), _torch(v), window=8)
        ref = rops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), window=8)
    finally:
        tops.set_registry(None)
        rops.set_registry(None)
    _close(out, ref, "float32")
    t_pad = -(-t // min(bk, t)) * min(bk, t)
    np.testing.assert_allclose(out[0, -1].numpy(), v[0].sum(axis=0) / t_pad,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["self_causal", "gqa_groups4_noncausal",
                                  "window16_softcap50", "bf16_gqa_window"])
def test_attention_ref_matches(name):
    b, s, t, h, hkv, d, causal, window, softcap, dtype = CASES[name]
    q, k, v = _inputs(b, s, t, h, hkv, d, dtype, seed=3)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = tref.attention_ref(_torch(q), _torch(k), _torch(v), **kw)
    _close(out, rref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)), **kw), dtype)


@pytest.mark.parametrize("name", ["self_causal", "gqa_groups2", "window8", "bf16"])
def test_model_attention_prefill_matches(name):
    b, s, t, h, hkv, d, causal, window, softcap, dtype = CASES[name]
    q, k, v = _inputs(b, s, t, h, hkv, d, dtype, seed=4)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = TL.attention(_torch(q), _torch(k), _torch(v), **kw)
    _close(out, RL.attention(*(jnp.asarray(a) for a in (q, k, v)), **kw), dtype)


@pytest.mark.parametrize("window,softcap", [(None, None), (4, 30.0)])
@pytest.mark.parametrize("hkv", [4, 2])
def test_model_attention_decode_matches(window, softcap, hkv):
    b, t, h, d, pos = 2, 16, 4, 16, 9
    q, k, v = _inputs(b, 1, t, h, hkv, d, "float32", seed=5)
    kw = dict(causal=True, q_offset=pos, kv_len=pos + 1, window=window,
              softcap=softcap)
    out = TL.attention(_torch(q), _torch(k), _torch(v), **kw)
    _close(out, RL.attention(*(jnp.asarray(a) for a in (q, k, v)), **kw), "float32")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Shapes, dtypes, blocks and softcaps the kernel does not take raise on
    every device; a head dim without a kernel instance is refused by the
    launch plan (so on CUDA tensors), while the plain version takes it."""
    q, k = torch.zeros(1, 4, 4, 16), torch.zeros(1, 6, 2, 16)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head_dim 12"):
            launch_plan(4, 4, d=12, dtype=dtype)
    assert flash_attention(*(torch.zeros(1, 4, 2, 12) for _ in range(3))).shape == (1, 4, 2, 12)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 6, 3, 16), torch.zeros(1, 6, 3, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k, torch.zeros(1, 5, 2, 16))
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError):
        flash_attention(q, k, k, bk=0)
    with pytest.raises(ValueError):
        flash_attention(q, k, k, softcap=0.0)


@pytest.mark.parametrize("d", [12, 48, 96, 256])
def test_plain_matches_pallas_kernel_at_any_head_dim(d):
    """The plain version takes any D, as the TPU kernel does: D = 12 and 48
    (no kernel instance), 96 and 256 (phi3-mini's and gemma3-12b's), causal
    with a window and a softcap, GQA 2, S != T, against the Pallas kernel in
    interpret mode (3e-5, f32)."""
    b, s, t, h, hkv = 1, 40, 33, 4, 2
    q, k, v = _inputs(b, s, t, h, hkv, d, "float32", seed=d)
    kw = dict(causal=True, window=24, softcap=50.0, bq=32, bk=16)
    out = flash_attention_plain(_torch(q), _torch(k), _torch(v), **kw)
    ref = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), interpret=True, **kw)
    _close(out, ref, "float32")


# ---------------------------------------------------------------------------
# launch plan: route and CTA tile by (dtype, D) and the "fa" block (pure Python)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 96, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.float32, 96, "simt"), (torch.float32, 256, "simt"),
    (torch.bfloat16, 8, "simt"), (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"), (torch.float32, 8, "simt")])
def test_launch_plan_route_by_dtype_and_head_dim(dtype, d, route):
    assert launch_plan(1024, 1024, d=d, dtype=dtype)["route"] == route


@pytest.mark.parametrize("block,tc64,tc128,simt", [
    ((16, 16), (64, 16), (64, 16), (64, 16)),
    ((64, 128), (64, 64), (64, 32), (64, 64)),
    ((128, 128), (128, 64), (128, 32), (128, 32)),
    ((128, 16), (128, 16), (128, 16), (128, 16)),
    ((8, 64), (64, 64), (64, 32), (64, 64)),
    ((100, 48), (128, 64), (128, 32), (128, 32)),
    ((128, 32), (128, 32), (128, 32), (128, 32)),
    ((512, 512), (128, 64), (128, 32), (128, 32))])
def test_launch_plan_tile_for_block(block, tc64, tc128, simt):
    """The SIMT column is f32 at D = 128, where a 128 x 64 tile's shared
    memory (236,544 bytes) is over the card's 232,448 and the kv tile halves."""
    for d, want in ((64, tc64), (128, tc128)):
        tc = launch_plan(1024, 1024, *block, d=d, dtype=torch.bfloat16)
        assert (tc["q_tile"], tc["kv_tile"]) == want
    f32 = launch_plan(1024, 1024, *block, d=128, dtype=torch.float32)
    assert (f32["q_tile"], f32["kv_tile"]) == simt


@pytest.mark.parametrize("block,d,want", [((128, 128), 64, (128, 64)), ((128, 128), 128, (128, 32)),
                                          ((64, 512), 64, (64, 64)), ((16, 100), 64, (64, 64)),
                                          ((16, 100), 128, (64, 32)), ((16, 20), 128, (64, 32))])
def test_launch_plan_caps_the_kv_tile_by_head_dim(block, d, want):
    """The tensor-core kv tile is at most 4096 / D keys: 64 at D = 64, 32 at
    D = 128 (two CTAs an SM)."""
    plan = launch_plan(1024, 1024, *block, d=d, dtype=torch.bfloat16)
    assert (plan["q_tile"], plan["kv_tile"]) == want


@pytest.mark.parametrize("s,t,want", [
    (20, 45, (64, 64)),     # bq clamps to 20, bk to 45 -> kv tile 64
    (70, 30, (128, 32)),    # bk clamps to 30 -> 32
    (1, 1, (64, 16)),
    (200, 17, (128, 32))])
def test_launch_plan_clamps_the_block_to_s_and_t(s, t, want):
    plan = launch_plan(s, t, 128, 128, d=64, dtype=torch.bfloat16)
    assert (plan["q_tile"], plan["kv_tile"]) == want
    assert plan["t_pad"] == t  # bk clamped to T: one kv block, no padding


@pytest.mark.parametrize("t,bk,t_pad", [(24, 16, 32), (24, 128, 24), (100, 48, 144),
                                        (1024, 128, 1024), (45, 7, 49)])
def test_launch_plan_t_pad_follows_the_registry_bk(t, bk, t_pad):
    for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 16)):
        assert launch_plan(40, t, 64, bk, d=d, dtype=dtype)["t_pad"] == t_pad


# (block, tensor-core (q, kv) tile at D = 96 and 256, SIMT f32 at 96 and 256)
ZOO_TILES = [((16, 16), (128, 64), (128, 64), (64, 16), (64, 16)),
             ((64, 128), (128, 128), (128, 64), (64, 64), (64, 32)),
             ((128, 128), (128, 128), (128, 64), (128, 64), (64, 32)),
             ((128, 32), (128, 64), (128, 64), (128, 32), (64, 32)),
             ((100, 48), (128, 64), (128, 64), (128, 64), (64, 32)),
             ((512, 512), (128, 128), (128, 64), (128, 64), (64, 32))]


@pytest.mark.parametrize("block,tc96,tc256,simt96,simt256", ZOO_TILES,
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else x)
def test_launch_plan_at_the_zoo_head_dims(block, tc96, tc256, simt96, simt256):
    """bf16 at D = 96 and 256 runs flash_fwd_ws: 128 q rows whatever bq (two
    consumer warpgroups), 64 keys at D = 256, and at D = 96 (staged at its
    own width) 64 keys for bk <= 64, else 128; the SIMT route keeps 64 q rows
    at D = 256 (a 128-row tile spills) and halves the kv tile to fit: each
    tile within the card's shared memory, the mbarriers included."""
    for d, tc, simt in ((96, tc96, simt96), (256, tc256, simt256)):
        plan = launch_plan(1024, 1024, *block, d=d, dtype=torch.bfloat16)
        assert plan["route"] == "wgmma" and plan["kernel"] == "flash_fwd_ws"
        assert (plan["q_tile"], plan["kv_tile"]) == tc
        assert ws_smem_bytes(d, plan["kv_tile"]) <= SIMT_SMEM_MAX
        plan = launch_plan(1024, 1024, *block, d=d, dtype=torch.float32)
        assert plan["route"] == "simt" and (plan["q_tile"], plan["kv_tile"]) == simt
        assert simt_smem_bytes(d, *simt) <= SIMT_SMEM_MAX


# flash_fwd_tc's plans at D = 64 and 128, whole, as PR 15 set them:
# (block, plan at D = 64, plan at D = 128) at S = T = 1024
TC_PINNED = [((16, 16), (64, 16), (64, 16)), ((64, 128), (64, 64), (64, 32)),
             ((128, 128), (128, 64), (128, 32)), ((128, 16), (128, 16), (128, 16)),
             ((100, 48), (128, 64), (128, 32)), ((512, 512), (128, 64), (128, 32))]


@pytest.mark.parametrize("block,tc64,tc128", TC_PINNED, ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else x)
def test_launch_plan_keeps_flash_fwd_tc_at_64_and_128(block, tc64, tc128):
    """D = 64 and 128 stay on flash_fwd_tc with the tiles they had."""
    for d, (q_tile, kv_tile) in ((64, tc64), (128, tc128)):
        assert launch_plan(1024, 1024, *block, d=d, dtype=torch.bfloat16) == {
            "route": "wgmma", "kernel": "flash_fwd_tc", "q_tile": q_tile, "kv_tile": kv_tile,
            "t_pad": -(-1024 // block[1]) * block[1]}


@pytest.mark.parametrize("d,kv_tile,stages,smem", [(256, 64, 2, 197_736),
                                                   (96, 64, 4, 124_104),
                                                   (96, 128, 4, 222_408)])
def test_ws_tiles_fit_the_cards_shared_memory(d, kv_tile, stages, smem):
    """Each flash_fwd_ws tile: 1024 bytes of alignment slack, Q (128 rows),
    its stages of K and V and the mbarriers (Q's, full K and V and each
    consumer's empty K and V a stage) within 232,448 bytes, at least two
    stages, and no room for one more (or the cap of 4)."""
    assert ws_stages(d, kv_tile) == stages and ws_smem_bytes(d, kv_tile) == smem
    assert smem <= SIMT_SMEM_MAX and stages >= 2
    assert stages == 4 or smem + 4 * kv_tile * d + 8 * 6 > SIMT_SMEM_MAX
    assert smem == 1024 + 128 * d * 2 + stages * 4 * kv_tile * d + 8 * (1 + 6 * stages)


@pytest.mark.parametrize("t,bk,t_pad", [(24, 16, 32), (24, 128, 24), (100, 48, 144),
                                        (1024, 128, 1024), (45, 7, 49), (200, 64, 256)])
@pytest.mark.parametrize("d", WS_HEAD_DIMS)
def test_ws_plan_t_pad_follows_the_registry_bk(d, t, bk, t_pad):
    """On flash_fwd_ws T_pad is still cdiv(T, bk) * bk for the clamped bk,
    whatever kv tile the kernel runs; the kv tile follows bk at D = 96."""
    plan = launch_plan(40, t, 64, bk, d=d, dtype=torch.bfloat16)
    assert plan["kernel"] == "flash_fwd_ws" and plan["t_pad"] == t_pad
    assert plan["kv_tile"] == ws_kv_tile(d, min(bk, t))


def test_ws_mode_and_tiles_are_the_kernel_sources():
    """The source runs one of the four overlap modes, and its kv tile rule
    and stage cap are the plan's."""
    import re

    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert int(re.search(r"constexpr int kWsMode = (\d);", src).group(1)) in (0, 1, 2, 3)
    assert "return d == 256 || bk <= 64 ? 64 : 128;" in src
    assert "constexpr int kWsBarsMax = 1 + 6 * 4;" in src
    assert src.count("acc[i] *= (i & 2) ? alpha1 : alpha0;  "
                     "// the warp-specialised kernel's alpha rescale") == 1


def test_launch_plan_rejects_empty_arguments():
    for args in ((0, 4, 1, 1), (4, 0, 1, 1), (4, 4, 0, 1), (4, 4, 1, 0)):
        with pytest.raises(ValueError):
            launch_plan(*args, d=64, dtype=torch.bfloat16)


def test_tensor_core_route_refuses_misaligned_views():
    """The wgmma route loads 16-byte pieces: a base off 16 bytes or a row
    stride off 8 elements raises (the wrapper makes no copy)."""
    base = torch.zeros(2, 10, 3, 4, 64, dtype=torch.bfloat16)
    check_aligned(base[:, :, 0], base[:, :, 1], base[:, :, 2])  # a fused qkv buffer
    flat = torch.zeros(2 * 10 * 4 * 64 + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        check_aligned(flat[4:].view(2, 10, 4, 64))          # base 8 bytes off
    odd = torch.zeros(2, 10, 4, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        check_aligned(odd)                                  # head stride 68


# ---------------------------------------------------------------------------
# the backward's plan: route and tiles by (dtype, D) and (S, T) (pure Python)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 96, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 8, "simt"), (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 8, "simt"), (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 96, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt")])
def test_bwd_launch_plan_route_by_dtype_and_head_dim(dtype, d, route):
    """bf16 at D = 64, 96, 128 and 256 runs on the tensor cores; f32 at
    every D and bf16 at D <= 32 on the SIMT kernels, at 64 x 64 tiles, and
    32 x 32 at D = 256."""
    plan = bwd_launch_plan(1024, 1024, d=d, dtype=dtype)
    assert plan["route"] == route
    if route == "simt":
        assert [plan[k] for k in ("dkdv_kv_rows", "dkdv_q_tile", "dq_q_rows",
                                  "dq_kv_tile")] == [32 if d == 256 else 64] * 4


@pytest.mark.parametrize("s,t,d,want", [
    (1024, 1024, 64, (64, 32, 64, 32)),    # musicgen-large's training shape
    (1024, 1024, 128, (64, 32, 64, 32)),   # jamba's (4, 1024, 32/8, 128)
    (1024, 1024, 96, (64, 32, 64, 32)),    # phi3-mini's
    (100, 150, 64, (64, 32, 64, 32)),
    (4096, 4096, 256, (64, 32, 64, 16))])  # gemma3-12b's training shape
def test_bwd_launch_plan_tiles_at_the_models_shapes(s, t, d, want):
    """One group of 64 rows a CTA in both kernels (the loop is
    latency-bound: more CTAs an SM beat larger ones on the card), the dk/dv
    q tile (wgmma's N of S^T and dP^T) 32 and the dq kv tile 32, 16 at D =
    256 (two dq CTAs an SM)."""
    plan = bwd_launch_plan(s, t, d=d, dtype=torch.bfloat16)
    assert (plan["dkdv_kv_rows"], plan["dkdv_q_tile"], plan["dq_q_rows"],
            plan["dq_kv_tile"]) == want


@pytest.mark.parametrize("s,t,want", [
    (40, 40, (64, 64)), (64, 64, (64, 64)), (65, 64, (128, 64)), (64, 65, (64, 128)),
    (1, 1024, (64, 128)), (1024, 1, (128, 64)), (100, 150, (128, 128))])
def test_bwd_launch_plan_clamps_to_small_s_and_t(s, t, want):
    """One warpgroup where T (dk/dv: keys) or S (dq: q rows) fits 64 rows;
    the tiles along the other dim do not change."""
    for d in (64, 96, 128, 256):
        plan = bwd_launch_plan(s, t, d=d, dtype=torch.bfloat16)
        wk, nq, wq, tk = BWD_TC_TILES[d]
        assert (plan["dq_q_rows"], plan["dkdv_kv_rows"]) == (
            min(want[0], 64 * wq), min(want[1], 64 * wk))
        assert (plan["dkdv_q_tile"], plan["dq_kv_tile"]) == (nq, tk)


@pytest.mark.parametrize("d", [12, 48, 200, 1])
def test_bwd_launch_plan_refuses_a_head_dim_without_an_instance(d):
    """A D outside the instances has no backward kernel on either route."""
    assert d not in BWD_HEAD_DIMS
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="instances"):
            bwd_launch_plan(1024, 1024, d=d, dtype=dtype)


def test_every_forward_head_dim_has_a_backward_instance():
    """The backward has an instance at each of the forward's head dims, so a
    model the forward serves can also be trained on the card."""
    assert BWD_HEAD_DIMS == HEAD_DIMS
    assert set(BWD_TC_TILES) == {d for d in HEAD_DIMS if d >= 64}


def _simt_bwd_smem(d, t):
    """Shared memory of the backward's SIMT dk/dv CTA at tile ``t``, as the
    source's ``dkdv_smem_bytes``: K, V, Q and dout rows padded by 4 floats,
    P and dS padded alike, lse and delta, all f32 (the dq CTA holds one
    score tile fewer)."""
    return 4 * (4 * t * (d + 4) + 2 * t * (t + 4) + 2 * t)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bwd_simt_tiles_fit_the_cards_shared_memory(d):
    """The backward's SIMT tile at every head dim fits the 232,448 bytes a
    CTA can have: 64 rows up to D = 128, and 32 at D = 256, where 64-row
    tiles would take 301,568 bytes."""
    plan = bwd_launch_plan(1024, 1024, d=d, dtype=torch.float32)
    tile = plan["dkdv_kv_rows"]
    assert plan["dkdv_q_tile"] == plan["dq_q_rows"] == plan["dq_kv_tile"] == tile
    assert _simt_bwd_smem(d, tile) <= SIMT_SMEM_MAX
    assert tile == 64 or _simt_bwd_smem(d, 2 * tile) > SIMT_SMEM_MAX
    if d == 256:
        assert (_simt_bwd_smem(d, 32), _simt_bwd_smem(d, 64)) == (142_592, 301_568)


def test_bwd_launch_plan_rejects_empty_arguments():
    for s, t in ((0, 4), (4, 0), (-1, 4)):
        with pytest.raises(ValueError):
            bwd_launch_plan(s, t, d=64, dtype=torch.bfloat16)


def test_bwd_tiles_are_the_kernel_sources():
    """``BWD_TC_TILES`` is the source's ``kTcTiles`` table, row by row (the
    kernel's own plan is held equal on the card), and each tile is one the
    kernels take: warpgroups 1 or 2, wgmma N of 16, 32 or 64."""
    import re

    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    line = re.search(r"constexpr int kTcTiles\[4\]\[4\] = \{(.*)\};", src).group(1)
    rows = [tuple(int(x) for x in r.split(",")) for r in re.findall(r"\{([^{}]*)\}", line)]
    assert rows == [BWD_TC_TILES[d] for d in (64, 96, 128, 256)]
    for wk, nq, wq, tk in rows:
        assert wk in (1, 2) and wq in (1, 2) and nq in (16, 32, 64) and tk in (16, 32, 64)


# ---------------------------------------------------------------------------
# the SIMT route's tiles (f32 at every D, bf16 at D <= 32)
# ---------------------------------------------------------------------------

# a block for each (q tile, kv tile) the SIMT plan picks: 64 or 128 rows by
# 16, 32 or 64 keys
SIMT_BLOCKS = [(16, 16), (64, 32), (64, 64), (100, 16), (128, 32), (128, 128)]


@pytest.mark.parametrize("dtype,d", [("float32", 16), ("float32", 64), ("bfloat16", 32)])
@pytest.mark.parametrize("block", SIMT_BLOCKS, ids=lambda b: "bq{}_bk{}".format(*b))
def test_wrapper_at_each_simt_tile_matches_pallas(block, dtype, d):
    """The wrapper at the blocks that reach each SIMT tile, against the Pallas
    kernel in interpret mode at the same block: causal with a window (rows
    69-79 see no key, so each is sum(v) over the block's padded kv range), a
    softcap, GQA 2, S != T (3e-5 f32, 3e-2 bf16)."""
    b, s, t, h, hkv = 1, 80, 50, 2, 1
    plan = launch_plan(s, t, *block, d=d, dtype=getattr(torch, dtype))
    assert plan["route"] == "simt" and plan["q_tile"] in (64, 128)
    q, k, v = _inputs(b, s, t, h, hkv, d, dtype, seed=d + block[1])
    kw = dict(causal=True, window=20, softcap=30.0, bq=block[0], bk=block[1])
    out = flash_attention(_torch(q), _torch(k), _torch(v), **kw)
    ref = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), interpret=True, **kw)
    _close(out, ref, dtype)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_simt_plan_fits_the_shared_memory(d):
    """The SIMT kv tile is the power of two >= bk in [16, 64], halved only
    while the CTA's Q, K/V ring and P exceed the card's shared memory (the q
    tile is 64 rows at D = 256 whatever the block)."""
    for bq in (1, 16, 64, 65, 128, 512):
        for bk in (1, 16, 17, 33, 64, 128, 1000):
            plan = launch_plan(1024, 1024, bq, bk, d=d, dtype=torch.float32)
            tq, tk = plan["q_tile"], plan["kv_tile"]
            assert tq == (64 if bq <= 64 or d == 256 else 128) and tk in (16, 32, 64)
            assert simt_smem_bytes(d, tq, tk) <= SIMT_SMEM_MAX
            want = 16
            while want < min(bk, 64):
                want *= 2
            assert tk == want or simt_smem_bytes(d, tq, 2 * tk) > SIMT_SMEM_MAX
