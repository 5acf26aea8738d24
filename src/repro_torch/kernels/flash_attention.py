"""Flash attention — the model's prefill attention, written by hand for Hopper.

:func:`flash_attention` launches the CUDA kernel in
``csrc/flash_attention.cu`` (see the note there: what it replaces, what
bounds it on the card and what a row with no visible key gets).
:func:`flash_attention_plain` is the same function in plain torch ops, the
TPU kernel's blocked online softmax over kv blocks of ``bk``; the wrapper
takes it only for CPU tensors.

The kernel has instances at the head dims in :data:`HEAD_DIMS` (the JAX
kernel tests' 8-32 and the model zoo's 64, 96, 128 and 256); the plain
version takes any D, as the TPU kernel does, and only a launch refuses a D
the kernel lacks.  Two routes, by (dtype, D) alone (:func:`launch_plan`):
bf16 at D = 64, 96, 128 and 256 (the models' head dims) runs on the tensor
cores ("wgmma": wgmma for q·kᵀ and p·v, p rounded to bf16); f32 at every D
and bf16 at D = 8, 16, 32 run the SIMT kernel ("simt"), since TF32 products
would miss the f32 limit of 3e-5.  The "wgmma" route has two kernels, which
the plan names (``"kernel"``): ``flash_fwd_tc`` at D = 64 and 128 (K/V in a
two-stage cp.async ring) and ``flash_fwd_ws`` at D = 96 and 256
(:data:`WS_HEAD_DIMS`: warp-specialised, a producer warpgroup loading by TMA
into an mbarrier ring, two consumer warpgroups, D = 96 at its own width).
The ``(bq, bk)`` block, clamped to (S, T), maps onto the CTA tile:

* "wgmma", ``flash_fwd_tc``: q tile 64 if bq <= 64 else 128 (one or two
  warpgroups of 64 rows), kv tile the power of two >= bk in
  [16, 4096 / D]: at most 64 keys at D = 64 and 32 at D = 128, the largest
  tiles that keep a thread within ~128 registers, so that two CTAs fit an
  SM (the note in the source has the measurements);
* "wgmma", ``flash_fwd_ws``: q tile 128 whatever bq (two consumer
  warpgroups), kv tile 64 at D = 256, and at D = 96 64 for bk <= 64, else
  128 (:func:`ws_kv_tile`); the K/V ring has as many stages as fit the
  card's shared memory beside Q, at most 4 (:func:`ws_smem_bytes`);
* "simt": q tile 64 if bq <= 64 else 128, and 64 at D = 256, where a
  128-row tile spills (256 threads, each with 4 or 8 q rows of both
  products), kv tile the power of two >= bk in [16, 64], halved while Q,
  two (K, V) ring stages and P would take more than :data:`SIMT_SMEM_MAX`
  bytes of shared memory (:func:`simt_smem_bytes`): 128 × 32 at D = 128
  and 64 × 32 at D = 256 for the default block.

On both, ``bk`` also sets ``T_pad = ⌈T/bk⌉·bk``, what a row with no visible
key is divided by.

q is ``(B, S, H, D)``, k and v ``(B, T, HKV, D)`` with ``H % HKV == 0``
(grouped-query heads); the output is ``(B, S, H, D)`` in q's dtype, and with
``return_lse`` each row's log-sum-exp ``(B, H, S)`` f32 beside it.

The gradient: :func:`flash_attention_bwd` launches the backward kernel in
``csrc/flash_attention_bwd.cu`` (two launches: dk/dv a kv tile, dq a q tile;
see the note there) at the head dims in :data:`BWD_HEAD_DIMS`, every forward
instance's, on two routes by (dtype, D) alone (:func:`bwd_launch_plan`): bf16
at D = 64, 96, 128 and 256 runs on the tensor cores ("wgmma": every product
on wgmma, P and dS rounded to bf16, the q-side or kv-side tiles in a
two-stage cp.async ring, D = 96 staged as 128 zero-padded columns, and at D
= 256 the dk/dv CTA's two warpgroups split by role, dV on one and dK on the
other); f32 at every D and bf16 at D = 8, 16, 32 run the SIMT kernels
("simt"; 32-row tiles at D = 256). It takes
:func:`flash_attention_bwd_plain`, the JAX model attention's hand-written
backward (``repro/models/layers.py::_flash_bwd``) in torch ops, for CPU
tensors.  :class:`FlashAttention` ties the two into autograd: its forward is
the forward kernel, saving q, k, v, out and lse, its backward the backward
kernel.  ``kernels.ops.flash_attention`` goes through it whenever grad is
enabled and an input requires grad, so that no wrapper returns a result
without a ``grad_fn`` under grad.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (8, 16, 32, 64, 96, 128, 256)  # the kernel's instances: the JAX tests', the zoo's
BWD_HEAD_DIMS = HEAD_DIMS  # the backward kernel's: every forward instance has one
#: the backward's "wgmma" tiles by head dim, as ``kTcTiles`` in the source:
#: (64-key groups of a dk/dv CTA, its q tile, warpgroups of a dq CTA, its kv
#: tile).  At D = 256 the dk/dv CTA's one group of 64 keys has two warpgroups,
#: one for dV and one for dK.
BWD_TC_TILES = {64: (1, 32, 1, 32), 96: (1, 32, 1, 32), 128: (1, 32, 1, 32),
                256: (1, 32, 1, 16)}
BWD_TC_HEAD_DIMS = tuple(BWD_TC_TILES)  # bf16 backward at these runs on the tensor cores
TC_HEAD_DIMS = (64, 96, 128, 256)  # bf16 at these runs on the tensor cores
WS_HEAD_DIMS = (96, 256)  # ... by flash_fwd_ws; the others by flash_fwd_tc
TC_KV_CAP = 4096  # flash_fwd_tc's kv tile is at most TC_KV_CAP // tc_width(D) keys
SIMT_SMEM_MAX = 232448  # shared memory a CTA can have on the card
WS_Q_TILE = 128  # flash_fwd_ws: two consumer warpgroups of 64 q rows
WS_STAGES_MAX = 4
WS_BARRIERS = 1 + 6 * WS_STAGES_MAX  # the most mbarriers (8 bytes each) it reserves room for


def tc_width(d: int) -> int:
    """The head dim as ``flash_fwd_tc`` stages it (D = 64 and 128): whole
    64-column swizzle chunks."""
    return -(-d // 64) * 64


def ws_kv_tile(d: int, bk: int) -> int:
    """``flash_fwd_ws``'s kv tile for the block's (clamped) ``bk``: 64 keys
    at D = 256; at D = 96, 64 for bk <= 64, else 128."""
    return 64 if d == 256 or bk <= 64 else 128


def ws_stages(d: int, kv_tile: int) -> int:
    """``flash_fwd_ws``'s K/V ring stages: as many as fit the card's shared
    memory beside the alignment slack, Q and the barriers, at most 4."""
    room = SIMT_SMEM_MAX - 1024 - 8 * WS_BARRIERS - WS_Q_TILE * d * 2
    return min(WS_STAGES_MAX, room // (4 * kv_tile * d))


def ws_smem_bytes(d: int, kv_tile: int) -> int:
    """Shared memory of a ``flash_fwd_ws`` CTA: 1024 bytes of alignment
    slack, Q (128 rows), the stages of K and V, and the mbarriers (Q's, and
    full K, full V and each consumer's empty K and V a stage), as
    ``ws_smem_bytes`` in the source."""
    st = ws_stages(d, kv_tile)
    return 1024 + WS_Q_TILE * d * 2 + st * 4 * kv_tile * d + 8 * (1 + 6 * st)


def simt_smem_bytes(d: int, q_tile: int, kv_tile: int) -> int:
    """Shared memory of a SIMT CTA: Q, two stages of K and V (rows padded by 4
    floats) and P transposed, all f32 (``csrc/flash_attention.cu``)."""
    return 4 * (q_tile * (d + 4) + 4 * kv_tile * (d + 4) + kv_tile * (q_tile + 4))


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.looptune_flash_attention.argtypes = (
        [p, p, p, p, p] + [i] * 6 + [ll] * 9 + [i, i, f, f, i, i, i, i, p])
    lib.looptune_flash_attention.restype = i
    lib.looptune_flash_attention_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)]
    lib.looptune_flash_attention_plan.restype = i


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _declare)


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.looptune_flash_attention_bwd.argtypes = (
        [p] * 10 + [i] * 6 + [ll] * 12 + [f, f, i, i, i, i, p])
    lib.looptune_flash_attention_bwd.restype = i
    lib.looptune_flash_attention_bwd_plan.argtypes = [i] * 4 + [ctypes.POINTER(i)]
    lib.looptune_flash_attention_bwd_plan.restype = i


def _lib_bwd() -> ctypes.CDLL:
    return _build.load("flash_attention_bwd", _declare_bwd)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int, bk: int,
           softcap: Optional[float]) -> tuple:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes (B, S, H, D) q and (B, T, HKV, D) "
                         f"k, v; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (B={b}, T, HKV, D={d}) alike; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    t, hkv = k.shape[1], k.shape[2]
    if min(b, s, t, hq, hkv, d) < 1 or hq % hkv:
        raise ValueError(f"need non-empty shapes and H ({hq}) a multiple of HKV ({hkv})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if min(bq, bk) < 1:
        raise ValueError(f"blocks must be >= 1, got {(bq, bk)}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    return b, s, t, hq, hkv, d


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None, bq: int = 128,
                          bk: int = 128, return_lse: bool = False):
    """The kernel's function in plain torch ops, computed as the TPU kernel
    computes it: f32 q pre-scaled by 1/sqrt(D), kv blocks of ``bk`` (clamped
    to T) zero-padded at the end, scores masked to -1e30, running max/sum
    and an f32 accumulator, ``l`` clamped to 1e-30.  q blocks change no
    value, so every q row is taken at once; ``bq`` is only checked.  With
    ``return_lse``, also each row's ``m + log(max(l, 1e-30))`` ``(B, H, S)``
    f32, as the JAX model attention's forward returns it."""
    b, s, t, hq, hkv, d = _check(q, k, v, bq, bk, softcap)
    g = hq // hkv
    bk = min(bk, t)
    n_kv = -(-t // bk)
    pad = n_kv * bk - t
    qf = q.float().transpose(1, 2) * (1.0 / math.sqrt(d))              # (B, H, S, D)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)          # (B, H, T, D)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    q_pos = torch.arange(s, device=q.device)[:, None]
    acc = torch.zeros(b, hq, s, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, hq, s, dtype=torch.float32, device=q.device)
    for j in range(n_kv):
        kb, vb = kf[:, :, j * bk:(j + 1) * bk], vf[:, :, j * bk:(j + 1) * bk]
        sc = qf @ kb.transpose(-1, -2)                                  # (B, H, S, bk)
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        kv_pos = j * bk + torch.arange(bk, device=q.device)[None, :]
        mask = kv_pos < t
        if causal:
            mask = mask & (kv_pos <= q_pos)
        if window is not None:
            mask = mask & (kv_pos > q_pos - window)
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vb
        m = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l[..., None]).transpose(1, 2).to(q.dtype).contiguous()
    return (out, m + torch.log(l)) if return_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, bq: int = 128,
                    bk: int = 128, return_lse: bool = False):
    """softmax(q k^T / sqrt(D) [softcapped, masked]) v at block ``(bq, bk)``;
    with ``return_lse``, (out, lse (B, H, S) f32).

    A CUDA tensor always launches the kernel, on the current stream and
    without synchronising; a CPU tensor runs :func:`flash_attention_plain`.
    With grad enabled and an input that requires grad, the call goes
    through :class:`FlashAttention`, whose forward is this call without
    grad.  Shapes and dtypes the kernel does not take raise on both; a head dim
    without a kernel instance (not in :data:`HEAD_DIMS`) raises on CUDA
    tensors only, since the plain version takes any D.
    """
    b, s, t, hq, hkv, d = _check(q, k, v, bq, bk, softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if return_lse:
            raise ValueError("return_lse is the autograd forward's: call it without grad")
        return FlashAttention.apply(q, k, v, causal, window, softcap, bq, bk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, bq=bq, bk=bk, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    if not (q.stride(3) == k.stride(3) == v.stride(3) == 1):
        raise ValueError("flash_attention needs the head dim contiguous")
    if launch_plan(s, t, bq, bk, d=d, dtype=q.dtype)["route"] == "wgmma":
        check_aligned(q, k, v)
    # a window beyond S + T masks nothing more or less: clamp it into an int
    w = 0 if window is None else max(-(s + t), min(int(window), s + t))
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().looptune_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, t, hq,
            hkv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], min(bq, s), min(bk, t),
            1.0 / math.sqrt(d), float(softcap or 0.0), int(causal),
            int(window is not None), w,
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: cudaError {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"block {(bq, bk)})")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


#: kernel launches since the count was last set to 0 (the CPU path and the
#: plain version do not count)
flash_attention.launches = 0


def launch_plan(s: int, t: int, bq: int = 128, bk: int = 128, *, d: int,
                dtype: torch.dtype) -> dict:
    """The CTA tile a launch uses for block ``(bq, bk)`` at head dim ``d``
    and ``dtype``, its route and kernel, and the padded kv length that a row
    with no visible key is divided by.  A head dim the kernel has no
    instance for raises.  Pure Python; the kernel computes the same
    (``looptune_flash_attention_plan``, held equal on the card)."""
    if min(s, t, bq, bk) < 1:
        raise ValueError(f"bad plan arguments {(s, t, bq, bk)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the flash kernel has instances at {HEAD_DIMS} "
                         f"only")
    bq, bk = min(bq, s), min(bk, t)
    t_pad = -(-t // bk) * bk
    if dtype == torch.bfloat16 and d in WS_HEAD_DIMS:
        return {"route": "wgmma", "kernel": "flash_fwd_ws", "q_tile": WS_Q_TILE,
                "kv_tile": ws_kv_tile(d, bk), "t_pad": t_pad}
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        kv_tile = 16
        while kv_tile < min(bk, TC_KV_CAP // tc_width(d)):
            kv_tile *= 2
        return {"route": "wgmma", "kernel": "flash_fwd_tc", "q_tile": 64 if bq <= 64 else 128,
                "kv_tile": kv_tile, "t_pad": t_pad}
    q_tile, kv_tile = (64 if bq <= 64 or d > 128 else 128), 16
    while kv_tile < min(bk, 64):
        kv_tile *= 2
    while kv_tile > 16 and simt_smem_bytes(d, q_tile, kv_tile) > SIMT_SMEM_MAX:
        kv_tile //= 2
    return {"route": "simt", "kernel": "flash_fwd_simt", "q_tile": q_tile, "kv_tile": kv_tile,
            "t_pad": t_pad}


def kernel_plan(s: int, t: int, bq: int = 128, bk: int = 128, *, d: int,
                dtype: torch.dtype) -> dict:
    """The plan as the built kernel computes it (needs the library).  A
    library that writes four entries (one built before ``flash_fwd_ws``)
    leaves the kernel entry 0: its route's first kernel."""
    out = (ctypes.c_int * 5)()
    if _lib().looptune_flash_attention_plan(s, t, bq, bk, d,
                                            int(dtype == torch.bfloat16), out) != 0:
        raise ValueError(f"bad plan arguments {(s, t, bq, bk)} at head_dim {d}")
    kernel = "flash_fwd_ws" if out[4] else "flash_fwd_tc" if out[3] else "flash_fwd_simt"
    return {"route": "wgmma" if out[3] else "simt", "kernel": kernel, "q_tile": out[0],
            "kv_tile": out[1], "t_pad": out[2]}


def check_aligned(*tensors: torch.Tensor) -> None:
    """The tensor-core route loads rows in 16-byte pieces (cp.async, or TMA,
    whose tensor maps take 16-byte aligned bases and strides): every base
    must be 16-byte aligned and every (b, s, h) stride a multiple of 8
    elements.  A view that is not raises; the wrapper makes no copy."""
    for x in tensors:
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(f"the tensor-core flash kernel needs 16-byte aligned rows: "
                             f"a view at offset {x.data_ptr() % 16} bytes with strides "
                             f"{tuple(x.stride())} cannot be loaded")


# ---------------------------------------------------------------------------
# The gradient
# ---------------------------------------------------------------------------


def _check_bwd(q, k, v, out, dout, lse, softcap) -> tuple:
    b, s, t, hq, hkv, d = _check(q, k, v, 1, 1, softcap)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be q's shape {tuple(q.shape)}; got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}")
    if tuple(lse.shape) != (b, hq, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, H, S) = {(b, hq, s)} float32; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    return b, s, t, hq, hkv, d


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True, window: Optional[int] = None,
                              softcap: Optional[float] = None, bk: int = 128) -> tuple:
    """The gradients (dq, dk, dv) of :func:`flash_attention_plain` in plain
    torch ops, computed as ``repro/models/layers.py::_flash_bwd`` computes
    them: q pre-scaled by 1/sqrt(D) in f32, delta = rowsum(dout . out), and
    per kv block of ``bk`` keys the scores recomputed, p = exp(sc - lse)
    (not masked: a row with no visible key has lse = -1e30 and gets p = 1),
    dv += p^T dout, ds = p (dout v^T - delta), times 1 - tanh^2 under a
    softcap, zero where masked, dq += ds k and dk += ds^T q.  dk and dv of a
    kv head sum over its group.  Outputs in the inputs' dtype."""
    b, s, t, hq, hkv, d = _check_bwd(q, k, v, out, dout, lse, softcap)
    g = hq // hkv
    bk = min(bk, t)
    scale = 1.0 / math.sqrt(d)
    qf = q.float().transpose(1, 2) * scale                                # (B, H, S, D)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)             # (B, H, T, D)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    do = dout.float().transpose(1, 2)
    delta = (do * out.float().transpose(1, 2)).sum(-1)                     # (B, H, S)
    q_pos = torch.arange(s, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j0 in range(0, t, bk):
        kb, vb = kf[:, :, j0:j0 + bk], vf[:, :, j0:j0 + bk]
        raw = qf @ kb.transpose(-1, -2)                                    # (B, H, S, bk)
        sc = raw if softcap is None else softcap * torch.tanh(raw / softcap)
        kv_pos = j0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        mask = torch.ones(s, kb.shape[2], dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kv_pos <= q_pos)
        if window is not None:
            mask = mask & (kv_pos > q_pos - window)
        sc = torch.where(mask, sc, NEG_INF)
        p = torch.exp(sc - lse[..., None])
        dvs.append(p.transpose(-1, -2) @ do)
        ds = p * (do @ vb.transpose(-1, -2) - delta[..., None])
        if softcap is not None:
            ds = ds * (1.0 - torch.square(torch.tanh(raw / softcap)))
        ds = torch.where(mask, ds, 0.0)
        dq = dq + ds @ kb
        dks.append(ds.transpose(-1, -2) @ qf)
    dk = torch.cat(dks, dim=2).reshape(b, hkv, g, t, d).sum(2)
    dv = torch.cat(dvs, dim=2).reshape(b, hkv, g, t, d).sum(2)
    return ((dq * scale).transpose(1, 2).to(q.dtype).contiguous(),
            dk.transpose(1, 2).to(k.dtype).contiguous(),
            dv.transpose(1, 2).to(v.dtype).contiguous())


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, bk: int = 128) -> tuple:
    """(dq, dk, dv) of flash attention from the forward's ``out`` and
    ``lse`` and the output gradient ``dout``.

    A CUDA tensor launches the backward kernel, on the current stream and
    without synchronising (delta = rowsum(dout . out) in torch ops first on
    the "simt" route; on "wgmma" the dq kernel computes it); a CPU tensor
    runs :func:`flash_attention_bwd_plain`.  A head dim
    without a backward instance (not in :data:`BWD_HEAD_DIMS`, the forward's
    :data:`HEAD_DIMS`) raises on CUDA tensors only.  ``bk`` is the plain
    version's kv block."""
    b, s, t, hq, hkv, d = _check_bwd(q, k, v, out, dout, lse, softcap)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=causal,
                                         window=window, softcap=softcap, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, got {q.device}")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the flash backward kernel has instances at "
                         f"{BWD_HEAD_DIMS} only")
    if dout.dtype != q.dtype or out.dtype != q.dtype:
        raise TypeError(f"out and dout must be {q.dtype}; got {out.dtype}, {dout.dtype}")
    if not (q.stride(3) == k.stride(3) == v.stride(3) == 1):
        raise ValueError("flash_attention_bwd needs the head dim contiguous")
    dout, out, lse = dout.contiguous(), out.contiguous(), lse.contiguous()
    if bwd_launch_plan(s, t, d=d, dtype=q.dtype)["route"] == "wgmma":
        check_aligned(q, k, v, dout, out)
        delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)  # the kernel's
    else:
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()  # (B, H, S)
    dq = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, t, hkv, d), dtype=q.dtype, device=q.device)
    w = 0 if window is None else max(-(s + t), min(int(window), s + t))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib_bwd().looptune_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), out.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, t, hq, hkv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3],
            1.0 / math.sqrt(d), float(softcap or 0.0), int(causal), int(window is not None),
            w, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: cudaError {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


#: wrapper calls that launched the backward kernels (each launches dk/dv and
#: dq) since the count was last set to 0; the CPU path does not count
flash_attention_bwd.launches = 0


def bwd_launch_plan(s: int, t: int, *, d: int, dtype: torch.dtype) -> dict:
    """The backward's route and tiles at (S, T), head dim ``d`` and ``dtype``:
    keys of a dk/dv CTA and its q tile, q rows of a dq CTA and its kv tile.
    On "wgmma" a CTA has the table's groups of 64 rows, or one where T
    (dk/dv) or S (dq) fits 64 rows; "simt" runs 64 x 64 tiles, 32 x 32 at
    D = 256 (four 64-row f32 tiles would not fit the card's shared memory).
    A head dim without a backward instance raises.  Pure Python;
    the kernel computes the same (``looptune_flash_attention_bwd_plan``,
    held equal on the card)."""
    if min(s, t) < 1:
        raise ValueError(f"bad plan arguments {(s, t)}")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the flash backward kernel has instances at "
                         f"{BWD_HEAD_DIMS} only")
    if dtype == torch.bfloat16 and d in BWD_TC_HEAD_DIMS:
        wk, nq, wq, tk = BWD_TC_TILES[d]
        return {"route": "wgmma", "dkdv_kv_rows": 64 if t <= 64 else 64 * wk,
                "dkdv_q_tile": nq, "dq_q_rows": 64 if s <= 64 else 64 * wq, "dq_kv_tile": tk}
    tile = 32 if d > 128 else 64  # the source's simt_tile
    return {"route": "simt", "dkdv_kv_rows": tile, "dkdv_q_tile": tile, "dq_q_rows": tile,
            "dq_kv_tile": tile}


def kernel_bwd_plan(s: int, t: int, *, d: int, dtype: torch.dtype) -> dict:
    """The backward plan as the built kernel computes it (needs the library)."""
    out = (ctypes.c_int * 5)()
    if _lib_bwd().looptune_flash_attention_bwd_plan(s, t, d, int(dtype == torch.bfloat16),
                                                    out) != 0:
        raise ValueError(f"bad plan arguments {(s, t)} at head_dim {d}")
    return {"route": "wgmma" if out[0] else "simt", "dkdv_kv_rows": out[1],
            "dkdv_q_tile": out[2], "dq_q_rows": out[3], "dq_kv_tile": out[4]}


class FlashAttention(torch.autograd.Function):
    """Flash attention under autograd: the forward is :func:`flash_attention`
    (the kernel on CUDA tensors), saving q, k, v, out and lse; the backward
    is :func:`flash_attention_bwd` (the backward kernel on CUDA tensors, the
    plain backward on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, bq, bk):
        out, lse = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                   bq=bq, bk=bk, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, bk=bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None
