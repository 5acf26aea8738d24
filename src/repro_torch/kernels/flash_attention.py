"""Flash attention — the model's prefill attention, written by hand for Hopper.

:func:`flash_attention` launches the CUDA kernel in
``csrc/flash_attention.cu`` (see the note there: what it replaces, what
bounds it on the card and what a row with no visible key gets).
:func:`flash_attention_plain` is the same function in plain torch ops, the
TPU kernel's blocked online softmax over kv blocks of ``bk``; the wrapper
takes it only for CPU tensors.

Two routes, by (dtype, D) alone (:func:`launch_plan`): bf16 at D = 64 and
128 (the models' head dims) runs on the tensor cores ("wgmma": wgmma for
q·kᵀ and p·v, p rounded to bf16, K/V in a two-stage cp.async ring); f32 at
every D and bf16 at D = 8, 16, 32 run the SIMT kernel ("simt"), since TF32
products would miss the f32 limit of 3e-5.  The ``(bq, bk)`` block, clamped
to (S, T), maps onto the CTA tile:

* "wgmma": q tile 64 if bq <= 64 else 128 (one or two warpgroups of 64
  rows), kv tile the power of two >= bk in [16, 4096 / D]: at most 64 keys
  at D = 64 and 32 at D = 128, the largest tiles that keep a thread within
  ~128 registers, so that two CTAs fit an SM (the note in the source has
  the measurements);
* "simt": q tile 64 if bq <= 64 else 128 (256 threads, each with 4 or 8 q
  rows of both products), kv tile the power of two >= bk in [16, 64], halved
  while Q, two (K, V) ring stages and P would take more than
  :data:`SIMT_SMEM_MAX` bytes of shared memory (:func:`simt_smem_bytes`):
  128 × 32 at D = 128 for the default block.

On both, ``bk`` also sets ``T_pad = ⌈T/bk⌉·bk``, what a row with no visible
key is divided by.

q is ``(B, S, H, D)``, k and v ``(B, T, HKV, D)`` with ``H % HKV == 0``
(grouped-query heads); the output is ``(B, S, H, D)`` in q's dtype.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (8, 16, 32, 64, 128)  # the JAX kernel tests', musicgen-large's, jamba's
TC_HEAD_DIMS = (64, 128)  # bf16 at these runs on the tensor cores
TC_KV_CAP = 4096  # the tensor-core kv tile is at most TC_KV_CAP // D keys
SIMT_SMEM_MAX = 232448  # shared memory a CTA can have on the card


def simt_smem_bytes(d: int, q_tile: int, kv_tile: int) -> int:
    """Shared memory of a SIMT CTA: Q, two stages of K and V (rows padded by 4
    floats) and P transposed, all f32 (``csrc/flash_attention.cu``)."""
    return 4 * (q_tile * (d + 4) + 4 * kv_tile * (d + 4) + kv_tile * (q_tile + 4))


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.looptune_flash_attention.argtypes = (
        [p, p, p, p] + [i] * 6 + [ll] * 9 + [i, i, f, f, i, i, i, i, p])
    lib.looptune_flash_attention.restype = i
    lib.looptune_flash_attention_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)]
    lib.looptune_flash_attention_plan.restype = i


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _declare)


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
    if min(b, s, t, hq, hkv) < 1 or hq % hkv:
        raise ValueError(f"need non-empty shapes and H ({hq}) a multiple of HKV ({hkv})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one the kernel takes {HEAD_DIMS}")
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
                          bk: int = 128) -> torch.Tensor:
    """The kernel's function in plain torch ops, computed as the TPU kernel
    computes it: f32 q pre-scaled by 1/sqrt(D), kv blocks of ``bk`` (clamped
    to T) zero-padded at the end, scores masked to -1e30, running max/sum
    and an f32 accumulator, ``l`` clamped to 1e-30.  q blocks change no
    value, so every q row is taken at once; ``bq`` is only checked."""
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
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) [softcapped, masked]) v at block ``(bq, bk)``.

    A CUDA tensor always launches the kernel, on the current stream and
    without synchronising; a CPU tensor runs :func:`flash_attention_plain`.
    Shapes, dtypes and head dims the kernel does not take raise on both.
    """
    b, s, t, hq, hkv, d = _check(q, k, v, bq, bk, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, bq=bq, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    if not (q.stride(3) == k.stride(3) == v.stride(3) == 1):
        raise ValueError("flash_attention needs the head dim contiguous")
    if launch_plan(s, t, bq, bk, d=d, dtype=q.dtype)["route"] == "wgmma":
        check_aligned(q, k, v)
    # a window beyond S + T masks nothing more or less: clamp it into an int
    w = 0 if window is None else max(-(s + t), min(int(window), s + t))
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().looptune_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, hq,
            hkv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], min(bq, s), min(bk, t),
            1.0 / math.sqrt(d), float(softcap or 0.0), int(causal),
            int(window is not None), w,
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: cudaError {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"block {(bq, bk)})")
    flash_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0 (the CPU path and the
#: plain version do not count)
flash_attention.launches = 0


def launch_plan(s: int, t: int, bq: int = 128, bk: int = 128, *, d: int,
                dtype: torch.dtype) -> dict:
    """The CTA tile a launch uses for block ``(bq, bk)`` at head dim ``d``
    and ``dtype``, its route, and the padded kv length that a row with no
    visible key is divided by.  Pure Python; the kernel computes the same
    (``looptune_flash_attention_plan``, held equal on the card)."""
    if min(s, t, bq, bk) < 1:
        raise ValueError(f"bad plan arguments {(s, t, bq, bk)}")
    bq, bk = min(bq, s), min(bk, t)
    t_pad = -(-t // bk) * bk
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        kv_tile = 16
        while kv_tile < min(bk, TC_KV_CAP // d):
            kv_tile *= 2
        return {"route": "wgmma", "q_tile": 64 if bq <= 64 else 128, "kv_tile": kv_tile,
                "t_pad": t_pad}
    q_tile, kv_tile = (64 if bq <= 64 else 128), 16
    while kv_tile < min(bk, 64):
        kv_tile *= 2
    while kv_tile > 16 and simt_smem_bytes(d, q_tile, kv_tile) > SIMT_SMEM_MAX:
        kv_tile //= 2
    return {"route": "simt", "q_tile": q_tile, "kv_tile": kv_tile, "t_pad": t_pad}


def kernel_plan(s: int, t: int, bq: int = 128, bk: int = 128, *, d: int,
                dtype: torch.dtype) -> dict:
    """The plan as the built kernel computes it (needs the library)."""
    out = (ctypes.c_int * 4)()
    if _lib().looptune_flash_attention_plan(s, t, bq, bk, d,
                                            int(dtype == torch.bfloat16), out) != 0:
        raise ValueError(f"bad plan arguments {(s, t, bq, bk)}")
    return {"route": "wgmma" if out[3] else "simt", "q_tile": out[0], "kv_tile": out[1],
            "t_pad": out[2]}


def check_aligned(*tensors: torch.Tensor) -> None:
    """The tensor-core route loads rows in 16-byte pieces: every base must be
    16-byte aligned and every (b, s, h) stride a multiple of 8 elements.  A
    view that is not raises; the wrapper makes no copy."""
    for x in tensors:
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(f"the tensor-core flash kernel needs 16-byte aligned rows: "
                             f"a view at offset {x.data_ptr() % 16} bytes with strides "
                             f"{tuple(x.stride())} cannot be loaded")
