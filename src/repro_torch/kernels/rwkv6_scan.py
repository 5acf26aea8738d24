"""RWKV-6 chunked scan — the Finch time-mix recurrence, written by hand for Hopper.

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

:func:`rwkv6_chunk_scan` launches the CUDA kernel in ``csrc/rwkv6_scan.cu``
(see the note there: what it replaces, what bounds it on the card and how
its two passes split the work: the chunks' own products in parallel, then a
walk of the state over the chunks).  :func:`rwkv6_chunk_scan_plain` is the
same function in plain torch ops, the TPU kernel's chunk loop batched over
streams with each chunk taken in sub-chunks of 16 positions, so that no
decay is the exponential of a positive number; the wrapper takes it only for
CPU tensors.

The wrapper takes the model's layout: r, k, v and logw ``(B, S, H, N)``
with the head dim contiguous (the ``(B, S, D)`` projections viewed as heads,
read through their strides), u ``(H, N)`` and an optional carried state s0
``(B, H, N, N)`` f32, which starts at zero when not given, as the TPU
kernel's does.  It returns y ``(B, S, H, N)`` f32 and the final state
``(B, H, N, N)`` f32.  The plain version keeps the JAX kernel's signature:
``(BH, S, N)`` streams and u ``(BH, N)``.

The gradient: :class:`RWKV6Scan` is the scan under autograd.  Its forward
is the kernel (the plain version on CPU tensors), saving the inputs; its
backward recomputes :func:`rwkv6_chunk_scan_plain` at the same tile under
``torch.enable_grad()`` and returns that recomputation's input gradients.
That is what the JAX package differentiates: its model's ``lax.scan`` chunk
loop under ``jax.checkpoint`` (``repro/models/rwkv6.py``), never the Pallas
kernel.  A backward kernel for the scan is later work (ROADMAP.md, queue
B).  :func:`rwkv6_chunk_scan` goes through it whenever grad is enabled and
an input requires grad.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

MAX_CHUNK = 128  # the kernel's chunk tile (csrc/rwkv6_scan.cu kMaxL)
SUB = 16  # sub-chunk rows whose decays are taken pair by pair (kSub)
SLICE_COLS = 32  # state columns a pass-2 CTA carries (kSliceCols)
HEAD_DIMS = (4, 8, 16, 32, 64)  # the JAX kernel tests' and rwkv6-7b's
_DTYPES = (torch.float32, torch.bfloat16)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.looptune_rwkv6_scan.argtypes = [p] * 9 + [i] * 5 + [ll] * 12 + [i, p]
    lib.looptune_rwkv6_scan.restype = i


def _lib() -> ctypes.CDLL:
    return _build.load("rwkv6_scan", _declare)


def launch_plan(s: int, chunk: int = 64, *, b: int = 1, h: int = 1, n: int = 64,
                dtype: torch.dtype = torch.float32) -> dict:
    """How a launch over ``b * h`` streams of ``s`` tokens at head dim ``n``,
    r/k/v of ``dtype``, is laid out.  Pure Python; the kernel computes the
    same.

    ``chunk``: the tile, the requested chunk clamped to ``s`` (as the TPU
    wrapper clamps it) and to :data:`MAX_CHUNK`; ``n_chunks``.  Pass 1 runs
    ``pass1_ctas`` = one CTA per (stream, chunk); pass 2 ``pass2_ctas`` = one
    per (stream, slice of ``slice_cols`` state columns).  ``scratch_bytes``:
    what pass 1 leaves for pass 2, the chunks' state increments and decays
    and r_dec (B, S, H, N) f32, which the wrapper allocates; ``smem_bytes``:
    each pass's dynamic shared memory."""
    if min(s, chunk, b, h, n) < 1:
        raise ValueError(f"need s, chunk, b, h, n >= 1, got {(s, chunk, b, h, n)}")
    tile = min(chunk, s, MAX_CHUNK)
    n_chunks = -(-s // tile)
    rows = SUB * -(-tile // SUB)  # the tile's rows, in whole 16-row sub-chunks
    cols = min(n, SLICE_COLS)
    # pass 1: r~, k^, v and cum, the sub-chunks' A, two state buffers, the
    # sums at sub-chunk starts, the short vectors, and bf16 r and k as
    # staged; pass 2: r_dec, the state's and the increment's slices, the
    # decay, y's slice
    pass1 = (4 * rows * (n + 4) + rows * SUB + 2 * n * (n + 4) + (MAX_CHUNK // SUB + 1) * n
             + rows + n + (rows * (n + 8) if dtype == torch.bfloat16 else 0))
    pass2 = rows * (n + 4) + 2 * n * (cols + 4) + n + rows * (cols + 4)
    return {"chunk": tile, "n_chunks": n_chunks, "pass1_ctas": b * h * n_chunks,
            "pass2_ctas": b * h * (n // cols), "slice_cols": cols,
            "scratch_bytes": 4 * (b * h * n_chunks * (n * n + n) + b * s * h * n),
            "smem_bytes": (4 * pass1, 4 * pass2)}


def rwkv6_chunk_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           logw: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                           s0: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch ops: r, k, v, logw ``(BH, S, N)``
    widened to f32, u ``(BH, N)``, chunks of ``min(chunk, S)`` with the tail
    zero-padded and masked (k = 0, logw = 0), and within each chunk
    sub-chunks of :data:`SUB` positions.  For sub-chunk I of a chunk, with
    c and c' the inclusive and exclusive sums of logw within the sub-chunk
    and G the chunk's sum before it::

        y_t = (r_t e^{G + c'_t}) S + (r_t e^{c'_t}) D
              + sum_{s < t in I} (sum_n r_tn k_sn e^{c'_tn - c_sn}) v_s
              + (sum_n r_tn u_n k_tn) v_t
        D  <- diag(e^{c_last}) D + (k e^{c_last - c})^T v

    where S is the state at the chunk's start and D the chunk's own state
    from zero; then S <- diag(e^{G_end}) S + D.  Every exponent is a sum of
    logw <= 0, so nothing overflows however fast the decay (the TPU
    kernel's k e^{-cum} leaves f32 once a chunk sums past about -88).
    ``s0 (BH, N, N)``: the state to start from (zeros when None).  Returns
    (y (BH, S, N) f32, final state (BH, N, N) f32)."""
    bh, s, n = r.shape
    chunk = min(chunk, s)
    pad = -s % chunk
    r, k, v, lw = (t.float() for t in (r, k, v, logw))
    if pad:
        r, k, v, lw = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (r, k, v, lw))
    valid = (torch.arange(s + pad, device=r.device) < s)[None, :, None]
    k = torch.where(valid, k, 0.0)
    lw = torch.where(valid, lw, 0.0)
    u = u.float()[:, None, :]
    state = (torch.zeros(bh, n, n, dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    ys = []
    for c0 in range(0, s + pad, chunk):
        g = torch.zeros(bh, 1, n, dtype=torch.float32, device=r.device)
        d = torch.zeros(bh, n, n, dtype=torch.float32, device=r.device)
        for i0 in range(c0, c0 + chunk, SUB):
            rb, kb, vb, wb = (t[:, i0:min(i0 + SUB, c0 + chunk)] for t in (r, k, v, lw))
            rows = rb.shape[1]
            cum = torch.cumsum(wb, dim=1)                            # inclusive
            cum_ex = torch.nn.functional.pad(cum, (0, 0, 1, 0))[:, :-1]  # the row before's
            strict = torch.ones(rows, rows, dtype=torch.bool, device=r.device).tril(-1)
            expo = (cum_ex[:, :, None] - cum[:, None]).masked_fill(~strict[..., None],
                                                                   float("-inf"))
            att = (rb[:, :, None] * kb[:, None] * torch.exp(expo)).sum(-1)  # (BH, T, T)
            diag = (rb * (u * kb)).sum(-1)                           # u-bonus, t == s
            ys.append((rb * torch.exp(g + cum_ex)) @ state + (rb * torch.exp(cum_ex)) @ d
                      + att @ vb + diag[..., None] * vb)
            last = cum[:, -1:]
            d = (d * torch.exp(last[:, 0])[..., None]
                 + (kb * torch.exp(last - cum)).transpose(1, 2) @ vb)
            g = g + last
        state = state * torch.exp(g[:, 0])[..., None] + d
    return torch.cat(ys, dim=1)[:, :s], state


def to_streams(x: torch.Tensor) -> torch.Tensor:
    """``(B, S, H, N)`` -> ``(B*H, S, N)``, the plain version's layout."""
    b, s, h, n = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, n)


def rwkv6_chunk_scan_plain_heads(r, k, v, logw, u, *, chunk: int,
                                 s0: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rwkv6_chunk_scan_plain` on the wrapper's layout (``(B, S, H,
    N)`` streams, u ``(H, N)``, s0 ``(B, H, N, N)``) at exactly ``chunk``:
    what the wrapper runs for CPU tensors at its tile, and what the kernel
    is held against on the card."""
    b, s, h, n = r.shape
    y, state = rwkv6_chunk_scan_plain(
        *(to_streams(t) for t in (r, k, v, logw)), u.repeat(b, 1), chunk=chunk,
        s0=None if s0 is None else s0.reshape(b * h, n, n))
    return (y.reshape(b, h, s, n).transpose(1, 2).contiguous(),
            state.reshape(b, h, n, n))


def _check(r, k, v, logw, u, s0) -> tuple:
    if r.dim() != 4:
        raise ValueError(f"rwkv6_chunk_scan takes (B, S, H, N) r, k, v, logw; "
                         f"got r {tuple(r.shape)}")
    b, s, h, n = r.shape
    if not (k.shape == v.shape == logw.shape == r.shape):
        raise ValueError(f"r, k, v, logw must share one shape; got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(logw.shape)}")
    if min(b, s, h) < 1:
        raise ValueError(f"need non-empty shapes, got {tuple(r.shape)}")
    if tuple(u.shape) != (h, n):
        raise ValueError(f"u must be (H, N) = {(h, n)}, got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (b, h, n, n):
        raise ValueError(f"s0 must be (B, H, N, N) = {(b, h, n, n)}, got "
                         f"{tuple(s0.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES:
        raise TypeError(f"r, k, v must all be float32 or all bfloat16; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32:
        raise TypeError(f"logw must be float32, got {logw.dtype}")
    if n not in HEAD_DIMS:
        raise ValueError(f"head dim {n} is not one the kernel takes {HEAD_DIMS}")
    devices = {t.device for t in (r, k, v, logw, u) + ((s0,) if s0 is not None else ())}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    return b, s, h, n


def rwkv6_chunk_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                     s0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked Finch scan over ``(B, S, H, N)`` streams at chunk tile
    :func:`launch_plan` ``(S, chunk)``.  Returns (y (B, S, H, N) f32, final
    state (B, H, N, N) f32).

    A CUDA tensor always launches the kernel, on the current stream and
    without synchronising; a CPU tensor runs :func:`rwkv6_chunk_scan_plain`
    at the same tile.  Under grad the call goes through :class:`RWKV6Scan`.  Shapes, dtypes and head dims the kernel does not take
    raise on both.
    """
    b, s, h, n = _check(r, k, v, logw, u, s0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (r, k, v, logw, u, s0)):
        return RWKV6Scan.apply(r, k, v, logw, u, s0, chunk)
    plan = launch_plan(s, chunk, b=b, h=h, n=n, dtype=r.dtype)
    tile = plan["chunk"]
    if r.device.type == "cpu":
        return rwkv6_chunk_scan_plain_heads(r, k, v, logw, u, chunk=tile, s0=s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_chunk_scan runs on cuda or cpu tensors, got {r.device}")
    if not all(t.stride(3) == 1 for t in (r, k, v, logw)):
        raise ValueError("rwkv6_chunk_scan needs the head dim contiguous")
    if r.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 4 == 0 and all(st % 2 == 0 for st in t.stride()[:3])
            for t in (r, k, v)):
        raise ValueError("rwkv6_chunk_scan stages bf16 rows in 4-byte pieces: r, k and v "
                         "must start on 4-byte boundaries")
    u32 = u.float().contiguous()
    s0c = None if s0 is None else s0.float().contiguous()
    y = torch.empty((b, s, h, n), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    scratch = torch.empty(plan["scratch_bytes"] // 4, dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = _lib().looptune_rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u32.data_ptr(),
            None if s0c is None else s0c.data_ptr(), y.data_ptr(), state.data_ptr(),
            scratch.data_ptr(), b, s, h, n, tile, *r.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *logw.stride()[:3], int(r.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6 scan launch failed: cudaError {err} "
                           f"(r {tuple(r.shape)}, chunk {tile})")
    rwkv6_chunk_scan.launches += 1
    return y, state


#: wrapper calls that launched the kernel (each launches pass 1 and pass 2)
#: since the count was last set to 0; the CPU path and the plain version do
#: not count
rwkv6_chunk_scan.launches = 0


class RWKV6Scan(torch.autograd.Function):
    """The scan under autograd: forward :func:`rwkv6_chunk_scan` (the kernel
    on CUDA tensors), backward the input gradients of
    :func:`rwkv6_chunk_scan_plain_heads` recomputed at the same tile."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, chunk):
        y, state = rwkv6_chunk_scan(r, k, v, logw, u, chunk=chunk, s0=s0)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        ctx.tile = launch_plan(r.shape[1], chunk, n=r.shape[3])["chunk"]
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, state = rwkv6_chunk_scan_plain_heads(*inputs[:5], chunk=ctx.tile, s0=inputs[5])
            wrt = [t for t, need in zip(inputs, ctx.needs_input_grad) if t is not None and need]
            grads = iter(torch.autograd.grad((y, state), wrt, (dy, dstate), allow_unused=True))
        return tuple(next(grads) if t is not None and need else None
                     for t, need in zip(inputs, ctx.needs_input_grad)) + (None,)
