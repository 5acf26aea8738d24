"""Mamba selective scan — the Jamba SSM recurrence, written by hand for Hopper.

    h_t = e^{dt_t a} h_{t-1} + (dt_t x_t) B_t,    y_t = C_t . h_t

:func:`mamba_scan` launches the CUDA kernel in ``csrc/mamba_scan.cu`` (see
the note there: what it replaces, what bounds it on the card and how the
``"mamba"`` registry block maps onto a CTA).  It takes the model's tensors:
x and dt ``(B, S, C)`` (the silu'd conv output and the step size rounded to
the activation dtype), a ``(C, N)`` f32 (``-exp(a_log)``), B_t and C_t
``(B, S, N)`` (views of the ``x_proj`` output, read through their strides)
and an optional carried state h0 ``(B, C, N)`` f32, which starts at zero
when not given, as the TPU kernel's does.  It returns y ``(B, S, C)`` f32
and the final state ``(B, C, N)`` f32; the D skip term, the gate and
``out_proj`` stay with the caller, as in the reference model.

:func:`mamba_scan_plain` is the same function in plain torch ops, with the
JAX kernel's signature ``(dtx, da, b, c)`` (plus ``h0``) and its chunked
``exp(-cum)`` arithmetic; :func:`mamba_scan_plain_model` forms ``dtx = dt x``
and ``da = dt a`` in f32 from the model's tensors and runs it.  The wrapper
takes the plain version only for CPU tensors.

The gradient: :class:`MambaScan` is the scan under autograd.  Its forward
is the kernel (the plain version on CPU tensors), saving the inputs; its
backward recomputes :func:`mamba_scan_plain_model` at the same token tile
under ``torch.enable_grad()`` and returns that recomputation's input
gradients.  That is what the JAX package differentiates: its model's
``lax.scan`` chunk loop under ``jax.checkpoint`` (``repro/models/mamba.py``),
never the Pallas kernel.  A backward kernel for the scan is later work
(ROADMAP.md, queue B).  :func:`mamba_scan` goes through it whenever grad is
enabled and an input requires grad.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

MAX_L = 64     # tokens staged per tile (csrc/mamba_scan.cu kMaxL)
MAX_CC = 128   # channels a CTA (kMaxCC)
LANES = 2      # threads a channel, each holding N / LANES states (kLanes)
STATE_DIMS = (4, 8, 16)  # the JAX kernel test's and jamba's
_DTYPES = (torch.float32, torch.bfloat16)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.looptune_mamba_scan.argtypes = [p] * 8 + [i] * 6 + [ll] * 8 + [i, p]
    lib.looptune_mamba_scan.restype = i
    lib.looptune_mamba_scan_plan.argtypes = [i] * 4 + [ctypes.POINTER(i)]
    lib.looptune_mamba_scan_plan.restype = i


def _lib() -> ctypes.CDLL:
    return _build.load("mamba_scan", _declare)


def launch_plan(s: int, c: int, chunk: int = 32, bd: int = 128) -> dict:
    """The CTA a launch uses for ``s`` tokens and ``c`` channels at the
    ``"mamba"`` block ``{l: chunk, c: bd}``, clamped to ``(S, C)`` as the
    TPU wrapper clamps it: ``l`` tokens staged a tile (at most
    :data:`MAX_L`), ``cc`` channels a CTA (a multiple of 32 up to
    :data:`MAX_CC`), ``threads`` a CTA (:data:`LANES` a channel), and the
    tile and CTA counts along S and C.  Pure Python; the kernel computes
    the same (``looptune_mamba_scan_plan``, held equal on the card)."""
    if min(s, c, chunk, bd) < 1:
        raise ValueError(f"need s, c, chunk, bd >= 1, got {(s, c, chunk, bd)}")
    tile = min(chunk, s, MAX_L)
    cc = 32 * max(1, min(-(-min(bd, c) // 32), MAX_CC // 32))
    return {"l": tile, "cc": cc, "threads": cc * LANES, "n_tiles": -(-s // tile),
            "n_ctas": -(-c // cc)}


def kernel_plan(s: int, c: int, chunk: int = 32, bd: int = 128) -> dict:
    """The plan as the built kernel computes it (needs the library)."""
    out = (ctypes.c_int * 5)()
    if _lib().looptune_mamba_scan_plan(s, c, chunk, bd, out) != 0:
        raise ValueError(f"bad plan arguments {(s, c, chunk, bd)}")
    return dict(zip(("l", "cc", "threads", "n_tiles", "n_ctas"), out))


def mamba_scan_plain(dtx: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, *, chunk: int = 32,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch ops, computed as the TPU kernel
    computes it: dtx ``(B, S, C)``, da ``(B, S, C, N)`` (log decay, <= 0),
    b and c ``(B, S, N)``, widened to f32; chunks of ``min(chunk, S)`` with
    the tail zero-padded and masked (dtx = 0, da = 0); per chunk u = dtx B,
    cum = cumsum(da), h_t = e^{cum_t} (h + cumsum(u e^{-cum})), y_t = C_t .
    h_t.  ``h0 (B, C, N)``: the state to start from (zeros when None).
    Returns (y (B, S, C) f32, final state (B, C, N) f32)."""
    bsz, s, ch = dtx.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    pad = -s % chunk
    dtx, da, b, c = (t.float() for t in (dtx, da, b, c))
    if pad:
        dtx, b, c = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (dtx, b, c))
        da = torch.nn.functional.pad(da, (0, 0, 0, 0, 0, pad))
    valid = (torch.arange(s + pad, device=dtx.device) < s)[None, :, None]
    dtx = torch.where(valid, dtx, 0.0)
    da = torch.where(valid[..., None], da, 0.0)  # exp(0) = 1: state-neutral
    h = (torch.zeros(bsz, ch, n, dtype=torch.float32, device=dtx.device)
         if h0 is None else h0.float())
    ys = []
    for c0 in range(0, s + pad, chunk):
        dtxb, dab, bb, cb = (t[:, c0:c0 + chunk] for t in (dtx, da, b, c))
        u = dtxb[..., None] * bb[:, :, None, :]            # (B, L, C, N)
        cum = torch.cumsum(dab, dim=1)                      # inclusive log decay
        csum = torch.cumsum(u * torch.exp(-cum), dim=1)
        h_all = torch.exp(cum) * (h[:, None] + csum)
        ys.append(torch.einsum("blcn,bln->blc", h_all, cb))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1)[:, :s], h


def mamba_scan_plain_model(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                           h0: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_scan_plain` on the wrapper's arguments at exactly
    ``chunk``: dtx = dt x and da = dt a formed in f32.  What the wrapper
    runs for CPU tensors at its tile, and what the kernel is held against
    on the card."""
    dt32 = dt.float()
    dtx = dt32 * x.float()
    da = dt32[..., None] * a.float()[None, None]
    return mamba_scan_plain(dtx, da, b, c, chunk=chunk, h0=h0)


def _check(x, dt, a, b, c, h0) -> tuple:
    if x.dim() != 3 or b.dim() != 3:
        raise ValueError(f"mamba_scan takes (B, S, C) x, dt and (B, S, N) b, c; got "
                         f"x {tuple(x.shape)}, b {tuple(b.shape)}")
    bsz, s, ch = x.shape
    n = b.shape[-1]
    if dt.shape != x.shape or c.shape != b.shape or tuple(b.shape[:2]) != (bsz, s):
        raise ValueError(f"x, dt must share (B, S, C) and b, c (B, S, N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if min(bsz, s, ch) < 1:
        raise ValueError(f"need non-empty shapes, got {tuple(x.shape)}")
    if tuple(a.shape) != (ch, n):
        raise ValueError(f"a must be (C, N) = {(ch, n)}, got {tuple(a.shape)}")
    if h0 is not None and tuple(h0.shape) != (bsz, ch, n):
        raise ValueError(f"h0 must be (B, C, N) = {(bsz, ch, n)}, got {tuple(h0.shape)}")
    if not (x.dtype == dt.dtype == b.dtype == c.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"x, dt, b, c must all be float32 or all bfloat16; got "
                        f"{x.dtype}, {dt.dtype}, {b.dtype}, {c.dtype}")
    if a.dtype != torch.float32 or (h0 is not None and h0.dtype != torch.float32):
        raise TypeError(f"a and h0 must be float32, got {a.dtype}, "
                        f"{None if h0 is None else h0.dtype}")
    if n not in STATE_DIMS:
        raise ValueError(f"state dim {n} is not one the kernel takes {STATE_DIMS}")
    devices = {t.device for t in (x, dt, a, b, c) + ((h0,) if h0 is not None else ())}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    return bsz, s, ch, n


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, *, chunk: int = 32, bd: int = 128,
               h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan at the CTA of :func:`launch_plan` ``(S, C, chunk,
    bd)``.  Returns (y (B, S, C) f32, final state (B, C, N) f32).

    A CUDA tensor always launches the kernel, on the current stream and
    without synchronising; a CPU tensor runs :func:`mamba_scan_plain_model`
    at the plan's token tile.  Under grad the call goes through
    :class:`MambaScan`.  Shapes, dtypes and state dims the kernel
    does not take raise on both.
    """
    bsz, s, ch, n = _check(x, dt, a, b, c, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, a, b, c, h0)):
        return MambaScan.apply(x, dt, a, b, c, h0, chunk, bd)
    plan = launch_plan(s, ch, chunk, bd)
    if x.device.type == "cpu":
        return mamba_scan_plain_model(x, dt, a, b, c, chunk=plan["l"], h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on cuda or cpu tensors, got {x.device}")
    if not all(t.stride(2) == 1 for t in (x, dt, b, c)):
        raise ValueError("mamba_scan needs the last dim of x, dt, b, c contiguous")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} is above the grid's 65535")
    ac = a.contiguous()
    h0c = None if h0 is None else h0.contiguous()
    y = torch.empty((bsz, s, ch), dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, ch, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().looptune_mamba_scan(
            x.data_ptr(), dt.data_ptr(), ac.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if h0c is None else h0c.data_ptr(), y.data_ptr(), state.data_ptr(),
            bsz, s, ch, n, plan["l"], plan["cc"], *x.stride()[:2], *dt.stride()[:2],
            *b.stride()[:2], *c.stride()[:2], int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"mamba scan launch failed: cudaError {err} "
                           f"(x {tuple(x.shape)}, N {n}, plan {plan})")
    mamba_scan.launches += 1
    return y, state


#: kernel launches since the count was last set to 0 (the CPU path and the
#: plain version do not count)
mamba_scan.launches = 0


class MambaScan(torch.autograd.Function):
    """The scan under autograd: forward :func:`mamba_scan` (the kernel on
    CUDA tensors), backward the input gradients of
    :func:`mamba_scan_plain_model` recomputed at the plan's token tile."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, h0, chunk, bd):
        y, state = mamba_scan(x, dt, a, b, c, chunk=chunk, bd=bd, h0=h0)
        ctx.save_for_backward(x, dt, a, b, c, h0)
        ctx.tile = launch_plan(x.shape[1], x.shape[2], chunk, bd)["l"]
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, state = mamba_scan_plain_model(*inputs[:5], chunk=ctx.tile, h0=inputs[5])
            wrt = [t for t, need in zip(inputs, ctx.needs_input_grad) if t is not None and need]
            grads = iter(torch.autograd.grad((y, state), wrt, (dy, dstate), allow_unused=True))
        return tuple(next(grads) if t is not None and need else None
                     for t, need in zip(inputs, ctx.needs_input_grad)) + (None, None)
