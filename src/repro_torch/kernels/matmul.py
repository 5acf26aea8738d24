"""Tiled matmul — the kernel LoopTune schedules, written by hand for Hopper.

The tuned loop nest lowers onto this kernel: the resident suffix of the
schedule becomes the block ``(bm, bk, bn)`` and the outer levels the grid
order (``grid_order``).  :func:`matmul` launches the CUDA kernel in
``csrc/matmul.cu`` (see the note there: what it replaces, what bounds it on
the card, and how it maps blocks of any size onto a thread block).
:func:`matmul_plain` is the same function in plain torch ops; the wrapper
takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.looptune_matmul.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.looptune_matmul.restype = i
    lib.looptune_matmul_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    lib.looptune_matmul_plan.restype = i


def _lib() -> ctypes.CDLL:
    return _build.load("matmul", _declare)


def _check(a: torch.Tensor, b: torch.Tensor, grid_order: str,
           trans_b: bool, out_dtype) -> tuple:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    m, k = a.shape
    kb, n = (b.shape[1], b.shape[0]) if trans_b else tuple(b.shape)
    if k != kb:
        raise ValueError(f"contracted dims differ: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} (trans_b={trans_b})")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"operands must both be float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if grid_order not in ("mn", "nm"):
        raise ValueError(f"grid_order must be 'mn' or 'nm', got {grid_order!r}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    return m, k, n, out_dtype


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                 bk: int = 128, bn: int = 128, grid_order: str = "mn",
                 out_dtype=None, trans_b: bool = False) -> torch.Tensor:
    """The kernel's function in plain torch ops: an f32 accumulator that
    takes the k blocks in order, cast to ``out_dtype`` once at the end.

    Output tiles are independent, so the grid order changes no value and
    every (bm, bn) tile is computed at once per k block; ``bm``/``bn`` and
    ``grid_order`` are checked for the same contract as the kernel's."""
    m, k, n, out_dtype = _check(a, b, grid_order, trans_b, out_dtype)
    if min(bm, bk, bn) < 1:
        raise ValueError(f"blocks must be >= 1, got {(bm, bk, bn)}")
    bk = min(bk, k)
    bt = b.t() if trans_b else b
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, bk):
        acc += a[:, k0:k0 + bk].float() @ bt[k0:k0 + bk].float()
    return acc.to(out_dtype)


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 128,
           bn: int = 128, grid_order: str = "mn", out_dtype=None,
           trans_b: bool = False) -> torch.Tensor:
    """C[m, n] = A[m, k] @ B[k, n] at block ``(bm, bk, bn)``, traversing the
    output blocks in ``grid_order`` ("mn": n fastest, "nm": m fastest).

    ``trans_b=True`` takes B as (N, K) (a weight stored output-major).  A
    CUDA tensor always launches the kernel, on the current stream and
    without synchronising; a CPU tensor runs :func:`matmul_plain`.
    """
    m, k, n, out_dtype = _check(a, b, grid_order, trans_b, out_dtype)
    if a.device.type == "cpu":
        return matmul_plain(a, b, bm=bm, bk=bk, bn=bn, grid_order=grid_order,
                            out_dtype=out_dtype, trans_b=trans_b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu tensors, got {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul takes contiguous operands")
    if min(bm, bk, bn) < 1:
        raise ValueError(f"blocks must be >= 1, got {(bm, bk, bn)}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = _lib().looptune_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
            min(bm, m), min(bk, k), min(bn, n), int(grid_order == "nm"),
            int(trans_b), int(a.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"tiled matmul launch failed: cudaError {err} "
                           f"(m={m} k={k} n={n} block={(bm, bk, bn)})")
    matmul.launches += 1
    return out


#: kernel launches since the count was last set to 0 (the CPU path and the
#: plain version do not count)
matmul.launches = 0


def launch_plan(m: int, n: int, bm: int, bn: int, grid_order: str = "mn"
                ) -> dict:
    """How the kernel lays out one launch: the CTA tile (after grouping
    small blocks), the register sub-tile configuration and the CTA count."""
    out = (ctypes.c_int * 4)()
    err = _lib().looptune_matmul_plan(m, n, min(bm, m), min(bn, n),
                                      int(grid_order == "nm"), out)
    if err != 0:
        raise ValueError(f"bad plan arguments {(m, n, bm, bn)}")
    return {"cta_tile": (out[0], out[1]), "config": out[2], "ctas": out[3]}
