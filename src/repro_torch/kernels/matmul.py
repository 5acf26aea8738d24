"""Tiled matmul — the kernel LoopTune schedules, written by hand for Hopper.

The tuned loop nest lowers onto this kernel: the resident suffix of the
schedule becomes the block ``(bm, bk, bn)`` and the outer levels the grid
order (``grid_order``).  :func:`matmul` launches the CUDA kernel in
``csrc/matmul.cu`` (see the note there: what it replaces, what bounds it on
the card, and how each route maps blocks of any size onto a thread block).
:func:`matmul_plain` is the same function in plain torch ops; the wrapper
takes it only for tensors that lie on the CPU.

Two routes, by the launch's arguments alone (:func:`launch_plan`): bf16
operands with K and N multiples of 8 run on the tensor cores ("wgmma":
wgmma from a ring in shared memory, f32 accumulation), everything else,
every f32 launch included, runs the SIMT kernel ("simt": f32 FMAs from a
cp.async ring; TF32 would miss the f32 limit of 1e-5).  On both the block,
clamped to (M, K, N), maps to a CTA tile from a small family.  "wgmma": an
m tile of 64 if bm <= 64 else 128, an n tile of the power of two >= bn in
[64, 256], and ``clamp(ceil(bk / 64), 1, 4)`` 64-value k chunks a ring stage
(fewer if three stages would not fit).  M alone picks the kernel: when
M > 64 the persistent one (``design`` "persistent": min(tiles, SMs) CTAs,
a TMA producer warp, two consumer warpgroups in turns at a 64-row tile or
together at a 128-row one, as many ring stages as fit, up to 16); when
M <= 64 (decode, bound by reading B) the split-K one (``design``
"split_k": K split over two warpgroups of the CTA at an n tile <= 128, a
stage holds one chunk for each, and the ring has as many stages as fit, up
to 16).  "simt": an m tile of 64 if bm <= 64 else
128, an n tile of 64 if bn <= 64 else 128, and a stage k depth of the power
of two >= bk in [8, 64]; up to 4 ring stages in the shared memory (in a
third of it at 64 x 64, three CTAs an SM).  When M <= 16 (decode) the m tile
is 4 or 16, the n tile the power of two >= bn in [16, 128] that leaves at
least 128 CTAs, and K is split over ``1024 / tn`` thread groups of the CTA,
4 k values each a stage, in half the shared memory (up to 4 stages).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


#: dynamic shared memory a block may use
SMEM = 232448
#: the tensor-core route: the split-K kernel's ring (shared memory less the
#: 1024-byte alignment slack) and its stages at most, chunks a stage, and the
#: largest M it takes
TC_SMEM = SMEM - 1024
TC_DEEP_STAGES, TC_MAX_KC, TC_SPLIT_K_M = 16, 4, 64
#: the persistent kernel's stages at most, and its ring (less a full and an
#: empty mbarrier of 8 bytes for each of those stages)
TC_WS_STAGES = 16
TC_WS_SMEM = TC_SMEM - 16 * TC_WS_STAGES
#: SMs of an H100 SXM, the persistent grid's bound where no card is visible
H100_SMS = 132
#: the SIMT route: threads a CTA, ring stages, the decode plan's largest M
#: and its shared memory (two CTAs an SM), floats after each staged row
SIMT_THREADS, SIMT_STAGES, SIMT_DECODE_M = 256, 4, 16
SIMT_DECODE_CTAS = 128  # the decode plan's n tile leaves at least this many CTAs
SIMT_DECODE_SMEM = SMEM // 2 - 1024
SIMT_PAD = 4


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.looptune_matmul.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.looptune_matmul.restype = i
    lib.looptune_matmul_plan.argtypes = [i] * 8 + [ctypes.POINTER(i)]
    lib.looptune_matmul_plan.restype = i


_SMS: dict = {}


def sm_count() -> int:
    """SMs of the current CUDA device, read once a device (the persistent
    kernel's grid is at most this); ``H100_SMS`` where no card is visible."""
    if not torch.cuda.is_available():
        return H100_SMS
    dev = torch.cuda.current_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


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


def check_no_grad(*operands: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad is enabled and an operand requires
    grad: the tiled matmul has no backward, so its result would carry no
    ``grad_fn`` and every parameter upstream would silently get no
    gradient."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in operands):
        raise RuntimeError(
            "the tiled matmul kernel has no backward: an operand requires grad. The JAX "
            "package cannot differentiate its Pallas matmul either (ROADMAP.md, §C 6); "
            "train with registry=None (dense sites on the plain @)")


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 128,
           bn: int = 128, grid_order: str = "mn", out_dtype=None,
           trans_b: bool = False) -> torch.Tensor:
    """C[m, n] = A[m, k] @ B[k, n] at block ``(bm, bk, bn)``, traversing the
    output blocks in ``grid_order`` ("mn": n fastest, "nm": m fastest).

    ``trans_b=True`` takes B as (N, K) (a weight stored output-major).  A
    CUDA tensor always launches the kernel, on the current stream and
    without synchronising; a CPU tensor runs :func:`matmul_plain`.  The
    kernel has no backward: with grad enabled and an operand that requires
    grad it raises (:func:`check_no_grad`) on both.
    """
    check_no_grad(a, b)
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
    route = route_for(k, n, a.dtype)
    if route == "wgmma":
        for x in (a, b):
            if x.data_ptr() % 16:
                raise ValueError(f"the tensor-core matmul loads rows in 16-byte pieces: "
                                 f"an operand at offset {x.data_ptr() % 16} bytes "
                                 f"cannot be loaded")
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
    matmul.route_launches[route] += 1
    if route == "wgmma":
        matmul.tc_design_launches[tc_design(m)] += 1
    return out


#: kernel launches since the count was last set to 0 (the CPU path and the
#: plain version do not count), in all, by route, and on the "wgmma" route
#: by kernel (:func:`tc_design`)
matmul.launches = 0
matmul.route_launches = {"wgmma": 0, "simt": 0}
matmul.tc_design_launches = {"persistent": 0, "split_k": 0}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def route_for(k: int, n: int, dtype: torch.dtype) -> str:
    """The route a launch takes: "wgmma" for bf16 operands whose A and B
    rows all start on 16-byte boundaries (K and N multiples of 8), else
    "simt"."""
    return "wgmma" if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 else "simt"


def tc_design(m: int) -> str:
    """The tensor-core kernel a launch of M rows runs: "split_k" at M <= 64
    (decode), else "persistent"."""
    return "split_k" if m <= TC_SPLIT_K_M else "persistent"


def launch_plan(m: int, k: int, n: int, bm: int = 128, bk: int = 128, bn: int = 128,
                grid_order: str = "mn", *, dtype: torch.dtype = torch.float32) -> dict:
    """How the kernel lays out one launch, and on which route.  Pure Python;
    the kernel computes the same (``looptune_matmul_plan``, held equal on
    the card).

    "wgmma": the kernel (``design``, :func:`tc_design`), the CTA ``tile``
    (m, n), ``k_chunks`` 64-value chunks a ring stage, ``stages``, the output
    ``tiles``, ``ctas`` (min(tiles, :func:`sm_count`) for "persistent", one
    a tile for "split_k") and ``k_split``, the
    warpgroups that split K (each multiplies its own chunk of a stage; the
    partial tiles are summed in shared memory).  "simt": the CTA ``tile``,
    ``k_depth`` k values a ring stage, ``stages``, ``ctas`` and ``k_split``,
    the thread groups that split K (1 unless M <= 16).  The grid order
    changes no plan, only the order tiles are taken in."""
    if min(m, k, n, bm, bk, bn) < 1:
        raise ValueError(f"bad plan arguments {(m, k, n, bm, bk, bn)}")
    bm, bk, bn = min(bm, m), min(bk, k), min(bn, n)
    if route_for(k, n, dtype) == "wgmma":
        tm = 64 if bm <= 64 else 128
        tn = 64
        while tn < bn and tn < 256:
            tn *= 2
        chunks = _cdiv(k, 64)
        design = tc_design(m)
        # split-K: two warpgroups (n tile <= 128), one chunk each a stage
        ks = 2 if design == "split_k" and tn <= 128 else 1
        kc = ks if design == "split_k" else min(_cdiv(bk, 64), TC_MAX_KC, chunks)
        ring = TC_WS_SMEM if design == "persistent" else TC_SMEM
        while kc > 1 and 3 * kc * (tm + tn) * 128 > ring:
            kc -= 1
        fit = ring // (kc * (tm + tn) * 128)
        tiles = _cdiv(m, tm) * _cdiv(n, tn)
        if design == "persistent":
            stages, ctas = min(fit, TC_WS_STAGES), min(tiles, sm_count())
        else:
            stages = max(min(TC_DEEP_STAGES, fit, _cdiv(chunks, kc) + 2), 3)
            ctas = tiles
        return {"route": "wgmma", "design": design, "tile": (tm, tn), "k_chunks": kc,
                "stages": stages, "tiles": tiles, "ctas": ctas, "k_split": ks}
    if m <= SIMT_DECODE_M:  # one m tile; K split over groups of tn / 4 threads
        tm, tn = (4 if m <= 4 else 16), 16
        while tn < bn and tn < 128 and _cdiv(n, 2 * tn) >= SIMT_DECODE_CTAS:
            tn *= 2
        ks = 4 * SIMT_THREADS // tn
        kd, budget = 4 * ks, SIMT_DECODE_SMEM
    else:
        tm, tn, kd = (64 if bm <= 64 else 128), (64 if bn <= 64 else 128), 8
        while kd < bk and kd < 64:
            kd *= 2
        # 64 x 64: a third of the shared memory, three CTAs an SM
        ks, budget = 1, (SMEM // 3 - 1024 if tm * tn <= 64 * 64 else SMEM)
    return {"route": "simt", "tile": (tm, tn), "k_depth": kd,
            "stages": min(SIMT_STAGES, budget // simt_stage_bytes(tm, tn, kd)),
            "ctas": _cdiv(m, tm) * _cdiv(n, tn), "k_split": ks}


def simt_stage_bytes(tm: int, tn: int, kd: int) -> int:
    """Bytes of one SIMT ring stage: A ``[tm][kd + 4]`` f32, then B as
    ``[kd][tn + 4]`` or ``[tn][kd + 4]``, sized for the larger of the two."""
    return 4 * (tm * (kd + SIMT_PAD) + (kd + SIMT_PAD) * (tn + SIMT_PAD))



def kernel_plan(m: int, k: int, n: int, bm: int = 128, bk: int = 128, bn: int = 128,
                grid_order: str = "mn", *, dtype: torch.dtype = torch.float32) -> dict:
    """The plan as the built kernel computes it (needs the library)."""
    out = (ctypes.c_int * 9)()
    if _lib().looptune_matmul_plan(m, k, n, bm, bk, bn, int(grid_order == "nm"),
                                   int(dtype == torch.bfloat16), out) != 0:
        raise ValueError(f"bad plan arguments {(m, k, n, bm, bk, bn)}")
    if out[0]:
        return {"route": "wgmma", "design": "persistent" if out[7] else "split_k",
                "tile": (out[1], out[2]), "k_chunks": out[3], "stages": out[4],
                "tiles": out[8], "ctas": out[5], "k_split": out[6]}
    return {"route": "simt", "tile": (out[1], out[2]), "k_depth": out[3], "stages": out[4],
            "ctas": out[5], "k_split": out[6]}
