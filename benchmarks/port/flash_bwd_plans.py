"""Flash attention's backward: the tensor-core design against the previous
SIMT design, its tile options and SDPA's backward, on one CUDA card.

    python3 benchmarks/port/flash_bwd_plans.py

Forms of the backward library:

* ``previous``: ``benchmarks/port/flash_attention_bwd_previous.cu``, SIMT
  f32 FMAs at every dtype and head dim (bf16 widened as it is staged, no
  double buffering, S and dP in both launches), called as its wrapper
  called it (:func:`previous_bwd`: delta = rowsum(dout . out) in torch ops,
  then the library's two launches);
* ``current``: ``csrc/flash_attention_bwd.cu`` through the wrapper
  (``flash_attention_bwd``), whose bf16 D = 64/96/128 route runs every
  product on wgmma with bf16 operands in a cp.async ring and computes delta
  in its dq kernel;
* the tile options weighed for that route: copies of the current source
  with its ``kTcTiles`` table (and, for one, ``kTcMinBlocks``) replaced
  (:data:`OPTIONS`), built into ``build/flash_bwd_plans/`` and loaded
  through the wrapper.

At musicgen-large's training shape (B, S, H, HKV, D) = (4, 1024, 32, 32, 64)
and jamba's (4, 1024, 32, 8, 128), bf16, causal, each form is held against
``flash_attention_bwd_plain`` (3e-2, chip_smoke.py's bf16 limit) on the
forward kernel's out and lse, then timed: CUDA events, the median of 20
calls each after overwriting 512 MiB, and each of the two launches' device
time (dk/dv, dq) as the profiler's mean over 10 calls.  SDPA's backward
(autograd of one ``scaled_dot_product_attention`` call, ``enable_gqa`` at
GQA; not part of the port) is timed in every pass as the yardstick.
previous and current run in turns, previous, current, current, previous,
then each option once; an option outside the limit is reported and not
timed.  Each line names its form, its plan (the library's own) and the
registers and spills ptxas gave its tensor-core kernels.  Last, the card's
name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402

FA = importlib.import_module("repro_torch.kernels.flash_attention")

SHAPES = [(4, 1024, 32, 32, 64), (4, 1024, 32, 8, 128)]  # (B, S, H, HKV, D)
LIMIT = CS.FLASH_BWD_LIMIT[torch.bfloat16]
TILES_LINE = re.compile(r"constexpr int kTcTiles\[3\]\[4\] = \{.*\};")
#: option -> the kTcTiles table at D = 64, 96, 128: (dk/dv warpgroups, its q
#: tile, dq warpgroups, its kv tile)
OPTIONS = {
    "w2_n64": "{{2, 64, 2, 64}, {2, 32, 2, 64}, {2, 32, 2, 64}}",
    "w1_n64": "{{1, 64, 1, 64}, {1, 32, 1, 64}, {1, 32, 1, 64}}",
    "w2_n32": "{{2, 32, 2, 32}, {2, 32, 2, 32}, {2, 32, 2, 32}}",
    "w1_n64_dq_w2_n32": "{{1, 64, 2, 32}, {1, 32, 2, 32}, {1, 32, 2, 32}}",
    "n64_everywhere": "{{2, 64, 2, 64}, {2, 64, 2, 64}, {2, 64, 2, 64}}",
    # the current table with registers capped at 128 a thread (kTcMinBlocks
    # 2 of 256 threads), so that four one-warpgroup CTAs fit an SM
    "w1_n32_128_registers": "{{1, 32, 1, 32}, {1, 32, 1, 32}, {1, 32, 1, 32}}",
}
MIN_BLOCKS_LINE = "constexpr int kTcMinBlocks = 1;"


def declare_previous(lib: ctypes.CDLL) -> None:
    """The previous library's launch entry (it has no plan entry)."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.looptune_flash_attention_bwd.argtypes = (
        [p] * 9 + [i] * 6 + [ll] * 12 + [f, f, i, i, i, i, p])
    lib.looptune_flash_attention_bwd.restype = i


def previous_bwd(lib: ctypes.CDLL, q, k, v, out, dout, lse) -> tuple:
    """(dq, dk, dv) through the previous library, causal, as its wrapper
    launched it: delta in torch ops, then the two kernels."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = lib.looptune_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, t, hq, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
        1.0 / d ** 0.5, 0.0, 1, 0, 0, 1, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"previous flash backward launch failed: cudaError {err}")
    return dq, dk, dv


def sources() -> dict:
    """form -> (source path, declare)."""
    current = _build.CSRC / "flash_attention_bwd.cu"
    src = current.read_text()
    if len(TILES_LINE.findall(src)) != 1 or src.count(MIN_BLOCKS_LINE) != 1:
        raise SystemExit("flash_attention_bwd.cu: the kTcTiles table or kTcMinBlocks is not "
                         "found once")
    forms = {"previous": (ROOT / "benchmarks" / "port" / "flash_attention_bwd_previous.cu",
                          declare_previous),
             "current": (current, FA._declare_bwd)}
    out = ROOT / "build" / "flash_bwd_plans"
    out.mkdir(parents=True, exist_ok=True)
    for name, table in OPTIONS.items():
        path = out / f"flash_attention_bwd_{name}.cu"
        text = TILES_LINE.sub(f"constexpr int kTcTiles[3][4] = {table};", src)
        if name.endswith("_128_registers"):
            text = text.replace(MIN_BLOCKS_LINE, "constexpr int kTcMinBlocks = 2;")
        path.write_text(text)
        forms[name] = (path, FA._declare_bwd)
    return forms


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_plans: no CUDA device", file=sys.stderr)
        return 1
    forms = sources()
    _build.build_all(["flash_attention"] + [path for path, _ in forms.values()])
    regs = {name: CS.ptxas_by_function(str(_build.BUILD_INFO[path.stem]["log"]), "_tc<")
            for name, (path, _) in forms.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = CS.flush_buffer()
    data = []
    for b, s, h, hkv, d in SHAPES:
        dt = torch.bfloat16
        q, dout = (torch.randn(b, s, h, d, generator=g, device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dt) for _ in range(2))
        out, lse = FA.flash_attention(q, k, v, causal=True, return_lse=True)
        want = FA.flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=True)
        data.append((q, k, v, out, dout, lse, want))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in ["previous", "current", "current", "previous", *OPTIONS]:
        path, declare = forms[name]
        with _build.substitute("flash_attention_bwd", path, declare) as lib:
            for shape, (q, k, v, out, dout, lse, want) in zip(SHAPES, data):
                b, s, h, hkv, d = shape

                def call():
                    if name == "previous":
                        return previous_bwd(lib, q, k, v, out, dout, lse)
                    return FA.flash_attention_bwd(q, k, v, out, dout, lse, causal=True)

                got = call()
                torch.cuda.synchronize()
                ratio = max(((a.float() - w.float()).abs() / (LIMIT + LIMIT * w.float().abs()))
                            .max().item() for a, w in zip(got, want))
                row = {"form": name, "bshkd": list(shape), "dtype": "bfloat16", "causal": True,
                       "plan": (None if name == "previous" else
                                FA.kernel_bwd_plan(s, s, d=d, dtype=torch.bfloat16)),
                       "tc_kernels": regs[name], "ratio_to_limit": ratio}
                if not ratio <= 1.0:
                    if name in ("previous", "current"):
                        raise SystemExit(f"{name} at {shape}: outside the {LIMIT} limit ({ratio})")
                    print(json.dumps({**row, "within_limit": False}), flush=True)
                    continue
                ms = CS.time_ms(call, flush, 20)
                qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
                o = sdpa(qt, kt, vt, is_causal=True, enable_gqa=hkv != h)
                do = dout.transpose(1, 2)
                pairs = s * (s + 1) // 2
                row.update(
                    ms=ms, tflops=10 * b * h * d * pairs / ms / 1e9,
                    dkdv_device_ms=CS.kernel_device_ms(call, "flash_bwd_dkdv"),
                    dq_device_ms=CS.kernel_device_ms(call, "flash_bwd_dq"),
                    sdpa_bwd_ms=CS.time_ms(
                        lambda: torch.autograd.grad(o, (qt, kt, vt), do, retain_graph=True),
                        flush, 20))
                print(json.dumps(row), flush=True)
    print(CS.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
