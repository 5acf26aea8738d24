"""Flash attention's SIMT route against its previous design and SDPA, on one
CUDA card.

    python3 benchmarks/port/flash_simt_plans.py

Two forms of the flash library, each through the same wrapper:

* ``previous``: ``benchmarks/port/flash_attention_previous.cu``, whose SIMT
  route runs 128 threads with 8 x 4 score tiles and stages K and V
  synchronously;
* ``current``: ``csrc/flash_attention.cu``, 256 threads with 8 x 4 or 8 x 8
  register tiles read as float4, P transposed in shared memory and a
  two-stage cp.async K/V ring.

In f32 (the SIMT route), causal, at musicgen-large's prefill shape (B, S, H,
HKV, D) = (4, 256, 32, 32, 64) and at jamba's head dim (4, 1024, 32, 8,
128), each form is held against the plain version (3e-5) at the default
block (128, 128), then timed there and at chip_smoke.py's FLASH_SWEEP
blocks (each with the plan the form's own library computes): CUDA events,
the median of 20 calls each after overwriting 512 MiB, and at the default
block the profiler's mean device time over 10 calls.
``torch.nn.functional.scaled_dot_product_attention`` on the same f32 inputs
is timed in every pass as the library yardstick (it is not part of the
port).  The forms run in turns, previous, current, current, previous.  Last,
the card's name and power limit.
"""
from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402

FA = importlib.import_module("repro_torch.kernels.flash_attention")

SHAPES = [CS.FA_SHAPE[:3] + CS.FA_SHAPE[2:], CS.FA_JAMBA_SHAPE]  # (B, S, H, HKV, D)
LIMIT = CS.ATTN_LIMIT[torch.float32]
FORMS = {"previous": ROOT / "benchmarks" / "port" / "flash_attention_previous.cu",
         "current": _build.CSRC / "flash_attention.cu"}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_simt_plans: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all(list(FORMS.values()))
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = CS.flush_buffer()
    data = []
    for b, s, h, hkv, d in SHAPES:
        q = torch.randn(b, s, h, d, generator=g, device="cuda")
        k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda") for _ in range(2))
        data.append((q, k, v, FA.flash_attention_plain(q, k, v, causal=True)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in ("previous", "current", "current", "previous"):
        with _build.substitute("flash_attention", FORMS[name], FA._declare):
            for shape, (q, k, v, want) in zip(SHAPES, data):
                def call(block=(128, 128)):
                    return lambda: FA.flash_attention(q, k, v, causal=True, bq=block[0],
                                                      bk=block[1])

                out = call()()
                torch.cuda.synchronize()
                ratio = ((out - want).abs() / (LIMIT + LIMIT * want.abs())).max().item()
                if not ratio <= 1.0:
                    raise SystemExit(f"{name} at {shape}: outside the {LIMIT} limit ({ratio})")
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                b, s, h, hkv, d = shape
                flops = 4 * b * h * d * s * (s + 1) // 2  # visible pairs only
                ms = CS.time_ms(call(), flush, 20)
                row = {"form": name, "bshkd": list(shape), "dtype": "float32", "causal": True,
                       "block": [128, 128],
                       "plan": FA.kernel_plan(s, s, d=d, dtype=torch.float32),
                       "ratio_to_limit": ratio, "ms": ms,
                       **dict(zip(("device_ms", "device_ms_source"),
                                  CS.kernel_device_ms(call(), "flash_fwd"))),
                       "tflops": flops / ms / 1e9,
                       "sdpa_ms": CS.time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                                          enable_gqa=hkv != h), flush, 20),
                       "sweep": [{"block": list(blk),
                                  "plan": FA.kernel_plan(s, s, *blk, d=d, dtype=torch.float32),
                                  "ms": CS.time_ms(call(blk), flush, 20)}
                                 for blk in CS.FLASH_SWEEP]}
                print(json.dumps(row), flush=True)
    print(CS.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
