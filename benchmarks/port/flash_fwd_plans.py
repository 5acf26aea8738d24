"""Flash attention's bf16 forward at head dims 96 and 256: the warp-specialised
kernel against its previous design and SDPA, on one CUDA card.

    python3 benchmarks/port/flash_fwd_plans.py           # checks, then timings
    python3 benchmarks/port/flash_fwd_plans.py --check   # checks only

Forms of the flash library, each through the same wrapper:

* ``previous``: ``benchmarks/port/flash_attention_tc_previous.cu``, the
  library before ``flash_fwd_ws``: D = 96 and 256 on ``flash_fwd_tc`` (two
  warpgroups, no producer, a two-stage cp.async ring; D = 96 staged as 128
  zero-padded columns with 32-key tiles, D = 256 with 16-key tiles);
* ``mode0`` .. ``mode3``: ``csrc/flash_attention.cu`` with ``kWsMode`` set
  to 0-3 (copies under ``build/flash_fwd_plans/``; the committed value is
  the source itself): bit 0, S of tile j + 1 issued with P·V of tile j and
  its softmax under P·V; bit 1, the two consumer warpgroups take turns at
  issuing.

First every form is built (one ``nvcc`` each, all at once; the ``build``
line has ptxas's registers and spills of each ``flash_fwd_ws`` instance)
and checked, each form in its own process so that one at fault cannot stop
the others: chip_smoke.py's D = 96/256 cases (ragged S and T, GQA 5 and 8,
a window with rows that see no key, softcaps, non-causal, a strided q) and
the four shapes below, against ``flash_attention_plain`` (3e-2; the lse at
gemma3-12b's training shapes 1e-5).  Then, in one process, each form is
timed at the four shapes: phi3-mini's prefill (4, 1024, 32/32, 96) at kv
tiles 64 and 128 (blocks (128, 64) and (128, 128)), gemma3-12b's
(4, 1024, 16/8, 256), and gemma3-12b's training shapes (2, 4096, 16/8, 256)
causal and with the local layers' window of 1024: CUDA events, the median of
20 calls each after overwriting 512 MiB, and the profiler's mean device time
over 10 calls.  ``torch.nn.functional.scaled_dot_product_attention`` on the
same inputs is timed in every pass as the library yardstick (with a window:
a boolean band mask, k and v repeated to 16 heads); it is not part of the
port.  Passes run in turns: previous, mode0 .. mode3, mode3 .. mode0,
previous.  The summary line has each form's median over its passes and the
bound; last, the card's name and power limit.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402

FA = importlib.import_module("repro_torch.kernels.flash_attention")

MODE_LINE = "constexpr int kWsMode = {};"
MODES = (0, 1, 2, 3)
PREVIOUS = ROOT / "benchmarks" / "port" / "flash_attention_tc_previous.cu"
VARIANTS = ROOT / "build" / "flash_fwd_plans"
# (name, (B, S, H, HKV, D), window, blocks timed)
SHAPES = [("phi3-mini prefill", CS.FA_PHI3_SHAPE, None, [(128, 64), (128, 128)]),
          ("gemma3-12b prefill", CS.FA_GEMMA3_SHAPE, None, [(128, 128)]),
          ("gemma3-12b train, global", (2, 4096, 16, 8, 256), None, [(128, 128)]),
          ("gemma3-12b train, local", (2, 4096, 16, 8, 256), 1024, [(128, 128)])]
LIMIT = CS.ATTN_LIMIT[torch.bfloat16]
LINES = ROOT / "chiprun_out" / "flash_fwd_plans.jsonl"  # every line, kept past the output's tail


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)
    LINES.parent.mkdir(exist_ok=True)
    with open(LINES, "a") as f:
        f.write(json.dumps(row) + "\n")


def committed_mode() -> int:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for m in MODES:
        if MODE_LINE.format(m) in src:
            return m
    raise SystemExit("flash_attention.cu: no kWsMode line")


def forms() -> dict:
    """Form name -> source file; the mode copies are written here."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    cur = committed_mode()
    out = {"previous": PREVIOUS}
    VARIANTS.mkdir(parents=True, exist_ok=True)
    for m in MODES:
        if m == cur:
            out[f"mode{m}"] = _build.CSRC / "flash_attention.cu"
            continue
        path = VARIANTS / f"flash_attention_mode{m}.cu"
        path.write_text(src.replace(MODE_LINE.format(cur), MODE_LINE.format(m)))
        out[f"mode{m}"] = path
    return out


def inputs(shape, g):
    b, s, h, hkv, d = shape
    q = torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


def ratio(out, want) -> float:
    return ((out.float() - want.float()).abs() / (LIMIT + LIMIT * want.float().abs())).max().item()


def check_form(name: str) -> int:
    """Every check of one form, a JSON line each; 1 if any is outside."""
    with _build.substitute("flash_attention", forms()[name], FA._declare):
        g = torch.Generator(device="cuda").manual_seed(CS.SEED)
        bad = 0
        for case in CS.ZOO_CASES:
            (b, s, t, h, hkv, d, causal, window, softcap, bq, bk, dt, q_view) = case
            if q_view:
                q = torch.randn(b, s, 3, h, d, generator=g, device="cuda").to(dt)[:, :, 0]
            else:
                q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
            k, v = (torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt)
                    for _ in range(2))
            kw = dict(causal=causal, window=window, softcap=softcap, bq=bq, bk=bk)
            out = FA.flash_attention(q, k, v, **kw)
            r = ratio(out, FA.flash_attention_plain(q, k, v, **kw))
            bad += not r <= 1.0
            emit({"form": name, "case": list(case[:11]), "ratio_to_limit": r,
                  "plan": FA.kernel_plan(s, t, bq, bk, d=d, dtype=dt)})
        for label, shape, window, blocks in SHAPES:
            q, k, v = inputs(shape, g)
            for bq, bk in blocks:
                kw = dict(causal=True, window=window, bq=bq, bk=bk)
                out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
                want, want_lse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
                r = ratio(out, want)
                lse_err = ((lse - want_lse).abs() / (1 + want_lse.abs())).max().item()
                bad += not (r <= 1.0 and lse_err <= CS.LSE_LIMIT)
                emit({"form": name, "shape": label, "block": [bq, bk], "ratio_to_limit": r,
                      "lse_rel_err": lse_err})
            del q, k, v
    return 1 if bad else 0


def build_line(paths: dict) -> None:
    t0 = time.perf_counter()
    _build.build_all(list(paths.values()))
    rows = {}
    for name, path in paths.items():
        info = _build.BUILD_INFO[path.stem]
        rows[name] = {"nvcc_s": round(float(info["seconds"]), 1),
                      "flash_fwd_ws": CS.ptxas_by_function(str(info["log"]), "flash_fwd_ws"),
                      "wgmma_warnings": [ln.strip() for ln in str(info["log"]).splitlines()
                                         if "wgmma" in ln.lower() or "C7520" in ln]}
    emit({"build": rows, "seconds": round(time.perf_counter() - t0, 1)})


def flops(shape, window) -> int:
    b, s, h, hkv, d = shape
    return 4 * b * h * d * CS.visible_pairs(s, window)


def bound_ms(shape, window, card: str) -> dict:
    b, s, h, hkv, d = shape
    peak = CS.BF16_PEAK["pcie" if "PCIe" in card else "sxm"]
    ops = flops(shape, window) / peak * 1e3
    nbytes = 2 * b * s * (h + hkv) * d * 2  # q, k, v and out once, bf16
    mem = nbytes / CS.HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops, mem), "ops_ms": ops, "bytes_ms": mem,
            "bound_by": "operations" if ops >= mem else "bytes"}


def sdpa_call(q, k, v, window):
    h, hkv = q.shape[2], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        return lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=hkv != h)
    kt, vt = (x.repeat_interleave(h // hkv, dim=1) for x in (kt, vt))
    i = torch.arange(q.shape[1], device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return lambda: sdpa(qt, kt, vt, attn_mask=band)


def timings(paths: dict, card: str) -> None:
    g = torch.Generator(device="cuda").manual_seed(CS.SEED)
    flush = CS.flush_buffer()
    data = [(label, shape, window, blocks, inputs(shape, g))
            for label, shape, window, blocks in SHAPES]
    order = ["previous"] + [f"mode{m}" for m in MODES] + [f"mode{m}" for m in reversed(MODES)]
    order.append("previous")
    rows = []
    for name in order:
        with _build.substitute("flash_attention", paths[name], FA._declare):
            for label, shape, window, blocks, (q, k, v) in data:
                for bq, bk in blocks:
                    def call():
                        return FA.flash_attention(q, k, v, causal=True, window=window, bq=bq,
                                                  bk=bk)
                    ms = CS.time_ms(call, flush, 20)
                    dev, src = CS.kernel_device_ms(call, "flash_fwd")
                    row = {"form": name, "shape": label, "bshkd": list(shape),
                           "window": window, "block": [bq, bk],
                           "plan": FA.kernel_plan(shape[1], shape[1], bq, bk, d=shape[4],
                                                  dtype=torch.bfloat16),
                           "ms": ms, "device_ms": dev, "device_ms_source": src,
                           "tflops": flops(shape, window) / ms / 1e9}
                    rows.append(row)
                    emit(row)
            for label, shape, window, blocks, (q, k, v) in data:
                sd = CS.time_ms(sdpa_call(q, k, v, window), flush, 20)
                rows.append({"form": "sdpa", "shape": label, "window": window, "ms": sd})
                emit(rows[-1])
    summary = []
    for label, shape, window, blocks in SHAPES:
        timed = [(n, b) for b in blocks for n in ["previous"] + [f"mode{m}" for m in MODES]]
        for name, blk in timed + [("sdpa", None)]:
            mine = [r for r in rows if r["form"] == name and r["shape"] == label
                    and r.get("block") == (list(blk) if blk else None)]
            got = sorted(r["ms"] for r in mine)
            dev = sorted(r["device_ms"] for r in mine if "device_ms" in r)
            summary.append({"shape": label, "bshkd": list(shape), "window": window,
                            "form": name, "block": list(blk) if blk else None,
                            "ms_median": got[len(got) // 2], "ms_all": got,
                            "device_ms_median": dev[len(dev) // 2] if dev else None,
                            **bound_ms(shape, window, card)})
    emit({"summary": summary})


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_plans: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--form":
        return check_form(sys.argv[2])
    card = torch.cuda.get_device_name(0)
    LINES.unlink(missing_ok=True)
    paths = forms()
    build_line(paths)
    failed = []
    for name in paths:
        rc = subprocess.run([sys.executable, __file__, "--form", name]).returncode
        failed += [name] if rc else []
    emit({"checks_failed": failed})
    if "--check" not in sys.argv and not failed:
        timings(paths, card)
    print(CS.nvidia_smi_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
