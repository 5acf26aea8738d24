"""Chip smoke test of the PyTorch/CUDA port: LoopTune's main path on one card.

    python3 chip_smoke.py

Run from the repository root on a host with one CUDA card (H100), the CUDA
toolkit and PyTorch; it needs nothing else.  Phases, each printing one JSON
line with its seconds:

1. device — the card's name and power limit (nvidia-smi), torch and CUDA;
2. build  — nvcc builds the tiled-matmul kernel from ``src/repro_torch``;
3. kernel — the kernel against its plain torch version on the card over a
   sweep of shapes, blocks, grid orders, dtypes and the transposed-B form;
4. tune   — ``LoopTuner(policy="search", backend="torch")`` tunes the six
   dense contractions of musicgen-large (d_model 2048, d_ff 8192, vocab
   2048) at decode (M=4) and prefill (M=1024); every reward is a timed
   launch of the kernel;
5. serve  — one layer's worth of ``tuned_einsum`` calls (wq/wk/wv, gate,
   up, down, logits) under ``serving(registry)``, decode and prefill,
   checked against ``matmul_ref``;
6. timing — per contraction: the kernel at its tuned block and at 128^3,
   the plain version, ``torch.matmul`` (the library yardstick only), and
   the bound (bytes over 3.35 TB/s vs FP32 operations over the FP32 peak).

The kernel launch count is set to 0 before phase 4 and read after phase 5;
launches made to compare or to time do not count.  Per-case detail goes to
``chiprun_out/chip_smoke_cases.jsonl``.  Any failure exits non-zero before
the last line, which is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

D_MODEL, D_FF, VOCAB = 2048, 8192, 2048  # musicgen-large (configs/musicgen_large.py)
DECODE_M, PREFILL_M = 4, 4 * 256
HBM_BYTES_PER_S = 3.35e12
F32_PEAK = {"pcie": 51e12, "sxm": 67e12}  # FP32 non-tensor FLOP/s
SEED = 0
TUNE_MAX_EVALS = 150    # per search (greedy, then beam), per contraction
TUNE_BUDGET_S = 30.0    # per search, per contraction


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
                      **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return ((out.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def limit_for(out_dtype) -> float:
    # both accumulate in f32, only the order of summation differs; a bf16
    # output rounds to 8 bits of mantissa (tests/test_kernels.py's 1e-2)
    return 1e-5 if out_dtype == torch.float32 else 1e-2


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

SHAPES = [(1, 1, 1), (4, 33, 96), (33, 200, 4), (96, 96, 96), (200, 1024, 33),
          (1024, 200, 1024), (4, 8192, 2048), (1024, 1024, 200), (1, 1024, 200),
          (33, 4, 1024)]
BLOCKS = [(4, 64, 64), (32, 32, 32), (96, 64, 96), (128, 128, 128), (64, 8192, 256)]
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)]


def phase_kernel(cases_f) -> None:
    from repro_torch.kernels.matmul import launch_plan, matmul, matmul_plain

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    n_cases, worst, failures = 0, {}, []
    for (m, k, n) in SHAPES:
        for (bm, bk, bn) in BLOCKS:
            for order in ("mn", "nm"):
                for dt, odt in DTYPES:
                    for trans_b in (False, True):
                        a = torch.randn(m, k, generator=g, device="cuda").to(dt)
                        b = torch.randn(*((n, k) if trans_b else (k, n)),
                                        generator=g, device="cuda").to(dt)
                        kw = dict(bm=bm, bk=bk, bn=bn, grid_order=order,
                                  out_dtype=odt, trans_b=trans_b)
                        out = matmul(a, b, **kw)
                        plain = matmul_plain(a, b, **kw)
                        torch.cuda.synchronize()
                        err = rel_err(out, plain)
                        lim = limit_for(odt)
                        case = {"mkn": [m, k, n], "block": [bm, bk, bn],
                                "order": order, "in": str(dt), "out": str(odt),
                                "trans_b": trans_b, "rel_err": err, "limit": lim,
                                "plan": launch_plan(m, n, bm, bn, order)}
                        cases_f.write(json.dumps(case) + "\n")
                        key = f"{dt}->{odt}".replace("torch.", "")
                        worst[key] = max(worst.get(key, 0.0), err)
                        n_cases += 1
                        if not err <= lim:
                            failures.append(case)
    emit("kernel", t0, cases=n_cases, worst_rel_err=worst,
         limits={"float32_out": 1e-5, "bfloat16_out": 1e-2},
         failures=failures[:5])
    if failures:
        raise SystemExit(f"{len(failures)} kernel cases outside their limit")


# ---------------------------------------------------------------------------
# phases 4-5: tune, then serve
# ---------------------------------------------------------------------------

CONTRACTIONS = [(m, k, n) for m in (DECODE_M, PREFILL_M)
                for (k, n) in ((D_MODEL, D_MODEL), (D_MODEL, D_FF), (D_FF, D_MODEL))]


def phase_tune(launches) -> tuple:
    from repro_torch.core import LoopTuner, matmul_benchmark

    t0 = time.perf_counter()
    tuner = LoopTuner(policy="search", backend="torch", surrogate="off")
    benches = [matmul_benchmark(*mkn) for mkn in CONTRACTIONS]
    rows = []
    mark = [launches(), time.perf_counter(), tuner.cache.misses]

    def on_entry(i: int, entry: dict) -> None:
        now = [launches(), time.perf_counter(), tuner.cache.misses]
        m, k, n = CONTRACTIONS[i]
        row = {"mkn": [m, k, n], "base_gflops": entry["base_gflops"],
               "tuned_gflops": entry["gflops"], "actions": entry["actions"],
               "block": entry.get("block"), "grid_order": entry.get("grid_order"),
               "evals": now[2] - mark[2], "tune_s": round(now[1] - mark[1], 3),
               "kernel_launches": now[0] - mark[0]}
        mark[:] = now
        rows.append(row)
        print(json.dumps({"phase": "tune_entry", **row}), flush=True)

    n = len(benches)
    tuner.tune_many(benches, weights=[1.0] * n, budget_s=TUNE_BUDGET_S * n,
                    eval_budget=TUNE_MAX_EVALS * n, on_entry=on_entry)
    stats = tuner.stats()
    emit("tune", t0, contractions=n, evals_cached=stats["cache"]["misses"],
         measurements=stats["measurement"]["measurements"],
         noisy=stats["measurement"]["noisy"], peak_gflops=tuner.backend.peak(),
         registry_size=len(tuner.registry))
    for row in rows:
        if not (row["kernel_launches"] > 0 and row["tuned_gflops"] > 0
                and row["tuned_gflops"] >= row["base_gflops"] and row["block"]):
            raise SystemExit(f"tuning did not run through the kernel: {row}")
    return tuner.registry, rows


def layer_weights(g) -> dict:
    def w(*shape):
        return torch.randn(*shape, generator=g, device="cuda") / shape[0] ** 0.5

    return {"wq": w(D_MODEL, D_MODEL), "wk": w(D_MODEL, D_MODEL),
            "wv": w(D_MODEL, D_MODEL), "w_gate": w(D_MODEL, D_FF),
            "w_up": w(D_MODEL, D_FF), "w_down": w(D_FF, D_MODEL),
            "table": w(VOCAB, D_MODEL)}


def layer_calls(x, wts, tuned_einsum):
    """One layer's dense contractions, as models/layers.py sends them."""
    out = {}
    for name in ("wq", "wk", "wv"):
        out[name] = tuned_einsum("bsk,kn->bsn", x, wts[name])
    gate = tuned_einsum("bsk,kn->bsn", x, wts["w_gate"])
    up = tuned_einsum("bsk,kn->bsn", x, wts["w_up"])
    out["w_gate"], out["w_up"] = gate, up
    h = torch.nn.functional.gelu(gate) * up
    out["w_down"] = tuned_einsum("bsk,kn->bsn", h, wts["w_down"])
    out["logits"] = tuned_einsum("bsd,vd->bsv", x, wts["table"])
    return out, h


def phase_serve(registry, wts, g) -> int:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref

    t0 = time.perf_counter()
    ops.reset_serving_stats()
    n_calls, worst = 0, 0.0
    for batch, seq in ((4, 1), (4, 256)):
        x = torch.randn(batch, seq, D_MODEL, generator=g, device="cuda")
        with ops.serving(registry):
            outs, h = layer_calls(x, wts, ops.tuned_einsum)
        n_calls += len(outs)
        x2 = x.reshape(-1, D_MODEL)
        refs = {name: matmul_ref(x2, wts[name]) for name in
                ("wq", "wk", "wv", "w_gate", "w_up")}
        refs["w_down"] = matmul_ref(h.reshape(-1, D_FF), wts["w_down"])
        refs["logits"] = matmul_ref(x2, wts["table"].t())
        torch.cuda.synchronize()
        for name, out in outs.items():
            ref = refs[name]
            if out.shape[:-1] != x.shape[:-1] or not torch.isfinite(out).all():
                raise SystemExit(f"serve {name}: bad output {tuple(out.shape)}")
            err = rel_err(out.reshape(ref.shape), ref)
            worst = max(worst, err)
            if not err <= 1e-5:
                raise SystemExit(f"serve {name} (batch {batch}, seq {seq}): "
                                 f"rel err {err} > 1e-5")
    stats = ops.serving_stats()
    emit("serve", t0, calls=n_calls, hits=stats["hits"], misses=stats["misses"],
         routed=stats["routed"], worst_rel_err=worst, limit=1e-5)
    if stats["routed"] != n_calls:
        raise SystemExit(f"routed {stats['routed']} of {n_calls} tuned_einsum calls")
    return n_calls


# ---------------------------------------------------------------------------
# phase 6: timing against the bound and the library yardstick
# ---------------------------------------------------------------------------


def time_ms(fn, flush: torch.Tensor, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` launches, each after overwriting a
    buffer larger than L2 (a layer's weights are cold when it runs)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def phase_timing(registry, card: str, g) -> list:
    from repro_torch.core.registry import current_hardware
    from repro_torch.kernels.matmul import launch_plan, matmul, matmul_plain

    t0 = time.perf_counter()
    peak = F32_PEAK["pcie" if "PCIe" in card else "sxm"]
    flush = torch.empty(64 * 1024 * 1024 // 4 * 2, device="cuda")  # 128 MiB
    rows = []
    for (m, k, n) in CONTRACTIONS:
        entry = registry.get("mm", (m, k, n), hardware=current_hardware(), exact=True)
        blk = entry["block"]
        order = "nm" if [i for i in entry["grid_order"] if i in "mn"][0] == "n" else "mn"
        tuned = dict(bm=blk["m"], bk=blk["k"], bn=blk["n"], grid_order=order)
        a = torch.randn(m, k, generator=g, device="cuda")
        b = torch.randn(k, n, generator=g, device="cuda")
        out = matmul(a, b, **tuned)
        plain = matmul_plain(a, b, **tuned)
        torch.cuda.synchronize()
        max_abs = (out - plain).abs().max().item()
        err = rel_err(out, plain)
        if not err <= 1e-5:
            raise SystemExit(f"kernel vs plain at {(m, k, n)} block {tuned}: "
                             f"rel err {err} > 1e-5")
        ms = time_ms(lambda: matmul(a, b, **tuned), flush, 20)
        ms_default = time_ms(lambda: matmul(a, b), flush, 20)
        plain_ms = time_ms(lambda: matmul_plain(a, b, **tuned), flush, 3)
        library_ms = time_ms(lambda: torch.matmul(a, b), flush, 20)
        ops_ms = 2 * m * k * n / peak * 1e3
        bytes_ms = (m * k + k * n + m * n) * 4 / HBM_BYTES_PER_S * 1e3
        row = {"mkn": [m, k, n], "block": [blk["m"], blk["k"], blk["n"]],
               "grid_order": order, "plan": launch_plan(m, n, blk["m"], blk["n"], order),
               "ms": ms, "ms_128cubed": ms_default, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "tflops": 2 * m * k * n / ms / 1e9, "max_abs_err": max_abs,
               "rel_err": err}
        rows.append(row)
        print(json.dumps({"phase": "timing_entry", **row}), flush=True)
    del flush
    emit("timing", t0, card=card, fp32_peak_flops=peak, hbm_bytes_per_s=HBM_BYTES_PER_S)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul import matmul

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    emit("device", t0, nvidia_smi=smi, name=card, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    _build.build_all(["matmul"])
    log = str(_build.BUILD_INFO["matmul"]["log"])
    emit("build", t0, kernels=["matmul"],
         nvcc_s=round(float(_build.BUILD_INFO["matmul"]["seconds"]), 3),
         ptxas=sorted({ln.split(":")[-1].strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln}))

    with open(out_dir / "chip_smoke_cases.jsonl", "w") as cases_f:
        phase_kernel(cases_f)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    wts = layer_weights(g)
    matmul.launches = 0  # the main path starts here
    registry, tune_rows = phase_tune(lambda: matmul.launches)
    phase_serve(registry, wts, g)
    main_path_launches = matmul.launches  # ... and ends here
    del wts

    rows = phase_timing(registry, card, g)
    ops_total = sum(2 * r["mkn"][0] * r["mkn"][1] * r["mkn"][2] for r in rows)
    bound_ops = ops_total / F32_PEAK["pcie" if "PCIe" in card else "sxm"] * 1e3
    bound_bytes = sum((r["mkn"][0] * r["mkn"][1] + r["mkn"][1] * r["mkn"][2]
                       + r["mkn"][0] * r["mkn"][2]) * 4 for r in rows) / HBM_BYTES_PER_S * 1e3
    kernels = [{
        "name": "tiled_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:24",
        "launches": main_path_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # one pass over the six musicgen-large contractions at tuned blocks
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": sum(r["library_ms"] for r in rows),
        "shapes": rows,
        "tune": tune_rows,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
