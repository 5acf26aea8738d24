"""The benchmark's RWKV-6 cell (``rwkv6-7b.prefill-4x4096``) on the CPU: the
cell resolves and its committed schedules cover its dense sites; the
helper's counts (``portbench/yardstick/rwkv6.py``) against arithmetic
written out here; the five ``*.prefill_rwkv6`` readers on hand-built runs
and span records; the program's ``rwkv6.mix`` and ``rwkv6.scan`` spans;
and whole runs of the kind at a tiny size (correct; planted faults and
both controls reading far above the program)."""
import copy
import importlib
import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "portbench"
sys.path[:0] = [str(BENCH)]

from repro_torch import tracing  # noqa: E402
from repro_torch.models import steps as S  # noqa: E402
from repro_torch.tracing import SpanRecord  # noqa: E402
from yardstick import counting as N  # noqa: E402
from yardstick import rwkv6 as R  # noqa: E402
from yardstick import runner, spec  # noqa: E402
from yardstick import weights as W  # noqa: E402
from yardstick.measure import Run  # noqa: E402
from yardstick.trace import TraceSummary  # noqa: E402

CELL = "rwkv6-7b.prefill-4x4096"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 1201
TINY = {"name": "rwkv6-tiny", "n_layers": 2, "d_model": 128, "head_dim": 32, "n_heads": 4,
        "n_kv_heads": 4, "d_ff": 192, "vocab": 512, "mix_lora": 8, "decay_lora": 16,
        "frontend": "tokens", "dtype": "float32"}


def _reader(name):
    path = spec.BENCH_DIR / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


MFU = _reader("step_mfu.prefill_rwkv6")
MATMUL = _reader("tiled_matmul_roofline.prefill_rwkv6")
SCAN = _reader("rwkv6_scan_roofline.prefill_rwkv6")
MIX = _reader("rwkv6_mix_roofline.prefill_rwkv6")
IDLE = _reader("device_idle_share.prefill_rwkv6")


def _tiny_cell(dtype="float32"):
    """The committed cell at the tiny size: two clients of 128 tokens (one
    scan chunk, no padded rows)."""
    real = spec.load_cell(CELL)
    traffic = dict(real.traffic, clients=2, prompt_len=128, max_len=136, warmup_waves=1,
                   sample_from=1, sampled_waves=1, traced_waves=1)
    config = copy.deepcopy(real.config)
    config["model"] = dict(TINY, dtype=dtype)
    config["schedules"] = {"entries": [
        {"m": m, "k": k, "n": n, "dtype": dt, "gflops": 1.0,
         "block": {"m": 16, "k": 16, "n": 16}, "grid_order": ["m", "n", "k"]}
        for m, k, n, dt in R.dense_keys(config["model"], 2 * 128)]}
    return spec.Cell(real.name, 1, config, traffic, dict(real.limits), real.end_to_end,
                     real.per_layer)


def test_the_cell_resolves():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "prefill_rwkv6"
    assert importlib.import_module("yardstick.kinds.prefill_rwkv6").KIND == "prefill_rwkv6"
    assert cell.reference().__name__ == "reference.rwkv6_7b"
    assert set(cell.limits) == {"logits_rel", "state_rel", "token_gap", "scan_rel"}
    assert [m["name"] for m in cell.end_to_end] == ["prefill_tokens_per_s", "ttft_ms_p95",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "step_mfu.prefill_rwkv6", "tiled_matmul_roofline.prefill_rwkv6",
        "rwkv6_scan_roofline.prefill_rwkv6", "rwkv6_mix_roofline.prefill_rwkv6",
        "device_idle_share.prefill_rwkv6"]
    m = cell.model
    assert (m["n_layers"], m["d_model"], m["head_dim"], m["d_ff"], m["vocab"],
            m["mix_lora"], m["decay_lora"]) == (32, 4096, 64, 14336, 65536, 64, 128)
    assert cell.config["reduced"] == [] and cell.config["published"]["n_layers"] == 32
    assert R.model_config(m).param_count() == 7_635_472_384


def test_committed_schedules_cover_the_dense_keys():
    cell = spec.load_cell(CELL)
    keys = R.dense_keys(cell.model, 4 * 4096)
    bf16 = "bfloat16"
    assert keys == {(16384, 4096, 4096, bf16): 192, (16384, 4096, 14336, bf16): 32,
                    (16384, 14336, 4096, bf16): 32, (16384, 4096, 65536, bf16): 1}
    have = {(e["m"], e["k"], e["n"], e["dtype"]) for e in cell.config["schedules"]["entries"]}
    assert set(keys) <= have
    # the helper's keys are the decoder's set (which make_schedules.py reads)
    assert set(keys) == set(N.dense_keys(cell.model, 4 * 4096))


def test_counts_by_hand_at_the_published_widths():
    m = spec.load_cell(CELL).model
    d, ff, v = 4096, 14336, 65536
    # per token and layer: eight products, 2 (5 d^2 + d^2 + 2 d ff); ddlerp's
    # LoRA 2 (d 320 + 320 d); the decay's 2 (d 128 + 128 d); the scan 4 H N^2
    per_layer = 2 * (6 * d * d + 2 * d * ff) + 2 * 640 * d + 2 * 256 * d + 4 * 64 * 64 * 64
    assert per_layer == 444_596_224
    assert R.model_flops(m, 4, 4096) == 16384 * (32 * per_layer + 2 * d * v)
    assert R.model_flops(m, 4, 4096) == pytest.approx(241.90e12, rel=1e-4)
    flops, nbytes = R.scan_work(m, 4, 4096)
    assert flops == 16384 * 4 * 64 * 64 * 64
    # r, k, v bf16, logw and y f32; the carried and final states; u
    assert nbytes == 16384 * d * (3 * 2 + 4 + 4) + 2 * 4 * 64 * 64 * 64 * 4 + d * 4
    assert N.bound_s(flops, nbytes, peak=R.PEAK_F32_FLOPS) == nbytes / N.HBM_BYTES_PER_S
    flops, nbytes = R.mix_work(m, 4, 4096)
    assert flops == 16384 * (2 * 640 * d + 2 * 256 * d)
    # x read, five streams written at bf16, logw at f32; the carry; the LoRAs
    # (bf16 and f32), six mu and w0
    assert nbytes == (16384 * d * (2 + 10 + 4) + 4 * d * 2 + 640 * d * 2 + 256 * d * 4
                      + 7 * d * 4)
    assert N.bound_s(flops, nbytes) == nbytes / N.HBM_BYTES_PER_S


def _run(trace=None, steps=20):
    cell = spec.load_cell(CELL)
    run = Run("prefill_rwkv6", cell.model, cell.traffic, 30.0, steps, 4, 4096)
    run.trace, run.traced_steps = trace, 6
    return run


def test_step_mfu_and_matmul_roofline_on_a_hand_built_run():
    run = _run()
    want = 100.0 * 20 * R.model_flops(run.model, 4, 4096) / (989e12 * 30.0)
    assert MFU.read(run) == pytest.approx(want) and MFU.read(run) == pytest.approx(16.306,
                                                                                    abs=1e-3)
    assert MATMUL.read(run) is None                      # no trace
    run.trace = TraceSummary(1.0, 0.9, {"tiled_matmul": 3.0}, [], [])
    # 192 (d, d), 32 (d, ff), 32 (ff, d) and the head: compute-bound each
    bound = (192 * 2 * 16384 * 4096 * 4096 + 64 * 2 * 16384 * 4096 * 14336
             + 2 * 16384 * 4096 * 65536) / 989e12
    assert MATMUL.read(run) == pytest.approx(100.0 * 6 * bound / 3.0)
    run.trace = TraceSummary(1.0, 0.9, {"other": 3.0}, [], [])
    assert MATMUL.read(run) is None
    other = Run("prefill", run.model, run.traffic, 30.0, 20, 4, 4096)
    assert MFU.read(other) is None and SCAN.read(other) is None and MIX.read(other) is None


def test_idle_share_reads_the_trace_of_this_kind_alone():
    run = _run()
    assert IDLE.read(run) is None                        # no trace
    run.trace = TraceSummary(2.0, 1.9, {"tiled_matmul": 1.5}, [], [])
    assert IDLE.read(run) == pytest.approx(100.0 * run.trace.idle_share)
    assert IDLE.read(run) == pytest.approx(5.0)
    other = Run("prefill", run.model, run.traffic, 30.0, 20, 4, 4096)
    other.trace = run.trace
    assert IDLE.read(other) is None


def _rec(name, index, device_s):
    return SpanRecord(name, index, None, 0, 1000, device_s=device_s)


def test_scan_and_mix_readers_on_hand_built_spans():
    model = spec.load_cell(CELL).model
    recs = [_rec("rwkv6.mix", 0, 2e-3), _rec("rwkv6.scan", 1, 1e-3),
            _rec("rwkv6.mix", 2, 4e-3), _rec("rwkv6.scan", 3, 3e-3),
            _rec("train.forward", 4, 1.0)]
    scan_bound = R.scan_work(model, 4, 4096)[1] / N.HBM_BYTES_PER_S
    mix_bound = R.mix_work(model, 4, 4096)[1] / N.HBM_BYTES_PER_S
    assert SCAN.value(recs, model, 4, 4096) == pytest.approx(100.0 * 2 * scan_bound / 4e-3)
    assert MIX.value(recs, model, 4, 4096) == pytest.approx(100.0 * 2 * mix_bound / 6e-3)
    assert scan_bound == pytest.approx(0.2830e-3, rel=1e-3)   # 948 MB
    assert mix_bound == pytest.approx(0.3234e-3, rel=1e-3)    # 1.083 GB
    # host-only records (no device time) and no records read nothing
    assert SCAN.value([_rec("rwkv6.scan", 0, None)], model, 4, 4096) is None
    assert MIX.value([], model, 4, 4096) is None


def test_readers_read_nothing_on_a_program_without_the_tracer(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)   # import fails
    assert SCAN.read(_run()) is None and MIX.read(_run()) is None


def _tiny_prefill(waves):
    model = dict(TINY)
    w = R.make(model, SEED, CPU)
    params = R.port_params(w, model)
    prefill = S.make_prefill_step(R.model_config(model), 40)
    for i in range(waves):
        prefill(params, W.prompt(model, SEED, i, 2, 32, CPU))


def test_the_spans_record_once_a_layer_a_wave_and_nothing_when_off():
    with tracing.recording():
        _tiny_prefill(2)
    names = [r.name for r in tracing.spans()]
    assert names.count("rwkv6.mix") == names.count("rwkv6.scan") == 2 * 2
    # every mix closes before its layer's scan opens
    assert names == ["rwkv6.mix", "rwkv6.scan"] * 4
    with tracing.recording():
        pass                                            # an empty session
    _tiny_prefill(1)                                    # nothing records
    assert tracing.spans() == []


def test_a_tiny_run_is_correct_and_reads_its_end_to_end_metrics():
    r = runner.run_cell(_tiny_cell(), SEED, 0.3, False, CPU, 0.0)
    assert r["correct"], r["checks"]
    checks = {k: v["value"] for k, v in r["checks"].items()}
    # f32 against f32: the scan's chunking and the reference's differ in order
    assert checks["logits_rel"] < 1e-5 and checks["state_rel"] < 1e-5
    assert 0.0 < checks["scan_rel"] < 1e-5
    assert checks["token_gap"] == 0.0
    assert set(r["metrics"]) == {"prefill_tokens_per_s", "ttft_ms_p95", "setup_s"}
    assert r["attempted"] >= 2 and r["failed"] == 0


def _checks(r):
    return {k: v["value"] for k, v in r["checks"].items()}


@pytest.mark.parametrize("term", ["ddlerp", "decay_lora"])
def test_a_dropped_mechanism_reads_far_above_the_program(term):
    """Each planted fault moves the compared numbers by over 10x the
    program's own (f32 here); ddlerp's fails the committed limits even at
    this size (the decay LoRA's 0.1 on two layers lies under limits set for
    32 layers in bf16; on the card it is read at the cell's size)."""
    own = _checks(runner.run_cell(_tiny_cell(), SEED, 0.3, False, CPU, 0.0))
    with R.dropped(term):
        r = runner.run_cell(_tiny_cell(), SEED, 0.3, False, CPU, 0.0)
    fault = _checks(r)
    for k in ("logits_rel", "state_rel"):
        assert fault[k] > 10 * own[k] and fault[k] > 0.05, (k, own, fault)
    assert r["correct"] == (term != "ddlerp"), fault


def test_a_sampled_wave_the_window_never_reached_fails():
    cell = _tiny_cell()
    cell.traffic = dict(cell.traffic, sample_from=1000, sampled_waves=1)
    r = runner.run_cell(cell, 3, 0.01, False, CPU, 0.0)
    assert not r["correct"] and math.isnan(r["checks"]["logits_rel"]["value"])


def test_the_control_reads_far_above_the_program_at_the_tiny_size():
    """fp8 products in the program's place read several times the bf16
    program's own readings (on the card the control's readings set the
    limits' upper ends)."""
    cell = _tiny_cell("bfloat16")
    numbers = R.control(cell, SEED, CPU)
    own = _checks(runner.run_cell(cell, SEED, 0.3, False, CPU, 0.0))
    for k in ("logits_rel", "state_rel"):
        assert numbers[k] > 5 * own[k], (k, own, numbers)
    assert numbers["token_gap"] > max(0.1, 5 * own["token_gap"]), (own, numbers)


def test_the_bf16_scan_control_reads_far_above_the_program_at_the_tiny_size():
    """logw and the WKV state in bf16 read scan_rel far above the program's
    own (f32 scan against the f32 recurrence) and above its limit; the fp8
    control leaves the recurrence f32 (scan_rel 0)."""
    cell = _tiny_cell("bfloat16")
    numbers = R.control(cell, SEED, CPU, "bf16_scan")
    own = _checks(runner.run_cell(cell, SEED, 0.3, False, CPU, 0.0))
    assert numbers["scan_rel"] > 100 * own["scan_rel"], (own, numbers)
    assert numbers["scan_rel"] > cell.limits["scan_rel"], numbers
    assert R.control(cell, SEED, CPU, "fp8")["scan_rel"] == 0.0
    with pytest.raises(ValueError, match="fp8"):
        R.control(cell, SEED, CPU, "fp16")


def test_a_scan_without_its_bonus_fails_scan_rel(monkeypatch):
    """The scan with its u-bonus dropped, planted in the program: scan_rel
    reads it, layer by layer, far above its limit."""
    from repro_torch.kernels import ops as K

    real = K.rwkv6_chunk_scan
    monkeypatch.setattr(K, "rwkv6_chunk_scan",
                        lambda r, k, v, logw, u, **kw: real(r, k, v, logw, 0 * u, **kw))
    r = runner.run_cell(_tiny_cell(), SEED, 0.3, False, CPU, 0.0)
    assert not r["correct"]
    assert _checks(r)["scan_rel"] > 10 * r["checks"]["scan_rel"]["limit"]


def test_scan_checked_refuses_a_carried_state():
    from repro_torch.kernels import ops as K

    ref = spec.load_cell(CELL).reference()
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 16, 2, 8, generator=g) for _ in range(3))
    logw, u = -torch.rand(1, 16, 2, 8, generator=g), torch.randn(2, 8, generator=g)
    out = {}
    with R.scan_checked(ref, out):
        K.rwkv6_chunk_scan(r, k, v, logw, u, chunk=16, s0=torch.zeros(1, 2, 8, 8))
        with pytest.raises(ValueError, match="zero"):
            K.rwkv6_chunk_scan(r, k, v, logw, u, chunk=16, s0=torch.ones(1, 2, 8, 8))
    assert K.rwkv6_chunk_scan.__name__ == "rwkv6_chunk_scan" and out["scan_rel"] < 1e-5


def test_a_program_without_finchs_ranks_fails_before_drawing(monkeypatch):
    """The parent of this cell's program has no ``rwkv_mix_lora``: the run
    stops at the configuration, in seconds."""
    import dataclasses

    from repro_torch.configs import base

    fields = [(f.name, f.type, f) for f in dataclasses.fields(base.ModelConfig)
              if f.name not in ("rwkv_mix_lora", "rwkv_decay_lora")]
    old = dataclasses.make_dataclass("ModelConfig", fields, frozen=True)
    monkeypatch.setattr(base, "ModelConfig", old)
    with pytest.raises(TypeError, match="rwkv_mix_lora"):
        runner.run_cell(_tiny_cell(), SEED, 0.3, False, CPU, 0.0)
