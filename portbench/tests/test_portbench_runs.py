"""Whole runs of each kind of traffic on the CPU at a tiny size: the
program against the plain reference (they agree to f32 rounding), each
fault planted under the timed path coming out not correct, and the
controls' lower precision failing the committed limits at this size."""
import pytest
import torch

import tiny
from yardstick import control, faults, runner

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


def run(cell, seconds=0.3, seed=SEED):
    result = runner.run_cell(cell, seed, seconds, False, CPU, 0.0)
    return result


@pytest.mark.parametrize("frontend,act", [("embeds", "gelu"), ("tokens", "silu")])
def test_prefill_matches_the_reference(frontend, act):
    r = run(tiny.cell("prefill", frontend, act))
    assert r["correct"]
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert checks["logits_rel"] < 1e-5 and checks["kv_rel"] < 1e-5
    assert checks["token_gap"] == 0.0
    assert set(r["metrics"]) == {"prefill_tokens_per_s", "ttft_ms_p95", "setup_s"}
    assert r["attempted"] >= 2 and r["failed"] == 0


def test_tune_serves_what_it_chose():
    r = run(tiny.cell("tune"))
    assert r["correct"] and r["attempted"] % 2 == 0
    assert r["checks"]["served_rel"]["value"] < 1e-5
    assert set(r["metrics"]) == {"tune_s", "setup_s"}


def test_train_matches_the_reference():
    r = run(tiny.cell("train"))
    assert r["correct"]
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert max(checks.values()) < 1e-4, checks
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("kind,fault", [
    ("prefill", lambda: faults.altered_answer("prefill")),
    ("tune", lambda: faults.altered_answer("tune")),
    ("train", faults.unchanged_state),
    ("train", faults.half_batch),
], ids=["prefill-altered-token", "tune-altered-answer", "train-unchanged-state",
        "train-half-batch"])
def test_a_planted_fault_is_not_correct(kind, fault):
    with fault():
        r = run(tiny.cell(kind))
    assert not r["correct"], r["checks"]


def test_a_sampled_wave_the_window_never_reached_fails():
    cell = tiny.cell("prefill")
    cell.traffic = dict(cell.traffic, sample_from=1000, sampled_waves=1)
    r = run(cell, seconds=0.01, seed=3)   # one wave; the sample lies far beyond it
    assert not r["correct"]


def test_a_traced_run_without_device_rows_fails():
    from yardstick.trace import NoDeviceRows

    with pytest.raises(NoDeviceRows):
        runner.run_cell(tiny.cell("tune"), SEED, 0.1, True, CPU, 0.0)


@pytest.mark.parametrize("kind", ["prefill", "tune", "train"])
def test_control_fails_the_limits_at_the_tiny_size(kind):
    cell = tiny.cell(kind)
    numbers = control.CONTROLS[kind](cell, SEED, CPU)
    assert any(numbers[k] > cell.limits[k] for k in cell.limits), numbers
