"""The benchmark's readers of the port's spans (``portbench/metrics/*.py``
with ``source`` ``program_span``) on hand-built span records, the AdamW
byte floor counted by hand at the tiny size, None where the spans are
absent, and the two tune readers on a real tune's spans."""
import importlib.util
import math
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "portbench"
sys.path[:0] = [str(BENCH / "tests"), str(BENCH)]

import tiny  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.tracing import SpanRecord  # noqa: E402
from yardstick import spec  # noqa: E402
from yardstick.counting import HBM_BYTES_PER_S  # noqa: E402
from yardstick.measure import Run  # noqa: E402


def _module(name):
    path = spec.BENCH_DIR / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


MEASURE = _module("measure_ms_per_eval.tune")
SEARCH = _module("search_host_ms_per_eval.tune")
ADAMW = _module("adamw_roofline.train")


def _rec(name, index, parent, ms, device_s=None):
    return SpanRecord(name, index, parent, 0, int(ms * 1e6), device_s=device_s)


def _tune_records():
    """Two tunes: 10 ms and 6 ms.  Three rewards of 2, 3 and 1 ms, the
    first with 0.5 ms of lowering in it."""
    return [_rec("tuner.tune", 0, None, 10.0), _rec("search.greedy", 1, 0, 9.0),
            _rec("measure.reward", 2, 1, 2.0), _rec("backend.lower", 3, 2, 0.5),
            _rec("measure.reward", 4, 1, 3.0),
            _rec("tuner.tune", 5, None, 6.0), _rec("search.beam", 6, 5, 5.0),
            _rec("measure.reward", 7, 6, 1.0), _rec("backend.lower", 8, 6, 0.25)]


def test_tune_readers_on_hand_built_spans():
    recs = _tune_records()
    m, s = MEASURE.value(recs), SEARCH.value(recs)
    # self times 1.5, 3 and 1 ms (the second lowering sits under a search span)
    assert m == pytest.approx(5.5 / 3)
    assert s == pytest.approx((16.0 - 5.5) / 3)
    assert m + s == pytest.approx(16.0 / 3)      # the window's cost of one evaluation


def test_adamw_floor_by_hand_at_the_tiny_size():
    mod, model = ADAMW, dict(tiny.TINY_MODEL)
    # embed and head 2 x 128 x 64, final norm 64, two norms 2 x 2 x 64,
    # q k v o 4 x 2 x 64 x 64, gate up down 3 x 2 x 64 x 96
    elems = 2 * 128 * 64 + 64 + 2 * 2 * 64 + 4 * 2 * 64 * 64 + 3 * 2 * 64 * 96
    assert elems == 86336
    # f32, no master: grad read twice (8), moments read and written (16),
    # the parameter read and written (8)
    assert mod.floor_bytes(model) == elems * 32
    # bf16 with an f32 master: grad 2 x 2, moments and master 24, parameter written 2
    assert mod.floor_bytes(dict(model, dtype="bfloat16")) == elems * 30
    recs = [_rec("train.forward", 0, None, 2.0, device_s=2e-3),
            _rec("optim.adamw", 1, None, 1.0, device_s=1e-3),
            _rec("train.forward", 2, None, 2.0, device_s=2e-3),
            _rec("optim.adamw", 3, None, 1.0, device_s=3e-3)]
    want = 100.0 * 2 * (elems * 32 / HBM_BYTES_PER_S) / 4e-3
    assert mod.value(recs, model) == pytest.approx(want)
    # host-only records (no device time) read nothing
    assert mod.value([_rec("optim.adamw", 0, None, 1.0)], model) is None


def test_none_where_the_spans_are_absent():
    with tracing.recording():
        pass                                   # the latest session holds nothing
    tune_run = Run("tune", tiny.TINY_MODEL, {}, 1.0, 1)
    train_run = Run("train", tiny.TINY_MODEL, {}, 1.0, 1, 2, 16)
    assert MEASURE.read(tune_run) is None and SEARCH.read(tune_run) is None
    assert ADAMW.read(train_run) is None
    no_rewards = [r for r in _tune_records() if r.name != "measure.reward"]
    assert MEASURE.value(no_rewards) is None and SEARCH.value(no_rewards) is None
    # a reader reads only its own kind's runs
    assert MEASURE.read(Run("prefill", tiny.TINY_MODEL, {}, 1.0, 1)) is None
    assert ADAMW.read(tune_run) is None


def test_none_on_a_program_without_the_tracer(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)   # import fails
    assert MEASURE.read(Run("tune", tiny.TINY_MODEL, {}, 1.0, 1)) is None
    assert SEARCH.read(Run("tune", tiny.TINY_MODEL, {}, 1.0, 1)) is None
    assert ADAMW.read(Run("train", tiny.TINY_MODEL, {}, 1.0, 1, 2, 16)) is None


def test_tune_readers_on_a_real_tune():
    from repro_torch.core.loop_ir import matmul_benchmark
    from repro_torch.core.registry import ScheduleRegistry
    from repro_torch.core.torch_backend import TorchBackend
    from repro_torch.core.tuner import LoopTuner

    backend = TorchBackend(device="cpu", kernel="on", repeats=2, seed=0)
    n0 = backend.n_measurements
    with tracing.recording():
        for mkn in [(16, 24, 32), (24, 16, 16)]:
            LoopTuner(backend=backend, registry=ScheduleRegistry(), policy="search",
                      device="cpu").tune(matmul_benchmark(*mkn), "mm", max_evals=4)
    recs = tracing.spans()
    n = backend.n_measurements - n0
    assert sum(r.name == "measure.reward" for r in recs) == n > 0
    run = Run("tune", tiny.TINY_MODEL, {}, 1.0, 2)
    m, s = MEASURE.read(run), SEARCH.read(run)
    assert m > 0 and s > 0 and math.isfinite(m + s)
    tune_ms = 1e3 * sum(r.host_s for r in recs if r.name == "tuner.tune")
    assert m + s == pytest.approx(tune_ms / n)
