"""The port's tracer (``repro_torch.tracing``) and the spans at its layer
boundaries, on the CPU; one case on the card.

* Off (no profiler, no ``recording`` block): a span is one shared object
  that records nothing and calls neither ``record_function`` nor a CUDA
  event.
* Under a CPU profiler: spans nest with their parents and attributes, and
  each is a ``user_annotation`` row of the exported chrome trace.
* A new session drops the previous one's records; the cap holds.
* A tiny ``LoopTuner.tune`` on the torch executor (CPU) under the profiler:
  one ``measure.reward`` a measurement, each inside ``tuner.tune`` and a
  search span, lowering inside the rewards; the tuner's counters keep the
  measurement dict under one key.
* A tiny ``make_train_step``: ``train.forward``, ``train.backward`` and
  ``optim.adamw``, in that order.
* On the card: each ``device_s`` positive and no larger than its
  enclosing device span's.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core.loop_ir import matmul_benchmark
from repro_torch.core.registry import ScheduleRegistry
from repro_torch.core.torch_backend import TorchBackend
from repro_torch.core.tuner import LoopTuner
from repro_torch.models import steps as TS
from repro_torch.optim.schedules import constant


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def _ancestors(rec, records):
    names, parent = [], rec.parent
    while parent is not None:
        names.append(records[parent].name)
        parent = records[parent].parent
    return names


@pytest.fixture(autouse=True)
def empty_session():
    """Each test starts after an empty, ended session, whatever ran before
    it in the process."""
    with tracing.recording():
        pass


def test_off_a_span_records_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called while nothing records")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    sp = tracing.span("x", device=True, a=1)
    assert sp is tracing.span("y") and not sp
    with sp as inner:
        inner.set(b=2)
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_spans_nest_and_land_in_the_chrome_trace(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer", a=1) as sp:
            with tracing.span("inner", device=True, b="x"):
                torch.ones(4).sum()
            with tracing.span("inner"):
                pass
            sp.set(c=3)
    recs = tracing.spans()
    assert [r.name for r in recs] == ["outer", "inner", "inner"]
    outer, first, second = recs
    assert outer.parent is None and first.parent == second.parent == outer.index
    assert outer.attrs == {"a": 1, "c": 3} and first.attrs == {"b": "x"}
    assert outer.device_s is None and second.device_s is None
    assert (first.device_s is None) == (not torch.cuda.is_initialized())
    assert outer.start_ns <= first.start_ns <= first.end_ns <= second.start_ns
    assert second.end_ns <= outer.end_ns and outer.host_s > 0
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    rows = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
            if str(e.get("cat", "")).lower() == "user_annotation"]
    assert rows.count("outer") == 1 and rows.count("inner") == 2


def test_a_new_session_drops_the_last_and_the_cap_holds(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("first"):
            pass
    assert [r.name for r in tracing.spans()] == ["first"]
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("second"):
            pass
    assert [r.name for r in tracing.spans()] == ["second"]
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with tracing.recording():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert [r.name for r in tracing.spans()] == ["s0", "s1", "s2"]
    assert tracing.dropped() == 2
    with tracing.recording():          # a block is a session of its own
        with tracing.span("third"):
            pass
    assert [r.name for r in tracing.spans()] == ["third"] and tracing.dropped() == 0


def test_tune_has_one_reward_span_a_measurement():
    backend = TorchBackend(device="cpu", kernel="on", repeats=2, seed=0)
    tuner = LoopTuner(backend=backend, registry=ScheduleRegistry(), policy="search",
                      device="cpu")
    n0 = backend.n_measurements
    with profile(activities=[ProfilerActivity.CPU]):
        tuner.tune(matmul_benchmark(16, 24, 32), "mm", dtype="float32", max_evals=6)
    recs = tracing.spans()
    names = _by_name(recs)
    assert len(names["measure.reward"]) == backend.n_measurements - n0 > 0
    (tune,) = names["tuner.tune"]
    assert tune.attrs == {"key": "mm:16x24x32:float32", "policy": "search"}
    assert [s.attrs["evals"] for s in names["search.greedy"] + names["search.beam"]] \
        and all(s.parent == tune.index for s in names["search.greedy"] + names["search.beam"])
    for r in names["measure.reward"]:
        assert "tuner.tune" in _ancestors(r, recs)
        assert r.attrs["launches"] >= 2 and r.attrs["escalations"] >= 0
    lowers = names["backend.lower"]
    assert lowers and all(recs[r.parent].name == "measure.reward" for r in lowers)
    assert {r.attrs["route"] for r in lowers} == {"matmul"}
    stats = tuner.stats()
    assert "measurement" in stats and "measure" not in stats


def test_train_step_spans():
    cfg = get_config("musicgen-large").smoke()
    params, state = TS.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"embeds": torch.randn(2, 8, cfg.d_model, generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 8), generator=g)}
    step = TS.make_train_step(cfg, constant(1e-3))
    with tracing.recording():
        step(params, state, batch)
    recs = tracing.spans()
    assert [r.name for r in recs] == ["train.forward", "train.backward", "optim.adamw"]
    assert all(r.parent is None for r in recs)
    assert recs[-1].attrs["params"] == sum(p.numel() for p in params.parameters())


@pytest.mark.cuda
def test_device_times_nest_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device spans time CUDA events")
    cfg = get_config("musicgen-large").smoke()
    params, state = TS.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"embeds": torch.randn(2, 64, cfg.d_model, generator=g, device="cuda"),
             "labels": torch.randint(0, cfg.vocab, (2, 64), generator=g, device="cuda")}
    step = TS.make_train_step(cfg, constant(1e-3))
    step(params, state, batch)
    with tracing.recording():
        for _ in range(2):
            with tracing.span("step", device=True):
                step(params, state, batch)
    recs = tracing.spans()
    assert sum(r.name == "step" for r in recs) == 2
    assert sum(r.name == "optim.adamw" for r in recs) == 2
    for r in recs:
        assert r.device_s is not None and r.device_s > 0, r
        if r.parent is not None:
            assert r.device_s <= recs[r.parent].device_s, (r, recs[r.parent])
