"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""
import json
import re

import pytest

from yardstick import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:   # each listed cell reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert (spec.BENCH_DIR / "yardstick" / "kinds" / f"{c.traffic['kind']}.py").exists()
    assert c.reference().ACT is not None
    assert c.limits and all(v > 0 for v in c.limits.values())
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_configs_used_and_files():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]} and len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["model"]["name"] == c["name"]
        for key, value in cfg["published"].items():   # published widths, nothing cut
            assert cfg["model"][key] == value


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]
                                  if w["traffic"].startswith("prefill")])
def test_committed_schedules_cover_the_cell(cell):
    from yardstick import counting as N

    c = spec.load_cell(cell)
    sched = c.config["schedules"]
    assert sched["command"] and sched["card"] and sched["date"]
    have = {(e["m"], e["k"], e["n"], e["dtype"]) for e in sched["entries"]}
    t = c.traffic
    assert set(N.dense_keys(c.model, t["clients"] * t["prompt_len"])) <= have
