"""The tuning entry point (``launch/tune``, ``serve --tune``), in both
packages on the same inputs: journals written by either package load and
resume in the other, a torn tail included; the harvest of musicgen-large's
smoke config holds the reference's dense contractions with equal keys and
counts and the reference's FLOP shares renormalised over them (1e-12);
``tune_model`` persists entries the registry finds; resume skips journaled
work and a crash mid-tune leaves one journal line; ``serve --tune`` serves
from the table it tuned; and the options the port does not have raise.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.core.registry import ScheduleRegistry as RReg
from repro.core.tuner import LoopTuner as RTuner
from repro.launch import tune as RTUNE
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.registry import ScheduleRegistry
from repro_torch.core.tuner import LoopTuner
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import tune as TTUNE
from repro_torch.models import transformer as T

SHAPES = dict(batch=2, prompt_len=8, max_len=16)
SHARE_TOL = 1e-12
PKG = {"jax": RTUNE, "port": TTUNE}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small models: test workers share the
    host's cores, and torch's thread pool thrashes under that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records():
    return [
        {"m": 64, "k": 64, "n": 64, "dtype": "float32", "flop_share": 0.5},
        {"m": 48, "k": 48, "n": 48, "dtype": "float32", "flop_share": 0.3},
        {"m": 32, "k": 32, "n": 32, "dtype": "float32", "flop_share": 0.2},
    ]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_loads_across_the_packages(tmp_path, writer, reader):
    path = str(tmp_path / "tune.journal.jsonl")
    w = PKG[writer].TuneJournal(path)
    assert w.key_of(64, 64, 64) == PKG[reader].TuneJournal.key_of(64, 64, 64)
    w.append("mm:64x64x64:float32", {"gflops": 1.0, "block": {"m": 64}})
    w.append("mm:48x48x48:bfloat16", {"gflops": 2.0})
    with open(path, "a") as f:  # a kill mid-append leaves a torn tail
        f.write('{"key": "mm:32x32')
    done = PKG[reader].TuneJournal(path).load()
    assert done == PKG[writer].TuneJournal(path).load()
    assert done == {"mm:64x64x64:float32": {"gflops": 1.0, "block": {"m": 64}},
                    "mm:48x48x48:bfloat16": {"gflops": 2.0}}
    with open(path, "w") as f:  # a torn line mid-file warns and is skipped
        f.write('{"key": "a", "entry": {"gflops": 1}}\nGARBAGE\n'
                '{"key": "b", "entry": {"gflops": 2}}\n')
    with pytest.warns(UserWarning, match="corrupt line"):
        assert set(PKG[reader].TuneJournal(path).load()) == {"a", "b"}


def _tuner(pkg, reg):
    if pkg == "jax":
        return RTuner(policy="default", backend="tpu", registry=reg)
    return LoopTuner(policy="default", backend="tpu", registry=reg, device="cpu")


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_resume_across_the_packages_skips_every_journaled_contraction(
        tmp_path, writer, reader):
    reg_cls = {"jax": RReg, "port": ScheduleRegistry}
    jpath, reg_path = str(tmp_path / "j.jsonl"), str(tmp_path / "reg.json")
    reg = reg_cls[writer](reg_path)
    PKG[writer].tune_records(_records(), tuner=_tuner(writer, reg), registry=reg,
                             registry_path=reg_path, budget_s=0.2,
                             journal=PKG[writer].TuneJournal(jpath))
    reg2 = reg_cls[reader](reg_path)
    tuner = _tuner(reader, reg2)
    tuner.tune = lambda *a, **kw: pytest.fail("a journaled contraction was re-tuned")
    entries, n_skipped = PKG[reader].tune_records(
        _records(), tuner=tuner, registry=reg2, registry_path=reg_path, budget_s=0.2,
        journal=PKG[reader].TuneJournal(jpath), resume=True)
    assert n_skipped == 3 and all(e["resumed"] for e in entries)


def test_tune_records_journals_and_flushes_per_contraction(tmp_path):
    reg_path, jpath = str(tmp_path / "reg.json"), str(tmp_path / "reg.json.journal.jsonl")
    reg = ScheduleRegistry(reg_path)
    entries, n_skipped = TTUNE.tune_records(
        _records(), tuner=_tuner("port", reg), registry=reg, registry_path=reg_path,
        budget_s=0.2, journal=TTUNE.TuneJournal(jpath))
    assert len(entries) == 3 and n_skipped == 0
    with open(jpath) as f:
        assert len(f.read().splitlines()) == 3
    assert len(ScheduleRegistry(reg_path)) == 3  # flushed without a final save


def test_resume_after_a_crash_mid_tune_retunes_only_unfinished(tmp_path):
    reg_path, jpath = str(tmp_path / "reg.json"), str(tmp_path / "journal.jsonl")

    class _CrashyTuner(LoopTuner):
        """Dies after the first contraction — the mid-run kill."""

        tunes = 0

        def tune(self, *a, **kw):
            if _CrashyTuner.tunes >= 1:
                raise RuntimeError("simulated mid-run kill")
            _CrashyTuner.tunes += 1
            return super().tune(*a, **kw)

    reg = ScheduleRegistry(reg_path)
    crashy = _CrashyTuner(policy="default", backend="tpu", registry=reg, device="cpu")
    with pytest.raises(RuntimeError, match="mid-run kill"):
        TTUNE.tune_records(_records(), tuner=crashy, registry=reg, registry_path=reg_path,
                           budget_s=0.2, journal=TTUNE.TuneJournal(jpath))
    with open(jpath) as f:
        assert len(f.read().splitlines()) == 1  # one journal line, durable
    assert len(ScheduleRegistry(reg_path)) == 1

    calls = []
    reg2 = ScheduleRegistry(reg_path)
    tuner2 = _tuner("port", reg2)
    orig = tuner2.tune
    tuner2.tune = lambda b, *a, **kw: calls.append(b) or orig(b, *a, **kw)
    entries, n_skipped = TTUNE.tune_records(
        _records(), tuner=tuner2, registry=reg2, registry_path=reg_path, budget_s=0.2,
        journal=TTUNE.TuneJournal(jpath), resume=True)
    assert n_skipped == 1 and len(entries) == 3
    assert entries[0].get("resumed") is True
    assert "resumed" not in entries[1] and "resumed" not in entries[2]
    assert {c.iter_sizes["m"] for c in calls} == {48, 32}
    assert len(ScheduleRegistry(reg_path)) == 3 and len(TTUNE.TuneJournal(jpath).load()) == 3


def test_fresh_run_resets_a_stale_journal(tmp_path):
    j = TTUNE.TuneJournal(str(tmp_path / "journal.jsonl"))
    j.append("mm:999x999x999:float32", {"gflops": 9.0})
    reg = ScheduleRegistry(str(tmp_path / "reg.json"))
    TTUNE.tune_records(_records()[:1], tuner=_tuner("port", reg), registry=reg,
                       registry_path=reg.path, budget_s=0.1, journal=j)
    assert set(j.load()) == {"mm:64x64x64:float32"}


# ---------------------------------------------------------------------------
# The harvest
# ---------------------------------------------------------------------------


def _dense_shapes(cfg):
    """(k, n) of every weight a dense site multiplies by, either way round
    (the logits contract against the ``(vocab, d)`` table)."""
    shapes = {tuple(p.shape[-2:]) for p in T.init_params(cfg, None, "meta").parameters()
              if p.ndim >= 2}
    return shapes | {(n, k) for k, n in shapes}


def test_harvest_matches_the_reference_on_the_dense_sites():
    ref = RTUNE.harvest_model(r_get_config("musicgen-large").smoke(), **SHAPES)
    cfg = t_get_config("musicgen-large").smoke()
    got = TTUNE.harvest_model(cfg, device="cpu", **SHAPES)
    dense = _dense_shapes(cfg)
    ref_dense = [r for r in ref if (r["k"], r["n"]) in dense]
    assert len(ref_dense) < len(ref)  # the reference also holds attention's dots

    def by_key(recs):
        return {(r["m"], r["k"], r["n"], r["dtype"]): r for r in recs}

    want, have = by_key(ref_dense), by_key(got)
    assert set(have) == set(want)
    assert {k: r["count"] for k, r in have.items()} == {k: r["count"] for k, r in want.items()}
    assert {k: r["flops"] for k, r in have.items()} == {k: r["flops"] for k, r in want.items()}
    total = sum(r["flop_share"] for r in ref_dense)
    for k, r in have.items():
        assert abs(r["flop_share"] - want[k]["flop_share"] / total) <= SHARE_TOL, k
    assert [r["flops"] for r in got] == sorted((r["flops"] for r in got), reverse=True)
    assert abs(sum(r["flop_share"] for r in got) - 1.0) <= SHARE_TOL


def test_tune_model_persists_entries_the_registry_finds(tmp_path):
    reg_path = str(tmp_path / "reg.json")
    report = TTUNE.tune_model("musicgen-large", registry_path=reg_path, backend="tpu",
                              device="cpu", budget_s=1.0, eval_budget=80,
                              journal_path=reg_path + ".journal.jsonl", **SHAPES)
    assert report["arch"] == "musicgen-large-smoke"
    assert report["n_tuned"] == report["n_harvested"] == 8 and report["n_skipped"] == 0
    assert report["flop_share_covered"] == pytest.approx(1.0, abs=SHARE_TOL)
    reg = ScheduleRegistry(reg_path)
    for c in report["contractions"]:
        entry = reg.get("mm", (c["m"], c["k"], c["n"]), c["dtype"])
        assert entry and "block" in entry and entry["backend"] == "tpu"
    assert len(TTUNE.TuneJournal(reg_path + ".journal.jsonl").load()) == 8
    again = TTUNE.tune_model("musicgen-large", registry_path=reg_path, backend="tpu",
                             device="cpu", journal_path=reg_path + ".journal.jsonl",
                             resume=True, **SHAPES)
    assert again["n_skipped"] == 8 and all(c["resumed"] for c in again["contractions"])


def test_serve_tune_serves_from_the_table_it_tuned(tmp_path, capsys):
    reg_path = str(tmp_path / "reg.json")
    assert TSERVE.main(["--tune", "--registry", reg_path, "--device", "cpu",
                        "--requests", "2", "--batch", "2", "--prompt-len", "8",
                        "--gen-len", "2", "--max-len", "16", "--tune-budget-s", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    tuned = json.loads(next(ln for ln in lines if ln.startswith("[serve] tuned:"))
                       .split(":", 1)[1])
    done = json.loads(next(ln for ln in lines if ln.startswith("[serve] done:"))
                      .split(":", 1)[1])
    assert tuned["n_tuned"] == 8 and tuned["flop_share_covered"] == pytest.approx(1.0)
    serving = done["registry"]["serving"]
    assert serving["hits"] > 0 and serving["misses"] == 0
    # the tuned keys are the served ones: serve's own shapes, not tune's defaults
    assert {k.split(":")[1].split("x")[0] for k in serving["per_key"]} == {"2", "16"}
    with pytest.raises(SystemExit):
        TSERVE.main(["--tune", "--device", "cpu"])


@pytest.mark.parametrize("extra", [["--farm", "127.0.0.1:1"], ["--fleet", "2"],
                                   ["--kernel-cache", "kdir"]])
def test_options_the_port_does_not_have_raise(tmp_path, extra):
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        TTUNE.main(["--arch", "musicgen-large", "--registry", str(tmp_path / "r.json"),
                    "--backend", "tpu", "--device", "cpu", *extra])
    assert not (tmp_path / "r.json").exists()


def test_kernel_cache_off_is_no_cache(tmp_path):
    reg = str(tmp_path / "r.json")
    assert TTUNE.main(["--arch", "musicgen-large", "--registry", reg, "--backend", "tpu",
                       "--device", "cpu", "--kernel-cache", "off", "--budget-s", "0.5",
                       "--batch", "2", "--prompt-len", "8", "--max-len", "16"]) == 0
    assert len(ScheduleRegistry(reg)) == 8 and len(TTUNE.TuneJournal(reg + ".journal.jsonl")
                                                   .load()) == 8
    assert not (tmp_path / "r.json.kernels").exists()


def test_the_card_is_the_default_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = t_get_config("musicgen-large").smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        TTUNE.harvest_model(cfg, **SHAPES)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTUNE.tune_model(cfg, **SHAPES)


def test_the_entry_point_and_trainers_import_neither_jax_nor_the_jax_package():
    code = ("import sys, repro_torch.launch.tune, repro_torch.core.ppo, "
            "repro_torch.core.a2c, repro_torch.core.impala\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir,
                                                     "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert out.strip() == "[]"
