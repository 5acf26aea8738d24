"""The entry point on a host without a card, and the modules a run loads."""
import json
import subprocess
import sys

from yardstick import spec

RUN = spec.BENCH_DIR / "run.py"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(RUN), "--workload",
                          "musicgen-large.prefill-8x1024", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole tiny run of each kind, in a fresh process that imports the
    entry point, and then the top-level names of ``sys.modules``."""
    code = f"""
import json, sys, torch
sys.path[:0] = [{str(spec.BENCH_DIR / 'tests')!r}]
import importlib.util
s = importlib.util.spec_from_file_location("portbench_run", {str(RUN)!r})
run = importlib.util.module_from_spec(s); s.loader.exec_module(run)
run.cache_environment()
import tiny
from yardstick import runner
for kind in ("prefill", "tune", "train"):
    runner.run_cell(tiny.cell(kind), 5, 0.1, False, torch.device("cpu"), 0.0)
print(json.dumps(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_harness_names_no_forbidden_module():
    """No file under portbench/ imports jax, jaxlib, flax or the JAX
    package by its whole top-level name."""
    import re

    pat = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|repro)(?:[.\s]|$)", re.M)
    for path in spec.BENCH_DIR.rglob("*.py"):
        assert not pat.search(path.read_text()), path
