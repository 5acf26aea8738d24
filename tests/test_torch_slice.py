"""The first slice as a whole: tune -> registry -> tuned matmul, in both
packages on the same inputs, plus the port's import isolation.

Both tuners search on the analytical ``"tpu"`` backend (deterministic, so
the two searches must agree step for step) under the same ``max_evals`` and
a budget in seconds far above what they need, so both stop on the eval cap.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import LoopTuner as RTuner
from repro.core import ScheduleRegistry as RRegistry
from repro.core import matmul_benchmark as r_mm
from repro.kernels import ops as rops
from repro_torch.core import LoopTuner as TTuner
from repro_torch.core import ScheduleRegistry as TRegistry
from repro_torch.core import matmul_benchmark as t_mm
from repro_torch.kernels import ops as tops

SLICE = [(96, 64, 128), (64, 128, 80)]
MAX_EVALS = 24


@pytest.fixture(scope="module")
def tuned():
    kw = dict(policy="search", backend="tpu", surrogate="off")
    t, r = TTuner(**kw), RTuner(**kw)
    t_entries = [t.tune(t_mm(*s), max_evals=MAX_EVALS, budget_s=600.0) for s in SLICE]
    r_entries = [r.tune(r_mm(*s), max_evals=MAX_EVALS, budget_s=600.0) for s in SLICE]
    return t, r, t_entries, r_entries


@pytest.mark.parametrize("i", range(len(SLICE)))
def test_tuners_agree(tuned, i):
    _, _, t_entries, r_entries = tuned
    te, re = t_entries[i], r_entries[i]
    assert te["actions"] == re["actions"]
    assert te["gflops"] == re["gflops"]
    assert te["base_gflops"] == re["base_gflops"]
    assert te["block"] == re["block"]
    assert te["grid_order"] == re["grid_order"]
    assert te["structure_key"] == re["structure_key"]


def _operands(m, k, n):
    rng = np.random.default_rng(m + k + n)
    return (rng.standard_normal((m, k), dtype=np.float32),
            rng.standard_normal((k, n), dtype=np.float32))


@pytest.mark.parametrize("i", range(len(SLICE)))
def test_tuned_matmul_outputs_agree(tuned, i):
    t, r, _, _ = tuned
    a, b = _operands(*SLICE[i])
    tops.set_registry(t.registry)
    rops.set_registry(r.registry)
    try:
        out = tops.tuned_matmul(torch.from_numpy(a), torch.from_numpy(b))
        ref = rops.tuned_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    finally:
        tops.set_registry(None)
        rops.set_registry(None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


CARD_SHAPE = (256, 192, 160)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_registry_file_drives_the_other_package(tuned, tmp_path, writer):
    """A record measured on the card (block from the shared-memory
    boundary, here (32, 192, 160)) travels through a registry file and
    drives both packages' tuned matmul at that block."""
    from repro_torch.core import LoopNest

    t, r, _, _ = tuned
    nest = LoopNest(t_mm(*CARD_SHAPE))
    nest.split(0, 32)
    card = TRegistry()
    card.put("mm", CARD_SHAPE, 1.0, ["split_32"], nest, backend="torch")
    assert card.get("mm", CARD_SHAPE)["block"] == {"m": 32, "k": 192, "n": 160}
    path = str(tmp_path / "reg.json")
    if writer == "port":
        card.merge(t.registry)
        card.save(path)
        port_reg, jax_reg = card, RRegistry(path)
    else:
        jax_reg = RRegistry()
        jax_reg.merge(r.registry)
        jax_reg._table.update(card._table)  # as a JAX-side fleet shard holds it
        jax_reg.save(path)
        port_reg = TRegistry(path)
    for shape in (SLICE[0], CARD_SHAPE):
        a, b = _operands(*shape)
        tops.set_registry(port_reg)
        rops.set_registry(jax_reg)
        try:
            out = tops.tuned_matmul(torch.from_numpy(a), torch.from_numpy(b))
            ref = rops.tuned_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
        finally:
            tops.set_registry(None)
            rops.set_registry(None)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
            "import repro_torch.runtime.sharding, repro_torch.runtime.elastic\n"
            "import repro_torch.launch.mesh, repro_torch.analysis.roofline\n"
            "import repro_torch.analysis, repro_torch.launch.train\n"
            "import repro_torch.configs, repro_torch.launch.dryrun\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert out.strip() == "[]"
