"""Parity of the port's analytical cost model and schedule registry with the
JAX package's, the card's residency boundary, and registry files crossing
between the two packages in both directions."""
import json

import numpy as np
import pytest

from repro.core import actions as RA
from repro.core import cost_model as RC
from repro.core import loop_ir as RL
from repro.core import registry as RR
from repro_torch.core import actions as TA
from repro_torch.core import cost_model as TC
from repro_torch.core import loop_ir as TL
from repro_torch.core import registry as TR

SHAPES = [(64, 64, 64), (96, 128, 80), (256, 128, 192), (1024, 2048, 2048),
          (4, 8192, 2048)]


def _nest_pairs(m, k, n, seed, steps=10):
    rn = RL.LoopNest(RL.matmul_benchmark(m, k, n))
    tn = TL.LoopNest(TL.matmul_benchmark(m, k, n))
    r_acts, t_acts = RA.build_action_space(), TA.build_action_space()
    rng = np.random.default_rng(seed)
    out = [(rn.clone(), tn.clone())]
    for _ in range(steps):
        ai = int(rng.integers(len(r_acts)))
        RA.apply_action(rn, r_acts[ai])
        TA.apply_action(tn, t_acts[ai])
        out.append((rn.clone(), tn.clone()))
    return out


@pytest.mark.parametrize("mkn", SHAPES)
def test_analyze_and_blockspec_equal(mkn):
    r_be, t_be = RC.TPUAnalyticalBackend(), TC.TPUAnalyticalBackend()
    assert t_be.peak() == r_be.peak()
    for seed in range(3):
        for rn, tn in _nest_pairs(*mkn, seed):
            assert t_be.analyze(tn) == r_be.analyze(rn)
            assert TR.schedule_to_blockspec(tn) == RR.schedule_to_blockspec(rn)
            for b in range(tn.n_compute + 1):
                assert (TR.schedule_to_blockspec(tn, b)
                        == RR.schedule_to_blockspec(rn, b))


@pytest.mark.parametrize("mkn", SHAPES)
def test_card_boundary_is_the_reference_rule_at_smem_size(mkn):
    ref = RC.TPUAnalyticalBackend(dtype_bytes=4)
    for seed in range(3):
        for rn, tn in _nest_pairs(*mkn, seed):
            b = TR.card_boundary(tn)
            assert b == ref._boundary(rn, 232_448)
            block, _ = TR.schedule_to_blockspec(tn, b)
            # f32 operand slabs + f32 accumulator fit one block's shared memory
            m, k, n = block["m"], block["k"], block["n"]
            assert (m * k + k * n + m * n) * 4 <= TR.SMEM_PER_BLOCK


def test_untuned_prefill_block_is_one_sm_on_the_tpu_rule_only():
    tn = TL.LoopNest(TL.matmul_benchmark(1024, 2048, 2048))
    tpu_block, _ = TR.schedule_to_blockspec(tn)
    card_block, _ = TR.schedule_to_blockspec(tn, TR.card_boundary(tn))
    assert tpu_block == {"m": 1024, "k": 2048, "n": 2048}
    assert card_block == {"m": 1, "k": 1, "n": 2048}


def _filled(pkg_registry, pkg_loop_ir):
    reg = pkg_registry.ScheduleRegistry()
    nest = pkg_loop_ir.LoopNest(pkg_loop_ir.matmul_benchmark(128, 64, 256))
    nest.split(0, 32)
    reg.put("mm", (128, 64, 256), 100.0, ["split_32"], nest, backend="tpu",
            hardware="cpu-x86_64", measurement={"gflops": 100.0, "spread": 0.0})
    reg.put("mm", (4, 8192, 2048), 50.0, [], backend="torch",
            hardware="NVIDIA H100 80GB HBM3|x")
    return reg


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_registry_files_cross_packages(tmp_path, direction):
    src_reg, src_ir, dst_reg, dst_ir = (
        (TR, TL, RR, RL) if direction == "port_to_jax" else (RR, RL, TR, TL))
    path = str(tmp_path / "reg.json")
    _filled(src_reg, src_ir).save(path)
    loaded = dst_reg.ScheduleRegistry(path)
    # equal to the writer's table as JSON holds it (tuples become lists)
    assert dict(loaded.entries()) == json.loads(
        json.dumps(dict(_filled(src_reg, src_ir).entries())))
    e = loaded.get("mm", (128, 64, 256), backend="tpu")
    assert e["block"] == {"m": 128, "k": 64, "n": 256}
    # merge into a table of the other package: a better record wins
    other = _filled(dst_reg, dst_ir)
    better = dst_reg.ScheduleRegistry()
    better.put("mm", (128, 64, 256), 200.0, ["swap_down"], backend="tpu",
               hardware="cpu-x86_64")
    assert other.merge(loaded) == 0
    assert loaded.merge(better) == 1
    assert loaded.get("mm", (128, 64, 256))["gflops"] == 200.0
    out = str(tmp_path / "back.json")
    loaded.save(out)
    with open(out) as f:
        doc = json.load(f)
    assert doc["version"] == 2 and len(doc["entries"]) == 2
    assert len(src_reg.ScheduleRegistry(out)) == 2


def test_records_measured_on_the_card_use_the_card_boundary():
    nest = TL.LoopNest(TL.matmul_benchmark(1024, 2048, 2048))
    reg = TR.ScheduleRegistry()
    reg.put("mm", (1024, 2048, 2048), 1.0, [], nest, backend="torch", hardware="h")
    reg.put("mm", (1024, 2048, 2048), 1.0, [], nest, backend="tpu", hardware="h")
    assert reg.get("mm", (1024, 2048, 2048), backend="torch")["block"] == \
        {"m": 1, "k": 1, "n": 2048}
    rreg = RR.ScheduleRegistry()
    rreg.put("mm", (1024, 2048, 2048), 1.0, [],
             RL.LoopNest(RL.matmul_benchmark(1024, 2048, 2048)),
             backend="tpu", hardware="h")
    assert reg.get("mm", (1024, 2048, 2048), backend="tpu")["block"] == \
        rreg.get("mm", (1024, 2048, 2048))["block"]


def test_cpu_hardware_key_matches():
    assert TR.current_hardware() == RR.current_hardware()
