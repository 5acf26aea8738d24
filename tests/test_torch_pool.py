"""The port's worker pool (``measure="pool"``) against the JAX package's,
run on the CPU.

The analytical backend measures bit-equal through either package's pool and
in process (exactly 0.0).  The fault cases are the JAX package's
(``tests/test_measure.py``), on fork pools of ``"tpu"`` and ``"numpy"``
executors registered in this module: fan-out and merge, dedup, a dead worker
respawned, payloads carried verbatim, a poison schedule resolved as a failed
record, a hung worker killed, instances refused.  The card executor's pool
spawns: one spawned ``"torch"`` worker measures a batch on ``device="cpu"``;
a worker whose start-up outlasts ``task_timeout_s`` is not killed, because
the hung clock starts when the worker reports ready; and ``pool_spec`` gives
worker ``wid`` the card ``cuda:{wid % n}`` (a mocked count of 3).
"""
import os
import time
import types

import numpy as np
import pytest
import torch

import repro.core as R
from repro_torch.core import (LoopNest, MeasurementPolicy, PerWorker, WorkerPool,
                              make_backend, matmul_benchmark, register_backend)
from repro_torch.core.actions import apply_action, build_action_space, is_legal
from repro_torch.core.cost_model import TPUAnalyticalBackend
from repro_torch.core.measure import measure_settings
from repro_torch.core.torch_backend import TorchBackend

BENCH = matmul_benchmark(128, 64, 96)
ACTIONS = build_action_space()


def _walk(n_nests, steps=4, seed=0, bench=BENCH):
    """Distinct-structure random schedules of ``bench``."""
    rng = np.random.default_rng(seed)
    out, seen = [], set()
    root = LoopNest(bench)
    while len(out) < n_nests:
        cur = root.clone()
        for _ in range(steps):
            legal = [a for a in ACTIONS if is_legal(cur, a)]
            apply_action(cur, legal[int(rng.integers(len(legal)))])
        if cur.structure_key() not in seen:
            seen.add(cur.structure_key())
            out.append(cur)
    return out


def _reference_nests(nests):
    c = nests[0].contraction
    bench = R.matmul_benchmark(*(c.iter_sizes[i] for i in ("m", "k", "n")))
    return [R.LoopNest.from_structure_key(bench, n.structure_key()) for n in nests]


# ---------------------------------------------------------------------------
# parity: the analytical backend through the pool (exact, 0.0)
# ---------------------------------------------------------------------------


def test_pool_parity_with_inproc_and_with_the_reference_pool():
    nests = _walk(6, seed=1)
    want = make_backend("tpu").evaluate_batch(nests)
    assert len(set(want)) > 1  # the schedules are told apart
    with WorkerPool("tpu", n_workers=2) as pool:
        got = np.array([m.gflops for m in pool.measure_batch(nests)])
    with R.WorkerPool("tpu", n_workers=2) as rpool:
        ref = np.array([m.gflops for m in rpool.measure_batch(_reference_nests(nests))])
    assert np.abs(got - want).max() == 0.0
    assert np.abs(got - ref).max() == 0.0


def test_make_backend_tpu_pool_parity_settings_and_close():
    nests = _walk(5, seed=2)
    be = make_backend("tpu", measure="pool", pool_workers=2)
    try:
        want = make_backend("tpu").evaluate_batch(nests)
        got = be.evaluate_batch(nests)
        assert np.abs(got - want).max() == 0.0
        settings = measure_settings(be)
        assert settings["mode"] == "pool" and settings["workers"] == 2
    finally:
        be.close()
        be.close()  # idempotent


def test_pool_measured_backend_fans_out_and_merges():
    nest = LoopNest(matmul_benchmark(16, 16, 16))
    be = make_backend("numpy", repeats=1, measure="pool", pool_workers=2)
    try:
        m = be.measure(nest)
        # one schedule, two workers: best-of across processes
        assert m.repeats == 2 and m.gflops > 0 and m.worker in (0, 1)
        stats = be.measure_stats()["pool"]
        assert stats["workers"] == 2 and stats["start_method"] == "fork"
    finally:
        be.close()


def test_pool_dedups_duplicate_structures():
    nests = _walk(3, seed=5)
    batch = nests + [nests[0].clone(), nests[1].clone()]
    with WorkerPool("tpu", n_workers=2) as pool:
        ms = pool.measure_batch(batch)
        assert pool.tasks_done == 3  # one task per distinct structure
    assert ms[0].gflops == ms[3].gflops
    assert ms[1].gflops == ms[4].gflops


# ---------------------------------------------------------------------------
# faults (fork pools: the backends registered here are visible in workers)
# ---------------------------------------------------------------------------


def _crashy_factory(token="", policy=None, crash_value=42.0, always=False):
    class Crashy(TPUAnalyticalBackend):
        name = "crashy"

        def evaluate(self, nest):
            if always:
                os._exit(1)  # poison: kills every worker it touches
            if token and os.path.exists(token):
                os.unlink(token)  # crash exactly once across respawns
                os._exit(1)
            return crash_value

        def peak(self):
            return 100.0

    return Crashy()


def _sleepy_factory(token="", policy=None, value=7.0, sleep_s=60.0):
    class Sleepy(TPUAnalyticalBackend):
        name = "sleepy"

        def evaluate(self, nest):
            if token and os.path.exists(token):
                os.unlink(token)  # hang exactly once across respawns
                time.sleep(sleep_s)
            return value

    return Sleepy()


def _slow_start_factory(startup_s=1.5, policy=None):
    time.sleep(startup_s)  # an executor whose start-up outlasts the hung budget
    return TPUAnalyticalBackend()


def _exploding_factory(policy=None):
    class Exploding(TPUAnalyticalBackend):
        name = "exploding"

        def evaluate(self, nest):
            raise ValueError("evaluator bug")

    return Exploding()


def _unbuildable_factory(policy=None):
    raise RuntimeError("no executor here")


register_backend("crashy", _crashy_factory)
register_backend("sleepy", _sleepy_factory)
register_backend("slow_start", _slow_start_factory)
register_backend("exploding", _exploding_factory)
register_backend("unbuildable", _unbuildable_factory)


def test_pool_respawns_dead_worker_and_remeasures(tmp_path):
    token = tmp_path / "crash-once"
    token.write_text("boom")
    nests = _walk(3, seed=6)
    with WorkerPool("crashy", {"token": str(token)}, n_workers=1,
                    start_method="fork") as pool:
        ms = pool.measure_batch(nests)
        stats = pool.stats()
    assert [m.gflops for m in ms] == [42.0] * 3  # all re-measured
    assert stats["respawns"] >= 1
    assert stats["alive"] == 1  # the replacement worker survived
    assert not token.exists()


def test_pool_worker_payloads_flow_through_verbatim():
    # a worker's evaluator output (here a deliberate NaN) reaches the parent
    # unaltered — the pool transports rewards, it never invents them
    nests = _walk(2, seed=7)
    with WorkerPool("crashy", {"token": "", "crash_value": float("nan")},
                    n_workers=1, start_method="fork", max_task_retries=1) as pool:
        ms = pool.measure_batch(nests)
    assert len(ms) == 2 and all(np.isnan(m.gflops) for m in ms)


def test_pool_poison_schedule_resolves_as_failed_not_in_parent():
    nests = _walk(2, seed=9)
    with WorkerPool("crashy", {"always": True}, n_workers=1,
                    start_method="fork", max_task_retries=1) as pool:
        ms = pool.measure_batch(nests)
        stats = pool.stats()
    assert [m.gflops for m in ms] == [0.0, 0.0]
    assert all(m.noisy and m.remeasured for m in ms)  # marked, not retried
    assert stats["failed_tasks"] == 2
    assert stats["respawns"] >= 2


# A worker whose ready message is far larger than a pipe's buffer, so that
# sending it takes a while, and whose first schedule ends its process at
# once.  Through a result queue shared by all workers (written by a feeder
# thread under one lock) the worker died holding that lock mid-message, and
# no later result arrived; each worker's own pipe, written synchronously,
# loses nothing.  Run in a subprocess, so that a pool that wedges fails the
# test at its timeout instead of hanging the suite.
_DIES_AFTER_READY = r"""
import os
import time
from repro_torch.core import LoopNest, WorkerPool, matmul_benchmark, register_backend
from repro_torch.core.actions import apply_action, build_action_space, is_legal
from repro_torch.core.cpu_backend import CPUMeasuredBackend


def factory(poison="", policy=None):
    class BigReady(CPUMeasuredBackend):
        def worker_ready(self):
            return dict(super().worker_ready(), blob="x" * (16 << 20))

        def measure(self, nest, worker=-1):
            if repr(nest.structure_key()) == poison:
                os._exit(3)
            return super().measure(nest, worker=worker)

    return BigReady(policy=policy)


register_backend("big_ready", factory)
nests = [LoopNest(matmul_benchmark(32, 32, 32)) for _ in range(2)]
for a in build_action_space():  # a second schedule: one structure-changing action
    if is_legal(nests[1], a):
        apply_action(nests[1], a)
        if nests[1].structure_key() != nests[0].structure_key():
            break
with WorkerPool("big_ready", {"poison": repr(nests[0].structure_key())}, n_workers=1,
                start_method="fork", max_task_retries=1, task_timeout_s=30.0) as pool:
    time.sleep(1.0)  # the worker is ready, its message waiting on a full pipe
    ms = pool.measure_batch(nests)
    stats = pool.stats()
print(ms[0].gflops, ms[1].gflops > 0, stats["failed_tasks"], stats["hung_killed"])
"""


def test_worker_dying_right_after_a_long_ready_message_wedges_nothing():
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.path.abspath(
        os.path.join(os.path.dirname(__file__), os.pardir, "src")))
    out = subprocess.run([sys.executable, "-c", _DIES_AFTER_READY], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert out.split() == ["0.0", "True", "1", "0"]


def test_pool_kills_hung_worker_and_recovers(tmp_path):
    token = tmp_path / "hang-once"
    token.write_text("zzz")
    nests = _walk(2, seed=8)
    with WorkerPool("sleepy", {"token": str(token)}, n_workers=1,
                    start_method="fork", task_timeout_s=1.5) as pool:
        ms = pool.measure_batch(nests)
        stats = pool.stats()
    assert [m.gflops for m in ms] == [7.0] * 2
    assert stats["hung_killed"] >= 1
    assert stats["respawns"] >= 1
    assert stats["alive"] == 1


def test_worker_start_up_slower_than_the_hung_budget_is_not_killed():
    # the executor takes 3 s to build, three times task_timeout_s: the hung
    # clock starts at "ready", so the worker measures instead of being
    # killed and respawned forever
    nests = _walk(3, seed=10)
    want = make_backend("tpu").evaluate_batch(nests)
    with WorkerPool("slow_start", {"startup_s": 3.0}, n_workers=1,
                    start_method="fork", task_timeout_s=1.0) as pool:
        got = np.array([m.gflops for m in pool.measure_batch(nests)])
        stats = pool.stats()
    assert np.abs(got - want).max() == 0.0
    assert stats["hung_killed"] == 0 and stats["respawns"] == 0
    assert stats["worker_info"][0]["startup_s"] >= 3.0


def test_start_up_that_never_ends_is_bounded_and_raises():
    # a worker stuck in start-up past startup_timeout_s is killed; after the
    # retry budget of such deaths the parent raises (the executor cannot
    # start, which no schedule caused) instead of respawning forever
    with WorkerPool("slow_start", {"startup_s": 60.0}, n_workers=1,
                    start_method="fork", startup_timeout_s=0.5,
                    max_task_retries=1) as pool:
        with pytest.raises(RuntimeError, match="during start-up 2 times"):
            pool.measure_batch(_walk(1, seed=11))
        assert pool.stats()["startup_killed"] == 2


def _dies_at_start_factory(policy=None):
    os._exit(7)


register_backend("dies_at_start", _dies_at_start_factory)


def test_workers_that_die_at_start_up_raise_in_the_parent():
    with WorkerPool("dies_at_start", n_workers=2, start_method="fork",
                    max_task_retries=2) as pool:
        with pytest.raises(RuntimeError, match="exit code 7"):
            pool.measure_batch(_walk(2, seed=14))


@pytest.mark.parametrize("spec", ["exploding", "unbuildable"])
def test_worker_exceptions_reraise_in_the_parent(spec):
    with WorkerPool(spec, n_workers=1, start_method="fork") as pool:
        with pytest.raises(RuntimeError, match="measurement worker 0 failed"):
            pool.measure_batch(_walk(1, seed=12))


def test_pool_rejects_backend_instances():
    with pytest.raises(TypeError):
        WorkerPool(TPUAnalyticalBackend())


# ---------------------------------------------------------------------------
# the card executor's pool: spawned, one worker a card
# ---------------------------------------------------------------------------


def test_spawned_torch_pool_measures_a_batch_on_the_cpu():
    nests = _walk(3, seed=13, bench=matmul_benchmark(32, 32, 32))
    be = make_backend("torch", device="cpu", measure="pool",
                      policy=MeasurementPolicy(repeats=1, max_repeats=1))
    try:
        ms = be.measure_batch(nests)
        stats = be.measure_stats()["pool"]
        assert all(m.gflops > 0 and m.worker == 0 and m.repeats == 1 for m in ms)
        assert stats["start_method"] == "spawn" and stats["workers"] == 1
        assert stats["worker_info"][0]["device"] == "cpu"
        assert stats["tasks_done"] == 3 and stats["hung_killed"] == 0
        # the parent recorded what the worker measured
        assert be.measurement_for(nests[1]) is ms[1]
    finally:
        be.close()


def test_pool_spec_gives_each_worker_its_own_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    be = TorchBackend(device="cuda", measure="pool")
    spec, kwargs, method = be.pool_spec()
    assert (spec, method) == ("torch", "spawn")
    assert isinstance(kwargs["device"], PerWorker)
    assert kwargs["device"].values == ("cuda:0", "cuda:1", "cuda:2")
    assert be.default_pool_workers() == 3  # one a card, not one a core
    host = types.SimpleNamespace(kwargs=dict(kwargs, measure="pool"),
                                 policy=MeasurementPolicy())
    devices = [WorkerPool._worker_kwargs(host, wid)["device"] for wid in range(7)]
    assert devices == [f"cuda:{wid % 3}" for wid in range(7)]
    assert "measure" not in WorkerPool._worker_kwargs(host, 0)
    assert TorchBackend(device="cpu").default_pool_workers() == 1
