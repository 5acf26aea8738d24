"""The port's measurement farm against the JAX package's, run on the CPU on
the analytical backend (``"tpu"``), where measurements are exact.

Frames and wire dicts are byte-equal between the packages, so a farm of
either package serves a client of the other with measurements equal to
local ones (exactly).  Then the port's own cases: tickets against blocking
parity and the in-flight window; a resubmitted ticket deduplicated; an
unreachable farm warning once, degrading to the explicit fallback and
re-promoting when the farm comes back; the searches' measure-ahead with
equal results; ``tune_records_fleet`` with two clients, its records
stamped with the farm's backend; the drain with tickets outstanding, in
process and as a SIGTERM to a farm subprocess; the ``launch/tune`` CLI with
``--farm``/``--fleet``/``--kernel-cache``; and the fault proxy's truncated
reply, reset mid-handshake and silent drop (``tests/fault_proxy.py``).
Every socket has a timeout and the farm subprocess is killed in a
``finally``.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
from fault_proxy import FaultProxy

import repro.core as R
from repro.core import measure_service as RMS
from repro_torch.core import (LoopNest, LoopTuneEnv, LoopTuner, MeasureServer,
                              ScheduleRegistry, make_backend, matmul_benchmark)
from repro_torch.core import measure_service as TMS
from repro_torch.core.actions import apply_action, build_action_space, is_legal
from repro_torch.core.cost_model import TPUAnalyticalBackend
from repro_torch.core.search import beam_search, greedy_search
from repro_torch.launch import tune as TTUNE

REPO_ROOT = Path(__file__).resolve().parents[1]
DIMS = (128, 64, 96)
BENCH = matmul_benchmark(*DIMS)
SOCKET_TIMEOUT_S = 10.0


def _schedules(n=4, seed=0, steps=4):
    actions = build_action_space()
    rng = np.random.default_rng(seed)
    out, seen = [], set()
    root = LoopNest(BENCH)
    while len(out) < n:
        cur = root.clone()
        for _ in range(steps):
            legal = [a for a in actions if is_legal(cur, a)]
            apply_action(cur, legal[int(rng.integers(len(legal)))])
        if cur.structure_key() not in seen:
            seen.add(cur.structure_key())
            out.append(cur)
    return out


def _reference(nests):
    bench = R.matmul_benchmark(*DIMS)
    return [R.LoopNest.from_structure_key(bench, n.structure_key()) for n in nests]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _PacedBackend(TPUAnalyticalBackend):
    """The analytical model with a fixed service time per schedule."""

    def __init__(self, sleep_s: float):
        super().__init__()
        self.sleep_s = sleep_s

    def evaluate(self, nest):
        time.sleep(self.sleep_s)
        return super().evaluate(nest)


# ---------------------------------------------------------------------------
# the wire: byte-equal between the packages
# ---------------------------------------------------------------------------


class _Sink:
    """A socket stand-in that keeps what ``send_frame`` sends."""

    def __init__(self):
        self.data = b""

    def sendall(self, b: bytes) -> None:
        self.data += b


def test_frames_and_wire_dicts_are_byte_equal_between_the_packages():
    nests = _schedules(4, seed=1)
    for tn, rn in zip(nests, _reference(nests)):
        tw, rw = TMS.nest_to_wire(tn), RMS.nest_to_wire(rn)
        assert json.dumps(tw) == json.dumps(rw)
        frames = []
        for ms in (TMS, RMS):
            sink = _Sink()
            ms.send_frame(sink, {"op": "measure", "id": 1, "nests": [tw]})
            frames.append(sink.data)
        assert frames[0] == frames[1]
        # each package decodes the other's frame to the same schedule
        a, b = socket.socketpair()
        try:
            b.settimeout(SOCKET_TIMEOUT_S)
            a.sendall(frames[1] + frames[0])
            from_jax, from_port = TMS.recv_frame(b), RMS.recv_frame(b)
        finally:
            a.close()
            b.close()
        assert TMS.nest_from_wire(from_jax["nests"][0]).structure_key() == tn.structure_key()
        assert RMS.nest_from_wire(from_port["nests"][0]).structure_key() == rn.structure_key()
    assert TMS.PROTO_VERSION == RMS.PROTO_VERSION
    assert TMS.MAX_FRAME_BYTES == RMS.MAX_FRAME_BYTES == 64 << 20


def test_a_bfloat16_contraction_carries_its_type_on_the_wire():
    import dataclasses

    nest = _schedules(1, seed=2)[0]
    bf16 = LoopNest.from_structure_key(
        dataclasses.replace(nest.contraction, dtype="bfloat16"),
        (f"{nest.contraction.name}:bfloat16", *nest.structure_key()[1:]))
    w = json.loads(json.dumps(TMS.nest_to_wire(bf16)))
    assert w[0]["dtype"] == "bfloat16" and "dtype" not in TMS.nest_to_wire(nest)[0]
    back = TMS.nest_from_wire(w)
    assert back.contraction.dtype == "bfloat16"
    assert back.structure_key() == bf16.structure_key()


@pytest.mark.parametrize("farm_pkg", ["jax", "port"])
def test_a_farm_of_either_package_serves_the_other_s_client(farm_pkg):
    nests = _schedules(5, seed=3)
    rnests = _reference(nests)
    want = make_backend("tpu").evaluate_batch(nests)
    assert len(set(want)) > 1
    server = (R.MeasureServer if farm_pkg == "jax" else MeasureServer)(backend="tpu")
    with server.start() as srv:
        if farm_pkg == "jax":
            client, batch = make_backend("remote", addr=srv.addr, fallback="tpu"), nests
        else:
            client, batch = R.make_backend("remote", addr=srv.addr, fallback="tpu"), rnests
        try:
            got = client.evaluate_batch(batch)
            ticketed = client.collect_batch(client.submit_batch(batch))
            assert client.farm_stats()["remote_backend"] == "tpu"
            assert not client.degraded
        finally:
            client.close()
    assert np.array_equal(got, want) and np.array_equal(ticketed, want)
    assert srv.stats()["requests"] >= 2


# ---------------------------------------------------------------------------
# the port's farm and client
# ---------------------------------------------------------------------------


def test_tickets_match_blocking_and_the_window_bounds_in_flight():
    nests = _schedules(6, seed=4)
    want = make_backend("tpu").evaluate_batch(nests)
    with MeasureServer(backend=_PacedBackend(0.02)).start() as srv:
        rb = make_backend("remote", addr=srv.addr, fallback="tpu",
                          inflight_window=2, max_nests_per_request=1)
        try:
            blocking = rb.evaluate_batch(nests[:1])
            handle = rb.submit_batch(nests)
            ms = rb.wait(handle)
            stats = rb.farm_stats()
        finally:
            rb.close()
    assert blocking[0] == want[0]
    assert [m.gflops for m in ms] == list(want)
    assert stats["tickets_submitted"] == stats["tickets_collected"] == 6
    assert stats["inflight_tickets_peak"] <= 2


def test_a_resubmitted_ticket_is_measured_once():
    nests = _schedules(2, seed=5)
    wire = [TMS.nest_to_wire(n) for n in nests]
    with MeasureServer(backend="tpu").start() as srv:
        host, port = TMS.parse_addr(srv.addr)
        with socket.create_connection((host, port), timeout=SOCKET_TIMEOUT_S) as sock:
            for i in (1, 2):
                TMS.send_frame(sock, {"op": "submit", "id": i, "client": "c",
                                      "ticket": "t1", "nests": wire})
                ack = TMS.recv_frame(sock)
                assert ack["ok"] and ack["ticket"] == "t1"
            assert ack.get("duplicate") is True
            TMS.send_frame(sock, {"op": "collect", "id": 3, "client": "c",
                                  "tickets": ["t1"], "timeout_s": 5.0})
            done = TMS.recv_frame(sock)["done"]["t1"]
        stats = srv.stats()
    assert stats["tickets_submitted"] == 1 and stats["tickets_deduped"] == 1
    assert stats["served_nests"] == 2
    want = make_backend("tpu").evaluate_batch(nests)
    assert [m[0] for m in done["measurements"]] == list(want)


def test_unreachable_farm_warns_once_degrades_then_repromotes():
    nests = _schedules(3, seed=6)
    want = make_backend("tpu").evaluate_batch(nests)
    port = _free_port()
    rb = make_backend("remote", addr=f"127.0.0.1:{port}", fallback="tpu",
                      max_retries=1, backoff_base_s=0.01, connect_timeout_s=1.0,
                      reprobe_every_batches=1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            first = rb.evaluate_batch(nests)
            second = rb.evaluate_batch(nests)  # re-probe fails: still local
        assert [str(w.message).count("unavailable") > 0 for w in caught] == [True]
        assert rb.degraded and rb.measured_backend_name() == "tpu"
        assert rb.measured_hardware() is None  # local host stamps the record
        with MeasureServer(port=port, backend="tpu").start():
            third = rb.evaluate_batch(nests)
            assert not rb.degraded
            stats = rb.farm_stats()
        assert stats["repromotions"] == 1 and stats["degradations"] == 1
        assert rb.measured_backend_name() == "tpu"
    finally:
        rb.close()
    assert np.array_equal(first, want) and np.array_equal(second, want)
    assert np.array_equal(third, want)


@pytest.mark.parametrize("search", ["greedy", "beam"])
def test_search_measure_ahead_matches_local_search(search):
    with MeasureServer(backend="tpu").start() as srv:
        rb = make_backend("remote", addr=srv.addr, fallback="tpu")
        try:
            envs = [LoopTuneEnv([BENCH], backend, seed=0)
                    for backend in (rb, make_backend("tpu"))]
            if search == "greedy":
                res = [greedy_search(env, 0, lookahead=1, max_evals=40) for env in envs]
                # the frontier went in flight before it was ranked
                assert envs[0].cache.stats()["submitted_ahead"] > 0
                assert rb.farm_stats()["tickets_submitted"] > 0
            else:
                res = [beam_search(env, 0, width=4, order="dfs", budget_s=60.0,
                                   max_evals=40) for env in envs]
            assert rb.farm_stats()["requests"] > 0 and not rb.degraded
        finally:
            rb.close()
    assert res[0].best_gflops == res[1].best_gflops
    assert list(res[0].actions) == list(res[1].actions)


def _records():
    return [{"m": 64, "k": 64, "n": 64, "dtype": "float32", "flop_share": 0.5},
            {"m": 48, "k": 48, "n": 48, "dtype": "float32", "flop_share": 0.3},
            {"m": 32, "k": 32, "n": 32, "dtype": "float32", "flop_share": 0.2}]


def test_tune_records_fleet_with_two_clients(tmp_path):
    reg_path = str(tmp_path / "reg.json")
    journal = TTUNE.TuneJournal(reg_path + ".journal.jsonl")
    with MeasureServer(backend="tpu").start() as srv:
        entries, n_skipped, clients = TTUNE.tune_records_fleet(
            _records(), n_clients=2, farm=srv.addr, backend="tpu",
            registry_path=reg_path, budget_s=2.0, eval_budget=60,
            journal=journal, device="cpu")
        served = srv.stats()["clients"]
    assert n_skipped == 0 and len(entries) == 3 and len(clients) == 2
    assert set(served) == {"tune-0", "tune-1"}
    for c in clients:
        assert c["farm"]["requests"] > 0 and c["farm"]["degradations"] == 0
    reg = ScheduleRegistry(reg_path)
    for r in _records():
        entry = reg.get("mm", (r["m"], r["k"], r["n"]), "float32")
        # stamped with the farm's executor and host, never "remote"
        assert entry["backend"] == "tpu" and entry["hardware"] == srv.hardware
    assert len(journal.load()) == 3


def test_drain_with_outstanding_tickets_completes_them():
    nests = _schedules(3, seed=9)
    want = make_backend("tpu").evaluate_batch(nests)
    srv = MeasureServer(backend=_PacedBackend(0.1)).start()
    rb = make_backend("remote", addr=srv.addr, fallback="tpu")
    try:
        handle = rb.submit_batch(nests)
        srv.drain()
        assert not srv.drain(wait=True, timeout=0.05)  # parked, unacked: held
        ms = rb.wait(handle)
        assert [m.gflops for m in ms] == list(want)
        rb.flush_acks()  # releases the parked results
        assert srv.drain(wait=True, timeout=10.0)
    finally:
        rb.close()
        srv.close()


def test_farm_subprocess_sigterm_with_tickets_outstanding_exits_zero():
    nests = _schedules(3, seed=11)
    want = make_backend("tpu").evaluate_batch(nests)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.measure_farm", "--addr",
         "127.0.0.1:0", "--backend", "tpu", "--measure", "inproc",
         "--max-requests", "50"],
        cwd=str(REPO_ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "PYTHONPATH": str(REPO_ROOT / "src")})
    try:
        first = proc.stdout.readline()
        assert first.startswith("[farm] listening on"), first
        addr = first.split()[3]
        rb = make_backend("remote", addr=addr, fallback="tpu")
        handle = rb.submit_batch(nests)
        proc.send_signal(signal.SIGTERM)
        ms = rb.wait(handle)
        assert [m.gflops for m in ms] == list(want) and not rb.degraded
        rb.close()  # its acks release the drain linger
        assert proc.wait(timeout=30) == 0
        out = proc.stdout.read()
        assert "SIGTERM: draining" in out and "[farm] stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()


def test_tune_cli_with_farm_fleet_and_kernel_cache(tmp_path, capsys):
    reg = str(tmp_path / "r.json")
    with MeasureServer(backend="tpu").start() as srv:
        assert TTUNE.main(["--arch", "musicgen-large", "--registry", reg,
                           "--backend", "tpu", "--device", "cpu", "--farm", srv.addr,
                           "--fleet", "2", "--kernel-cache", str(tmp_path / "kc"),
                           "--budget-s", "1", "--batch", "2", "--prompt-len", "8",
                           "--max-len", "16"]) == 0
        requests = srv.stats()["requests"]
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["n_tuned"] == 8 and report["fleet"]["n_clients"] == 2
    assert report["fleet"]["tickets_submitted"] == report["fleet"]["tickets_collected"]
    assert report["kernel_cache"] == str(tmp_path / "kc") and requests > 0
    assert len(ScheduleRegistry(reg)) == 8
    assert not (tmp_path / "kc").exists()  # only the card executor opens a store


@pytest.mark.parametrize("fault", [
    {"kind": "truncate", "after_bytes": 20},  # a reply cut mid-frame
    {"kind": "reset", "after_bytes": 0},      # an RST mid-handshake
    {"kind": "drop", "after_bytes": 0},       # a silent close
], ids=["truncated_reply", "reset_mid_handshake", "silent_drop"])
def test_transport_faults_retry_clean(fault):
    nests = _schedules(3, seed=12)
    want = make_backend("tpu").evaluate_batch(nests)
    with MeasureServer(backend="tpu").start() as srv, \
            FaultProxy(srv.addr, plan=[fault]) as proxy:
        rb = make_backend("remote", addr=proxy.addr, fallback="tpu",
                          max_retries=3, backoff_base_s=0.01,
                          deadline_s=SOCKET_TIMEOUT_S)
        try:
            got = rb.evaluate_batch(nests)
            stats = rb.farm_stats()
        finally:
            rb.close()
        assert proxy.n_faults == 1
    assert np.array_equal(got, want)
    assert not rb.degraded and stats["retries"] >= 1
    assert stats["degraded_batches"] == 0


def test_the_port_s_farm_backend_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        MeasureServer(backend="auto")
    rb = make_backend("remote:127.0.0.1:1", max_retries=0, connect_timeout_s=0.5)
    try:
        assert rb.fallback_spec == "auto"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(RuntimeError, match="CUDA"):
                rb.evaluate_batch(_schedules(1, seed=13))  # no silent CPU
    finally:
        rb.close()
