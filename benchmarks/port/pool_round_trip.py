"""The worker pool's round trip on this host: transport, pinning, waiting, depth.

    python3 benchmarks/port/pool_round_trip.py [--n 2000]

``WorkerPool`` sends each task to a worker and waits for its result, so a
pooled reward costs one round trip on top of the measurement.  This script
times round trips between a parent and one spawned child, median and mean
over ``--n`` small messages:

* ``queue``: ``multiprocessing.Queue`` each way (a feeder thread on each
  side writes the pipe), as the pool sends tasks and results;
* ``pipe``: one duplex ``multiprocessing.Pipe``, written by the calling
  thread;

each with the child pinned to one core (as pool workers pin themselves)
and not; each with both sides blocking in the read, and with both polling
the read without blocking until the message is there (``spin``: a process
that never sleeps is never woken); and the queues with one message in
flight, and with two (``depth2``: the child finds the next message waiting,
as a worker would with two tasks queued).  Then the pool itself: ``--n``
tasks of the analytical backend (no clock, no card) through a spawned
one-worker ``WorkerPool`` in batches of 10, per task, beside the same tasks
in process.  With ``--card``, the card executor too: ``--n`` schedules of
musicgen-large's 4 × 2048 × 2048 contraction measured one a batch (as the
tuner's env asks), in process and through a spawned one-worker pool whose
worker is pinned to one core (as the pool pins) and whose worker is not,
with the seconds the worker spent inside ``measure``.  The first line is
the card's name and power limit ("no card" elsewhere).  One JSON line a
row.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.backend import register_backend  # noqa: E402


def _pin(pin: bool) -> None:
    if pin:
        os.sched_setaffinity(0, {0})


def _spin_get(q):
    while q.empty():
        pass
    return q.get()


def _spin_recv(conn):
    while not conn.poll(0):
        pass
    return conn.recv()


def _echo_queue(task_q, result_q, pin: bool, spin: bool) -> None:
    _pin(pin)
    get = (lambda: _spin_get(task_q)) if spin else task_q.get
    while (msg := get()) is not None:
        result_q.put(msg)


def _echo_pipe(conn, pin: bool, spin: bool) -> None:
    _pin(pin)
    recv = (lambda: _spin_recv(conn)) if spin else conn.recv
    while (msg := recv()) is not None:
        conn.send(msg)


def _round_trips(kind: str, pin: bool, n: int, spin: bool, depth: int = 1) -> list:
    ctx = mp.get_context("spawn")
    msg = ((1, 2, 0), {"name": "mm_4_2048_2048", "dims": [4, 2048, 2048]},
           ("mm_4_2048_2048", (("m", 4, 1), ("k", 2048, 16)), 2, 0))
    times = []
    if kind == "queue":
        task_q, result_q = ctx.Queue(), ctx.Queue()
        p = ctx.Process(target=_echo_queue, args=(task_q, result_q, pin, spin),
                        daemon=True)
        p.start()
        send = task_q.put
        recv = (lambda: _spin_get(result_q)) if spin else result_q.get
    else:
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_echo_pipe, args=(child, pin, spin), daemon=True)
        p.start()
        send = parent.send
        recv = (lambda: _spin_recv(parent)) if spin else parent.recv
    send(msg)
    recv()  # the child has started
    for _ in range(depth):
        send(msg)
    for _ in range(n):  # steady state: one message back, one more out
        t0 = time.perf_counter()
        recv()
        send(msg)
        times.append(time.perf_counter() - t0)
    for _ in range(depth):
        recv()
    send(None)
    p.join(timeout=10)
    return times


def _row(name: str, times: list, **kw) -> None:
    print(json.dumps({"row": name, "n": len(times),
                      "median_us": statistics.median(times) * 1e6,
                      "mean_us": statistics.fmean(times) * 1e6, **kw}), flush=True)


def _pool_rows(n: int) -> None:
    import numpy as np

    from repro_torch.core import LoopNest, WorkerPool, make_backend, matmul_benchmark
    from repro_torch.core.actions import apply_action, build_action_space, is_legal

    actions = build_action_space()
    rng = np.random.default_rng(0)
    nests, seen = [], set()
    bench = matmul_benchmark(1024, 2048, 8192)
    while len(nests) < n:
        nest = LoopNest(bench)
        for _ in range(6):
            legal = [a for a in actions if is_legal(nest, a)]
            apply_action(nest, legal[int(rng.integers(len(legal)))])
        if nest.structure_key() not in seen:
            seen.add(nest.structure_key())
            nests.append(nest)
    local = make_backend("tpu")
    t0 = time.perf_counter()
    for i in range(0, n, 10):
        local.evaluate_batch(nests[i:i + 10])
    inproc = (time.perf_counter() - t0) / n
    with WorkerPool("tpu", n_workers=1, start_method="spawn") as pool:
        pool.wait_ready(timeout_s=120)
        t0 = time.perf_counter()
        for i in range(0, n, 10):
            pool.measure_batch(nests[i:i + 10])
        pooled = (time.perf_counter() - t0) / n
    print(json.dumps({"row": "worker_pool_tpu_spawn", "n": n, "per_task_us": pooled * 1e6,
                      "inproc_per_task_us": inproc * 1e6,
                      "overhead_us": (pooled - inproc) * 1e6}), flush=True)


def _timed_torch_backend(spy_dir: str, unpin: bool = False, **kw):
    """The card executor, adding the seconds spent in ``measure`` to
    ``spy_dir/measure_s-<pid>`` at exit; ``unpin`` undoes the pool's
    pinning before the executor (and the CUDA driver's threads) start."""
    from multiprocessing import util

    from repro_torch.core.torch_backend import TorchBackend

    if unpin:
        os.sched_setaffinity(0, range(os.cpu_count() or 1))
    backend = TorchBackend(**kw)
    spent = [0.0]
    measure = backend.measure

    def timed(nest, worker=-1):
        t0 = time.perf_counter()
        m = measure(nest, worker)
        spent[0] += time.perf_counter() - t0
        return m

    backend.measure = timed
    out = Path(spy_dir) / f"measure_s-{os.getpid()}"
    util.Finalize(backend, lambda: out.write_text(str(spent[0])), exitpriority=10)
    return backend


def _card_rows(n: int, device: str = "cuda") -> None:
    import tempfile

    import numpy as np

    from repro_torch.core import CPU_SPLITS, LoopNest, WorkerPool, make_backend, matmul_benchmark
    from repro_torch.core.actions import apply_action, build_action_space, is_legal

    actions = build_action_space(CPU_SPLITS)
    rng = np.random.default_rng(0)
    bench = matmul_benchmark(4, 2048, 2048)
    nests, seen = [], set()
    while len(nests) < n:
        nest = LoopNest(bench)
        for _ in range(5):
            legal = [a for a in actions if is_legal(nest, a)]
            apply_action(nest, legal[int(rng.integers(len(legal)))])
        if nest.structure_key() not in seen:
            seen.add(nest.structure_key())
            nests.append(nest)
    local = make_backend("torch", device=device)
    local.measure(nests[0])
    t0 = time.perf_counter()
    for nest in nests:
        local.measure(nest)
    inproc = (time.perf_counter() - t0) / n
    kw = local.pool_spec()[1]
    for unpin in (False, True):
        with tempfile.TemporaryDirectory() as spy_dir:
            with WorkerPool("timed_torch", {**kw, "spy_dir": spy_dir, "unpin": unpin},
                            n_workers=1, start_method="spawn") as pool:
                pool.wait_ready(timeout_s=600)
                pool.measure_batch(nests[:1])
                t0 = time.perf_counter()
                for nest in nests:
                    pool.measure_batch([nest])
                pooled = (time.perf_counter() - t0) / n
            measure_s = sum(float(p.read_text()) for p in Path(spy_dir).glob("measure_s-*"))
        print(json.dumps({"row": f"card_pool_{'unpinned' if unpin else 'pinned'}", "n": n,
                          "per_task_ms": pooled * 1e3, "inproc_per_task_ms": inproc * 1e3,
                          "worker_measure_ms_per_task": measure_s / (n + 1) * 1e3}),
              flush=True)


# registered at the top level: the spawned worker re-imports this file
register_backend("timed_torch", _timed_torch_backend)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--card", action="store_true",
                    help="also time the card executor in and out of process")
    args = ap.parse_args()
    try:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip() or "no card", flush=True)
    except OSError:
        print("no card", flush=True)
    print(json.dumps({"cpus": len(os.sched_getaffinity(0))}), flush=True)
    for kind in ("queue", "pipe"):
        for spin in (False, True):
            for pin in (True, False):
                name = f"{kind}_{'pinned' if pin else 'unpinned'}{'_spin' if spin else ''}"
                _row(name, _round_trips(kind, pin, args.n, spin), kind=kind, pinned=pin,
                     spin=spin)
    for pin in (True, False):
        _row(f"queue_{'pinned' if pin else 'unpinned'}_depth2",
             _round_trips("queue", pin, args.n, False, depth=2), kind="queue", pinned=pin,
             spin=False, depth=2)
    _pool_rows(args.n)
    if args.card:
        _card_rows(min(args.n, 400))
    return 0


if __name__ == "__main__":
    sys.exit(main())
