"""Measurement-farm daemon of the port: serve card timings to remote tuners.

Runs a :class:`~repro_torch.core.measure_service.MeasureServer` on this
host — the machine whose hardware the timings should reflect — and serves
any number of tuner clients (``repro_torch.launch.tune --farm HOST:PORT``,
or ``make_backend("remote", addr=...)`` directly; clients of the JAX
package too, the wire format being the same).  ``--backend auto`` is the
card executor (``"torch"``), which raises where there is no card; ``tpu``
or ``numpy`` serve without one.  The default ``--measure pool`` wraps the
:class:`~repro_torch.core.measure.WorkerPool` — one spawned worker a card
for ``torch``, one pinned worker a core for the others — so every schedule
runs outside the farm's own process (a kernel fault kills a worker, not
the farm) and a hung schedule is bounded by ``--task-timeout-s`` (the
pool's hung-kill machinery) instead of wedging the farm.

Fleet capacity is bounded and observable: ``--queue-limit`` caps the
central admission queue (beyond it clients get ``overloaded`` +
``retry_after_s`` and back off), ``--coalesce-requests`` /
``--coalesce-nests`` bound how much queued cross-client work folds into
one pool batch, and the ``status`` op reports queue depth / inflight /
served / per-client counters.  SIGTERM (and ``--max-requests``) drains:
stop accepting, finish queued + inflight work, answer stragglers
``shutting_down``, exit 0 — so a supervised farm restarts cleanly.

    PYTHONPATH=src python -m repro_torch.launch.measure_farm \
        --addr 0.0.0.0:7461 --backend torch --measure pool

The first stdout line is ``[farm] listening on HOST:PORT ...`` (flushed),
so launchers and tests can scrape the bound port when ``--addr`` uses
port 0 (ephemeral).

The daemon doubles as its own client for operations checks:
``--status`` connects to a *running* farm, sends the ``status`` op and
pretty-prints the fleet view (queue depth/peak, inflight, ticket
pipeline, per-client served counts, drain state) — the thing an operator
looks at before deciding whether a farm can take another ``--fleet N``
of tuner clients.
"""
from __future__ import annotations

import argparse
import json
import signal
import socket
import sys
from typing import Any, Dict, Optional

from repro_torch.core.measure import MeasurementPolicy
from repro_torch.core.measure_service import (MeasureServer, parse_addr,
                                              recv_frame, send_frame)


def build_server(
    addr: str = "127.0.0.1:0",
    backend: str = "auto",
    measure: str = "pool",
    pool_workers: Optional[int] = None,
    task_timeout_s: Optional[float] = 120.0,
    repeats: Optional[int] = None,
    max_requests: Optional[int] = None,
    queue_limit: int = 32,
    coalesce_requests: int = 4,
    coalesce_nests: int = 64,
    coalesce_window_s: float = 0.0,
) -> MeasureServer:
    host, port = parse_addr(addr)
    kwargs: Dict[str, Any] = {"measure": measure}
    if measure == "pool":
        kwargs["pool_workers"] = pool_workers
        kwargs["pool_timeout_s"] = task_timeout_s
    if repeats is not None:
        kwargs["policy"] = MeasurementPolicy(
            repeats=repeats,
            max_repeats=max(repeats, MeasurementPolicy.max_repeats))
    return MeasureServer(host=host, port=port, backend=backend,
                         backend_kwargs=kwargs, max_requests=max_requests,
                         queue_limit=queue_limit,
                         coalesce_requests=coalesce_requests,
                         coalesce_nests=coalesce_nests,
                         coalesce_window_s=coalesce_window_s)


def farm_status(addr: str, timeout_s: float = 5.0) -> Dict[str, Any]:
    """Connect to a running farm and return its ``status`` op reply."""
    host, port = parse_addr(addr)
    with socket.create_connection((host, port), timeout=timeout_s) as sock:
        send_frame(sock, {"op": "status", "id": 0})
        reply = recv_frame(sock)
    if not isinstance(reply, dict) or not reply.get("ok"):
        raise ConnectionError(f"farm at {addr} returned {reply!r}")
    return reply


def print_status(addr: str, timeout_s: float = 5.0) -> int:
    """``--status``: pretty-print a running farm's fleet view."""
    try:
        st = farm_status(addr, timeout_s=timeout_s)
    except OSError as e:
        print(f"[farm] status: cannot reach {addr}: {e}", file=sys.stderr)
        return 1
    state = "draining" if st.get("draining") else "serving"
    print(f"[farm] {st.get('addr', addr)}  {state}  "
          f"backend={st.get('backend')}  hardware={st.get('hardware')!r}")
    print(f"  queue     depth={st.get('queue_depth')}/"
          f"{st.get('queue_limit')}  peak={st.get('queue_depth_peak')}  "
          f"deferred_clients={st.get('deferred_clients')}")
    print(f"  inflight  requests={st.get('inflight_requests')}  "
          f"nests={st.get('inflight_nests')}")
    print(f"  served    requests={st.get('served_requests')}  "
          f"nests={st.get('served_nests')}  "
          f"pool_batches={st.get('pool_batches')}  "
          f"coalesced={st.get('coalesced_batches')}")
    print(f"  rejected  overload={st.get('rejected_overload')}  "
          f"shutdown={st.get('rejected_shutdown')}  "
          f"errors={st.get('errors')}")
    print(f"  tickets   submitted={st.get('tickets_submitted')}  "
          f"deduped={st.get('tickets_deduped')}  "
          f"collected={st.get('tickets_collected')}  "
          f"acked={st.get('tickets_acked')}  "
          f"expired={st.get('tickets_expired')}  "
          f"outstanding={st.get('tickets_outstanding')}  "
          f"parked={st.get('tickets_parked')}")
    spn = st.get("service_s_per_nest")
    print(f"  pace      service_s_per_nest="
          f"{spn if spn is not None else 'n/a'}")
    clients = st.get("clients") or {}
    if clients:
        print("  clients   (nests served)")
        for name, n in sorted(clients.items(), key=lambda kv: -kv[1]):
            print(f"    {name}: {n}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--addr", default="127.0.0.1:0", metavar="HOST:PORT",
                    help="bind address (port 0 = ephemeral, printed on "
                         "the first stdout line); with --status, the "
                         "running farm to query")
    ap.add_argument("--status", action="store_true",
                    help="don't serve: connect to the farm at --addr, "
                         "pretty-print its status op (queue depth/peak, "
                         "inflight, ticket pipeline, per-client counts, "
                         "drain state) and exit")
    ap.add_argument("--backend", default="auto",
                    help="executor doing the timing: torch|numpy|tpu|auto "
                         "(auto = torch, the card)")
    ap.add_argument("--measure", default="pool", choices=("pool", "inproc"),
                    help="pool = measure in worker processes (one a card "
                         "for torch, one a core otherwise) with hung-kill "
                         "bounds (default)")
    ap.add_argument("--pool-workers", type=int, default=None)
    ap.add_argument("--task-timeout-s", type=float, default=120.0,
                    help="per-schedule hung-kill budget inside the pool")
    ap.add_argument("--repeats", type=int, default=None,
                    help="base best-of window (default: policy default)")
    ap.add_argument("--max-requests", type=int, default=None,
                    help="drain after N measure requests (tests/smoke)")
    ap.add_argument("--queue-limit", type=int, default=32,
                    help="admission queue bound; beyond it clients get "
                         "'overloaded' + retry_after_s (default 32)")
    ap.add_argument("--coalesce-requests", type=int, default=4,
                    help="max queued requests folded into one pool batch")
    ap.add_argument("--coalesce-nests", type=int, default=64,
                    help="max nests per coalesced pool batch")
    ap.add_argument("--coalesce-window-s", type=float, default=0.0,
                    help="batch-forming linger: hold an under-filled "
                         "batch open this long so near-simultaneous "
                         "submits from a pipelined fleet coalesce "
                         "(default 0 = dispatch eagerly)")
    args = ap.parse_args(argv)

    if args.status:
        return print_status(args.addr)

    server = build_server(
        addr=args.addr, backend=args.backend, measure=args.measure,
        pool_workers=args.pool_workers, task_timeout_s=args.task_timeout_s,
        repeats=args.repeats, max_requests=args.max_requests,
        queue_limit=args.queue_limit,
        coalesce_requests=args.coalesce_requests,
        coalesce_nests=args.coalesce_nests,
        coalesce_window_s=args.coalesce_window_s)

    def _on_sigterm(signum, frame):  # noqa: ARG001 - signal signature
        # drain, don't die: finish queued + inflight work, answer new
        # requests shutting_down, release serve_forever → exit 0
        print("[farm] SIGTERM: draining", flush=True)
        server.drain()

    signal.signal(signal.SIGTERM, _on_sigterm)

    print(f"[farm] listening on {server.addr} "
          f"backend={args.backend} measure={args.measure} "
          f"queue_limit={args.queue_limit} "
          f"hardware={server.hardware!r}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    print("[farm] stopped", json.dumps(server.stats()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
