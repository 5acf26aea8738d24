"""Remote measurement farm: fleet-grade RPC timing service + client backend.

LoopTune learns from *measured* rewards, which at fleet scale means the
timing must move off the training host: AutoTVM's distributed RPC runners
and loop_tool's CompilerGym service split both converge on a shared
**measurement farm** that many tuner clients talk to over the network.
This module is that farm, layered on the existing measurement subsystem:

* :class:`MeasureServer` — a TCP service (length-prefixed JSON frames)
  that wraps any registered backend on the *measuring* host.  Connection
  threads only parse frames; measurement flows through a **bounded
  central queue** with admission control (a full queue answers
  ``overloaded`` with a ``retry_after_s`` hint instead of buffering
  without bound), **per-client round-robin fair scheduling** (one greedy
  tuner cannot starve the fleet), and **cross-client batch coalescing**
  — a single dispatcher folds up to ``coalesce_requests`` queued
  requests into one :meth:`measure_batch` call, so the
  :class:`~repro_torch.core.measure.WorkerPool` dedups and parallelizes
  *across* clients.  A ``status`` op reports queue depth / inflight /
  served counters, and :meth:`drain` (SIGTERM in ``launch.measure_farm``)
  stops accepting, finishes queued + inflight work, answers later
  requests ``shutting_down``, and lets the process exit 0.  On a card host
  the farm's backend is the card executor (``"auto"`` is ``"torch"``), and
  with ``measure="pool"`` every schedule runs in a spawned worker a card.

* :class:`RemoteMeasuredBackend` — the client, registered as
  ``make_backend("remote", addr="host:port")``.  Robustness is the point:
  per-request deadlines, reconnect with exponential backoff and jitter,
  **backpressure honoring** (an ``overloaded``/``shutting_down`` reply is
  waited out with the server's ``retry_after_s`` hint, jittered, without
  consuming transport retries), bounded inflight (one outstanding request,
  batches chunked at ``max_nests_per_request``), and *graceful
  degradation* — a farm that is unreachable, killed mid-batch, or
  persistently overloaded warns once and falls back to local in-process
  measurement on the ``fallback`` backend spec, so a tune is never failed
  by the farm.  The fallback is the caller's spec: ``"auto"`` is
  ``"torch"``, which raises where there is no card, so a degraded client
  never lands silently on the CPU.  Degradation is no longer permanent: periodic re-probes
  (every ``reprobe_every_batches`` batches or ``reprobe_after_s``
  seconds) **re-promote** the client to remote measurement when the farm
  comes back.  Counters (``requests/retries/reconnects/degraded/
  repromotions/backpressure_waits/farm_rtt``) ride ``measure_stats()``
  into ``tuner.stats()``.

Wire protocol (version :data:`PROTO_VERSION`): each frame is a 4-byte
big-endian length followed by that many bytes of UTF-8 JSON.  Requests are
``{"op": "ping"}`` (handshake: hardware / peak / backend identity),
``{"op": "status"}`` (health: the server's :meth:`MeasureServer.stats`),
and ``{"op": "measure", "id": n, "client": cid, "nests": [[contraction,
structure_key], ...]}``; replies echo ``id`` and carry either
``measurements`` (``Measurement.ship`` tuples) or ``error`` (a server-side
traceback).  Admission rejections additionally carry ``error_kind``
(``"overloaded"`` | ``"shutting_down"``) and ``retry_after_s`` — the
client treats both as backpressure, not as faults.  A transport failure
is retried; any other ``error`` reply is re-raised — an evaluator bug on
the farm is not a fault to retry around (the same rule the worker pool
applies).

**Pipelined (ticketed) measurement** rides the same framing:

* ``{"op": "submit", "id": n, "client": cid, "ticket": t, "nests":
  [...]}`` passes the same admission control as ``measure`` but is
  acknowledged immediately (``{"ok": true, "ticket": t, "accepted":
  true}``); the dispatcher parks the finished result in a per-client
  ticket table instead of replying.  Tickets are idempotent: a resubmit
  of a known ``(client, ticket)`` — the client's recovery move when an
  ack was lost to a dropped connection — is re-acked with ``duplicate``
  instead of being measured again, which is what makes reconnect
  recovery **exactly-once**.
* ``{"op": "collect", "id": n, "client": cid, "tickets": [...],
  "timeout_s": s, "ack": [...]}`` blocks (bounded) until at least one
  named ticket has a parked result and returns ``done`` (ticket ->
  measure reply body), ``pending`` (still queued/inflight) and
  ``unknown`` (lost to a farm restart or TTL expiry — the client
  resubmits those).  Results stay parked until the client *acks* them on
  a later request (at-least-once delivery across reconnects); unacked
  results expire after ``ticket_ttl_s``.  Parked results are keyed by
  the stable ``client`` id, not the connection, so a reconnected client
  collects work it submitted on a previous socket.

:meth:`MeasureServer.drain` finishes queued + inflight ticketed work and
then **lingers** (up to ``drain_linger_s``) until parked results are
collected and acked, so SIGTERM with tickets outstanding hands every
result to its client before the process exits 0.

The wire format is the JAX package's, byte for byte, so a farm of either
package serves clients of the other.  One field is the port's own: a
contraction timed at another type than float32 (a ``"bfloat16"`` record's
rewards on the card) carries ``"dtype"``, which a float32 contraction never
does; only a farm of this package measures those.
"""
from __future__ import annotations

import json
import os
import random
import socket
import struct
import threading
import time
import traceback
import warnings
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .backend import Backend, backend_name, make_backend
from .loop_ir import Contraction, LoopNest, TensorSpec
from .measure import (
    MeasuredBackend,
    Measurement,
    MeasurementPolicy,
    measure_local,
)
from .registry import current_hardware

PROTO_VERSION = 2

#: refuse frames beyond this (a corrupt length prefix must not OOM the host)
MAX_FRAME_BYTES = 64 << 20

#: reply kinds the client treats as backpressure instead of faults
BACKPRESSURE_KINDS = ("overloaded", "shutting_down")


class ProtocolError(RuntimeError):
    """Malformed frame / reply shape — treated like a connection fault."""


class FarmUnavailableError(ConnectionError):
    """The farm could not serve a request within the retry budget."""


class RemoteMeasureError(RuntimeError):
    """The farm's evaluator raised — re-raised at the client, never retried."""


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def send_frame(sock: socket.socket, obj: Any) -> None:
    data = json.dumps(obj).encode()
    if len(data) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {len(data)} bytes exceeds limit")
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """``n`` bytes, or None on a clean EOF at a frame boundary."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if buf:
                raise ProtocolError("connection closed mid-frame")
            return None
        buf += chunk
    return buf


def recv_frame(sock: socket.socket) -> Optional[Any]:
    """One decoded frame, or None when the peer closed the connection."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (n,) = struct.unpack(">I", header)
    if n > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame length {n} exceeds limit")
    data = _recv_exact(sock, n)
    if data is None:
        raise ProtocolError("connection closed before frame payload")
    try:
        return json.loads(data)
    except ValueError as e:
        raise ProtocolError(f"undecodable frame: {e}") from None


# ---------------------------------------------------------------------------
# Wire encoding for the schedule transport
# ---------------------------------------------------------------------------


def _tensor_to_wire(t: Optional[TensorSpec]) -> Optional[Dict[str, Any]]:
    if t is None:
        return None
    return {"name": t.name, "iterators": list(t.iterators),
            "dims": list(t.dims)}


def _tensor_from_wire(d: Optional[Dict[str, Any]]) -> Optional[TensorSpec]:
    if d is None:
        return None
    return TensorSpec(d["name"], tuple(d["iterators"]), tuple(d["dims"]))


def contraction_to_wire(c: Contraction) -> Dict[str, Any]:
    out = {
        "name": c.name,
        "out": _tensor_to_wire(c.out),
        "lhs": _tensor_to_wire(c.lhs),
        "rhs": _tensor_to_wire(c.rhs),
        "iter_sizes": dict(c.iter_sizes),
    }
    if c.dtype != "float32":  # float32 frames stay the JAX package's bytes
        out["dtype"] = c.dtype
    return out


def contraction_from_wire(d: Dict[str, Any]) -> Contraction:
    return Contraction(
        name=d["name"],
        out=_tensor_from_wire(d["out"]),
        lhs=_tensor_from_wire(d["lhs"]),
        rhs=_tensor_from_wire(d["rhs"]),
        iter_sizes={k: int(v) for k, v in d["iter_sizes"].items()},
        dtype=str(d.get("dtype", "float32")),
    )


def structure_key_to_wire(key: Tuple) -> List:
    name, body, n_compute, cursor = key
    return [name, [list(level) for level in body], n_compute, cursor]


def structure_key_from_wire(w: Sequence) -> Tuple:
    name, body, n_compute, cursor = w
    return (name, tuple((it, int(c), int(s)) for it, c, s in body),
            int(n_compute), int(cursor))


def nest_to_wire(nest: LoopNest) -> List:
    return [contraction_to_wire(nest.contraction),
            structure_key_to_wire(nest.structure_key())]


def nest_from_wire(w: Sequence) -> LoopNest:
    contraction = contraction_from_wire(w[0])
    return LoopNest.from_structure_key(contraction,
                                       structure_key_from_wire(w[1]))


def parse_addr(addr: Union[str, Tuple[str, int]]) -> Tuple[str, int]:
    """``"host:port"`` (or a ready pair) -> ``(host, port)``."""
    if isinstance(addr, (tuple, list)):
        host, port = addr
        return str(host), int(port)
    host, _, port = str(addr).rpartition(":")
    if not host or not port:
        raise ValueError(f"addr must be 'host:port', got {addr!r}")
    return host, int(port)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class _PendingRequest:
    """One admitted measure request waiting in (or dispatched from) the
    central queue.  Holds everything the dispatcher needs to answer on the
    originating connection — ``send_lock`` serializes dispatcher replies
    against the connection thread's own ping/status/rejection replies.
    A ``ticket`` marks a pipelined ``submit``: the dispatcher parks its
    result in the server's ticket table instead of replying."""

    __slots__ = ("conn", "send_lock", "req_id", "client", "nests", "t_enq",
                 "ticket")

    def __init__(self, conn: socket.socket, send_lock: threading.Lock,
                 req_id: Any, client: str, nests: List[LoopNest],
                 ticket: Optional[str] = None):
        self.conn = conn
        self.send_lock = send_lock
        self.req_id = req_id
        self.client = client
        self.nests = nests
        self.t_enq = time.monotonic()
        self.ticket = ticket


class MeasureServer:
    """The farm side: measure shipped schedules on this host's backend.

    Connection threads only read frames and answer control ops; every
    measure request passes **admission control** into a bounded central
    queue (``queue_limit`` requests; beyond it the server answers
    ``overloaded`` with a ``retry_after_s`` hint derived from the observed
    per-nest service time, instead of buffering without bound).  A single
    dispatcher thread drains the queue **round-robin across client ids**
    and coalesces up to ``coalesce_requests`` requests (``coalesce_nests``
    nests) into one backend ``measure_batch`` call — with ``measure=
    "pool"`` the :class:`WorkerPool` then dedups duplicate structures and
    parallelizes the combined batch across this host's workers, and the
    pool's hung-kill machinery (``task_timeout_s`` → ``pool_timeout_s``)
    bounds every batch, so clients never wait on a wedged farm forever.

    :meth:`drain` (wired to SIGTERM by ``launch.measure_farm``) stops
    accepting connections, finishes every queued and inflight request,
    answers anything arriving later with a clean ``shutting_down`` reply
    (clients treat it like ``overloaded``), and releases
    :meth:`serve_forever`, so a supervised farm restarts without severing
    clients mid-batch.  ``max_requests`` triggers the same drain after N
    admitted requests — a batch scheduler's self-terminating unit.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        backend: Union[str, Backend] = "auto",
        backend_kwargs: Optional[Dict[str, Any]] = None,
        max_requests: Optional[int] = None,
        queue_limit: int = 32,
        coalesce_requests: int = 4,
        coalesce_nests: int = 64,
        coalesce_window_s: float = 0.0,
        drain_linger_s: float = 30.0,
        ticket_ttl_s: float = 600.0,
    ):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if coalesce_requests < 1 or coalesce_nests < 1:
            raise ValueError("coalesce_requests/coalesce_nests must be >= 1")
        self.backend = make_backend(backend, **(backend_kwargs or {}))
        self.hardware = current_hardware()
        self.max_requests = max_requests
        self.queue_limit = int(queue_limit)
        self.coalesce_requests = int(coalesce_requests)
        self.coalesce_nests = int(coalesce_nests)
        # batch-forming linger: with work queued but fewer than
        # coalesce_requests clients represented, the dispatcher waits up to
        # this long for stragglers before taking the batch — a pipelined
        # fleet's round-synchronized submits then fold into one backend
        # batch instead of serializing.  0 = dispatch eagerly.
        self.coalesce_window_s = float(coalesce_window_s)
        self.requests = 0  # admitted measure requests
        self.errors = 0
        # fair-queue state + counters, all guarded by _cond's lock
        self._cond = threading.Condition()
        self._queues: Dict[str, Deque[_PendingRequest]] = {}
        self._ready: Deque[str] = deque()  # round-robin rotation
        self._queued = 0
        self._queued_nests = 0
        # admission fairness: clients rejected for overload hold a slot
        # reservation (client id -> last-rejection time) other clients may
        # not take until they return or the reservation expires
        self._deferred: Dict[str, float] = {}
        self._deferred_ttl_s = 5.0
        self._draining = False
        self._drained = threading.Event()
        self._drain_t0: Optional[float] = None
        self.drain_linger_s = float(drain_linger_s)
        self.ticket_ttl_s = float(ticket_ttl_s)
        # pipelined submit/collect state: (client, ticket) -> lifecycle
        # ("queued" | "inflight" | "done"), with finished results parked
        # until the client collects + acks them (or the TTL expires)
        self._tickets: Dict[Tuple[str, str], str] = {}
        self._ticket_results: Dict[Tuple[str, str],
                                   Tuple[float, Dict[str, Any]]] = {}
        self.tickets_submitted = 0
        self.tickets_deduped = 0
        self.tickets_collected = 0
        self.tickets_acked = 0
        self.tickets_expired = 0
        self.served_requests = 0
        self.served_nests = 0
        self.rejected_overload = 0
        self.rejected_shutdown = 0
        self.pool_batches = 0
        self.coalesced_batches = 0
        self.queue_depth_peak = 0
        self.inflight_requests = 0
        self.inflight_nests = 0
        self.per_client_served: Dict[str, int] = {}
        self._service_s_per_nest: Optional[float] = None  # EWMA
        self._measure_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._closed = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._listener = socket.create_server((host, int(port)))
        self.host, self.port = self._listener.getsockname()[:2]
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"looptune-farm-dispatch-{self.port}")
        self._dispatcher.start()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "MeasureServer":
        """Accept connections on a background thread; returns self."""
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"looptune-farm-{self.port}")
        t.start()
        self._threads.append(t)
        return t and self

    def serve_forever(self) -> None:
        """Accept connections on the calling thread until :meth:`close` or
        a completed :meth:`drain` (queued + inflight work finishes first)."""
        self._accept_loop()
        if self._draining and not self._closed.is_set():
            self._drained.wait()
        self.close()

    def drain(self, wait: bool = False,
              timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop accepting, finish queued + inflight
        requests, answer new ones ``shutting_down``.  Returns True once the
        queue is flushed (immediately when ``wait`` is False)."""
        with self._cond:
            first = not self._draining
            self._draining = True
            if self._drain_t0 is None:
                self._drain_t0 = time.monotonic()
            self._cond.notify_all()
        if first:
            self._shutdown_listener()
        if wait:
            return self._drained.wait(timeout)
        return True

    def _shutdown_listener(self) -> None:
        # shutdown() wakes a thread blocked in accept(); without it the
        # in-flight syscall pins the kernel socket open past close() and the
        # port stays bound (a restarted farm then can't take it back)
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        self._drained.set()
        self._shutdown_listener()
        # sever live connections: a close() must look like a killed farm to
        # clients, not a server that keeps answering through old sockets
        with self._state_lock:
            conns, self._conns = list(self._conns), []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        close = getattr(self.backend, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "MeasureServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- connection handling ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set() and not self._draining:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            with self._state_lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        try:
            with conn:
                while not self._closed.is_set():
                    try:
                        req = recv_frame(conn)
                    except ProtocolError:
                        return  # garbage in: drop the connection
                    if req is None:
                        return
                    reply = self._handle(req, conn, send_lock)
                    if reply is not None:  # None = queued; dispatcher answers
                        with send_lock:
                            send_frame(conn, reply)
        except OSError:
            return  # client went away mid-reply
        finally:
            with self._state_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    @staticmethod
    def _conn_client(conn: socket.socket) -> str:
        try:
            host, port = conn.getpeername()[:2]
            return f"{host}:{port}"
        except OSError:
            return "unknown"

    def _handle(self, req: Dict[str, Any], conn: socket.socket,
                send_lock: threading.Lock) -> Optional[Dict[str, Any]]:
        op = req.get("op")
        reply: Dict[str, Any] = {"id": req.get("id"), "proto": PROTO_VERSION}
        try:
            if op == "ping":
                reply.update(ok=True, hardware=self.hardware,
                             backend=backend_name(self.backend),
                             peak=float(self.backend.peak()),
                             draining=self._draining)
            elif op == "status":
                reply.update(ok=True, **self.stats())
            elif op == "measure":
                nests = [nest_from_wire(w) for w in req["nests"]]
                client = str(req.get("client") or self._conn_client(conn))
                pending = _PendingRequest(conn, send_lock, req.get("id"),
                                          client, nests)
                rejection = self._admit(pending)
                if rejection is None:
                    return None  # admitted; the dispatcher replies
                reply.update(rejection)
            elif op == "submit":
                nests = [nest_from_wire(w) for w in req["nests"]]
                client = str(req.get("client") or self._conn_client(conn))
                ticket = str(req.get("ticket"))
                pending = _PendingRequest(conn, send_lock, req.get("id"),
                                          client, nests, ticket=ticket)
                rejection = self._admit(pending)
                if rejection is None:
                    # admitted: ack now, the dispatcher parks the result
                    reply.update(ok=True, ticket=ticket, accepted=True)
                else:
                    reply.update(rejection)
            elif op == "collect":
                client = str(req.get("client") or self._conn_client(conn))
                reply.update(self._collect(client, req))
            else:
                reply.update(ok=False, error=f"unknown op {op!r}")
        except Exception:  # noqa: BLE001 — report, let the client decide
            with self._cond:
                self.errors += 1
            reply.update(ok=False, error=traceback.format_exc())
        return reply

    # -- admission control -------------------------------------------------------

    def _retry_after_locked(self) -> float:
        """Backpressure hint: how long until the backlog likely clears,
        from the EWMA per-nest service time (crude, but it spaces a fleet's
        retries to the farm's actual pace instead of a fixed constant)."""
        per_nest = self._service_s_per_nest or 0.05
        backlog = self._queued_nests + self.inflight_nests + 1
        return min(5.0, max(0.05, per_nest * backlog))

    def _admit(self, p: _PendingRequest) -> Optional[Dict[str, Any]]:
        """Enqueue under the queue bound, or return a rejection reply.
        Explicit rejection is the contract: a client told ``overloaded``
        backs off for ``retry_after_s``, while unbounded buffering would
        instead time out every client's deadline at once.

        Fairness starts at admission, not just in the queue: a freed slot
        grabbed first-come-first-served always goes to the client that was
        just served (it re-sends instantly, while a rejected client is
        still sleeping out its ``retry_after_s``), which starves the
        rejected client indefinitely.  So an overload rejection leaves a
        slot *reservation* behind — other clients cannot fill capacity
        that rejected clients are coming back for — with a TTL so a client
        that gave up does not pin capacity."""
        trigger_drain = False
        with self._cond:
            if p.ticket is not None:
                # ticket idempotency before everything else (including the
                # drain check — a resubmit of admitted work must re-ack, not
                # get rejected): a known (client, ticket) is never measured
                # twice, whatever state it is in
                state = self._tickets.get((p.client, p.ticket))
                if state is not None:
                    self.tickets_deduped += 1
                    return {"ok": True, "ticket": p.ticket,
                            "duplicate": True, "state": state}
            if self._draining or self._closed.is_set():
                self.rejected_shutdown += 1
                return {"ok": False, "error_kind": "shutting_down",
                        "retry_after_s": round(self._retry_after_locked(), 3),
                        "error": "farm is draining; no new work accepted"}
            now = time.monotonic()
            for c in [c for c, t in self._deferred.items()
                      if now - t > self._deferred_ttl_s]:
                del self._deferred[c]
            reserved = sum(1 for c in self._deferred if c != p.client)
            if (self._queued >= self.queue_limit
                    or (p.client not in self._deferred
                        and self._queued + reserved >= self.queue_limit)):
                self.rejected_overload += 1
                self._deferred[p.client] = now
                return {"ok": False, "error_kind": "overloaded",
                        "retry_after_s": round(self._retry_after_locked(), 3),
                        "error": (f"admission queue full "
                                  f"({self._queued}/{self.queue_limit}, "
                                  f"{reserved} reserved)")}
            self._deferred.pop(p.client, None)
            q = self._queues.get(p.client)
            if q is None:
                q = self._queues[p.client] = deque()
            if not q:
                self._ready.append(p.client)
            q.append(p)
            self._queued += 1
            self._queued_nests += len(p.nests)
            self.queue_depth_peak = max(self.queue_depth_peak, self._queued)
            self.requests += 1
            if p.ticket is not None:
                self._tickets[(p.client, p.ticket)] = "queued"
                self.tickets_submitted += 1
            if (self.max_requests is not None
                    and self.requests >= self.max_requests):
                trigger_drain = True
            self._cond.notify_all()
        if trigger_drain:
            self.drain()  # this request was admitted and will be served
        return None

    # -- the dispatcher ----------------------------------------------------------

    def _take_batch_locked(self) -> List[_PendingRequest]:
        """Round-robin across client ids: one request per ready client per
        rotation, until the coalescing budget fills.  Fairness unit is the
        request — a greedy client's pile-up waits behind one request from
        every other client each cycle."""
        batch: List[_PendingRequest] = []
        n_nests = 0
        while self._ready and len(batch) < self.coalesce_requests:
            client = self._ready[0]
            q = self._queues[client]
            if batch and n_nests + len(q[0].nests) > self.coalesce_nests:
                break
            p = q.popleft()
            self._ready.popleft()
            if q:
                self._ready.append(client)
            else:
                del self._queues[client]
            self._queued -= 1
            self._queued_nests -= len(p.nests)
            batch.append(p)
            n_nests += len(p.nests)
        return batch

    def _purge_tickets_locked(self, now: float) -> None:
        """Expire parked results a client never came back for — the table
        must not grow without bound on abandoned tickets."""
        for key in [k for k, (t, _) in self._ticket_results.items()
                    if now - t > self.ticket_ttl_s]:
            del self._ticket_results[key]
            self._tickets.pop(key, None)
            self.tickets_expired += 1

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._ready:
                    if self._closed.is_set():
                        return
                    if self._draining:
                        # queued + inflight ticketed work is already done
                        # here; linger until parked results are collected
                        # and acked so SIGTERM never strands a client's
                        # tickets (bounded — a dead client can't wedge
                        # shutdown past drain_linger_s)
                        if (not self._ticket_results
                                or (self._drain_t0 is not None
                                    and time.monotonic() - self._drain_t0
                                    >= self.drain_linger_s)):
                            self._drained.set()
                            return
                    self._purge_tickets_locked(time.monotonic())
                    self._cond.wait(timeout=0.2)
                if self._closed.is_set():
                    return
                if self.coalesce_window_s > 0 and not self._draining:
                    # batch-forming linger (see __init__): hold the batch
                    # open briefly while it is still under-filled so
                    # near-simultaneous submits from a pipelined fleet
                    # coalesce instead of dispatching one by one
                    deadline = time.monotonic() + self.coalesce_window_s
                    while (self._queued < self.coalesce_requests
                           and not self._draining
                           and not self._closed.is_set()):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                    if self._closed.is_set():
                        return
                    if not self._ready:
                        continue
                batch = self._take_batch_locked()
                for p in batch:
                    if p.ticket is not None:
                        self._tickets[(p.client, p.ticket)] = "inflight"
                self.inflight_requests = len(batch)
                self.inflight_nests = sum(len(p.nests) for p in batch)
            try:
                self._run_batch(batch)
            finally:
                with self._cond:
                    self.inflight_requests = 0
                    self.inflight_nests = 0
                    self._cond.notify_all()

    def _measure_nests(self, nests: Sequence[LoopNest]) -> List[Measurement]:
        with self._measure_lock:
            if isinstance(self.backend, MeasuredBackend):
                return self.backend.measure_batch(nests)
            return [measure_local(self.backend, n) for n in nests]

    def _run_batch(self, batch: List[_PendingRequest]) -> None:
        nests = [n for p in batch for n in p.nests]
        t0 = time.monotonic()
        try:
            ms = self._measure_nests(nests)
        except Exception:  # noqa: BLE001 — report, let the client decide
            with self._cond:
                self.errors += 1
            if len(batch) > 1:
                # isolate the fault: one client's broken schedule must not
                # fail the coalesced neighbors — re-run each request alone
                # so only the faulty one gets the error reply
                for p in batch:
                    self._run_batch([p])
                return
            self._finish(batch[0],
                         {"ok": False, "error": traceback.format_exc()})
            return
        per_nest = (time.monotonic() - t0) / max(1, len(nests))
        with self._cond:
            self._service_s_per_nest = (
                per_nest if self._service_s_per_nest is None
                else 0.7 * self._service_s_per_nest + 0.3 * per_nest)
            self.pool_batches += 1
            if len(batch) > 1:
                self.coalesced_batches += 1
        i = 0
        for p in batch:
            part = ms[i:i + len(p.nests)]
            i += len(p.nests)
            # count before replying: a client that saw its reply must see
            # itself in stats(), even if it asks immediately
            with self._cond:
                self.served_requests += 1
                self.served_nests += len(p.nests)
                self.per_client_served[p.client] = (
                    self.per_client_served.get(p.client, 0) + 1)
            self._finish(p, {"ok": True, "hardware": self.hardware,
                             "measurements": [list(m.ship()) for m in part]})

    def _finish(self, p: _PendingRequest, body: Dict[str, Any]) -> None:
        """Deliver a finished request: blocking requests get their reply on
        the originating connection; ticketed ones park the result for
        :meth:`_collect` (keyed by client id, so it survives reconnects)."""
        if p.ticket is None:
            self._reply(p, body)
            return
        with self._cond:
            key = (p.client, p.ticket)
            # a ticket acked or expired while inflight just drops its result
            if key in self._tickets:
                self._tickets[key] = "done"
                self._ticket_results[key] = (time.monotonic(), body)
            self._cond.notify_all()

    def _collect(self, client: str, req: Dict[str, Any]) -> Dict[str, Any]:
        """The ``collect`` op body: ack-then-gather.  Runs on the
        connection thread — blocking here (bounded by the capped
        ``timeout_s``) is the long-poll that lets a client sleep until one
        of its tickets finishes instead of spinning."""
        tickets = [str(t) for t in (req.get("tickets") or [])]
        acks = [str(t) for t in (req.get("ack") or [])]
        timeout = min(max(0.0, float(req.get("timeout_s") or 0.0)), 30.0)
        deadline = time.monotonic() + timeout
        with self._cond:
            for t in acks:
                key = (client, t)
                if self._ticket_results.pop(key, None) is not None:
                    self.tickets_acked += 1
                self._tickets.pop(key, None)
            if acks:
                self._cond.notify_all()  # the drain linger watches the table
            while True:
                done = {t: self._ticket_results[(client, t)][1]
                        for t in tickets
                        if (client, t) in self._ticket_results}
                if done or self._closed.is_set():
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=min(remaining, 0.2))
            self.tickets_collected += len(done)
            pending = [t for t in tickets
                       if t not in done and (client, t) in self._tickets]
            unknown = [t for t in tickets
                       if t not in done and t not in pending]
        return {"ok": True, "done": done, "pending": pending,
                "unknown": unknown}

    def _reply(self, p: _PendingRequest, body: Dict[str, Any]) -> None:
        reply: Dict[str, Any] = {"id": p.req_id, "proto": PROTO_VERSION}
        reply.update(body)
        try:
            with p.send_lock:
                send_frame(p.conn, reply)
        except (OSError, ProtocolError):
            pass  # client went away; its measurement is dropped

    # -- observability -----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "addr": self.addr,
                "requests": self.requests,
                "errors": self.errors,
                "hardware": self.hardware,
                "backend": backend_name(self.backend),
                "queue_depth": self._queued,
                "queue_limit": self.queue_limit,
                "queue_depth_peak": self.queue_depth_peak,
                "inflight_requests": self.inflight_requests,
                "inflight_nests": self.inflight_nests,
                "served_requests": self.served_requests,
                "served_nests": self.served_nests,
                "rejected_overload": self.rejected_overload,
                "rejected_shutdown": self.rejected_shutdown,
                "deferred_clients": len(self._deferred),
                "pool_batches": self.pool_batches,
                "coalesced_batches": self.coalesced_batches,
                "tickets_submitted": self.tickets_submitted,
                "tickets_deduped": self.tickets_deduped,
                "tickets_collected": self.tickets_collected,
                "tickets_acked": self.tickets_acked,
                "tickets_expired": self.tickets_expired,
                "tickets_outstanding": len(self._tickets),
                "tickets_parked": len(self._ticket_results),
                "draining": self._draining,
                "clients": dict(self.per_client_served),
                "service_s_per_nest": (
                    round(self._service_s_per_nest, 6)
                    if self._service_s_per_nest is not None else None),
            }


# ---------------------------------------------------------------------------
# Client backend
# ---------------------------------------------------------------------------


class FarmTicket:
    """An in-flight async measurement: the opaque handle
    :meth:`RemoteMeasuredBackend.submit_batch` returns and
    :meth:`RemoteMeasuredBackend.wait` resolves.  ``tickets`` maps each
    wire ticket to its slice of ``nests``; ``local`` holds the tail that
    was measured synchronously on the fallback when the client degraded
    mid-submit."""

    __slots__ = ("nests", "tickets", "local", "local_at")

    def __init__(self, nests: List[LoopNest]):
        self.nests = nests
        self.tickets: List[Tuple[str, int, int]] = []  # (ticket, lo, hi)
        self.local: Optional[List[Measurement]] = None
        self.local_at = 0

    def __len__(self) -> int:
        return len(self.nests)


class RemoteMeasuredBackend(MeasuredBackend):
    """Measurement backend whose timings come from a remote farm.

    ``make_backend("remote", addr="host:port", fallback="torch")``.  The
    client ships ``(contraction, structure_key)`` batches (chunked at
    ``max_nests_per_request``, one request in flight at a time), receives
    full :class:`Measurement` records plus the farm host's hardware
    descriptor (:meth:`measured_hardware` — the registry stamps records
    with it), and normalizes rewards by the *farm's* ``peak()`` (learned
    from the handshake), since that is the machine producing the GFLOPS.

    Fault model: transport failures (connect refused, request deadline
    exceeded, connection dropped mid-batch) are retried with exponential
    backoff + jitter up to ``max_retries``.  Explicit **backpressure**
    replies (``overloaded`` / ``shutting_down``) are not faults: the
    client waits the server's ``retry_after_s`` hint (with jitter, so a
    fleet desynchronizes) without consuming transport retries, up to
    ``backpressure_budget_s`` per request.  Past either budget the backend
    *degrades* — warns once, and measures on the local ``fallback``
    backend instead, so a tune is never failed by the farm.  While
    degraded it **re-probes** the farm every ``reprobe_every_batches``
    batches or ``reprobe_after_s`` seconds and re-promotes itself to
    remote measurement on a successful handshake (``repromotions``
    counter).  Server-side evaluator errors re-raise.

    **Pipelined path** (``can_measure_async``): :meth:`submit_batch`
    ships nests as ticketed ``submit`` requests (chunked, at most
    ``inflight_window`` tickets outstanding) and returns a
    :class:`FarmTicket` immediately; :meth:`collect` drains finished
    tickets opportunistically and :meth:`wait` blocks until a handle
    fully resolves.  Tickets are idempotent on the farm, so an ack lost
    to a dropped connection is recovered by resubmitting the same ticket
    after reconnect (``tickets_resubmitted``) without double-measuring;
    results park server-side keyed by ``client_id`` until acked, so they
    too survive a reconnect.  A degradation mid-flight resolves every
    unserved ticket on the local fallback — :meth:`wait` always
    completes.  The overlap instrumentation (``overlap_ratio``:
    wall-clock with >=1 ticket outstanding over total measure
    wall-clock) quantifies how much tuner work actually hid behind
    in-flight measurements.
    """

    name = "remote"
    can_measure_async = True

    def __init__(
        self,
        addr: Union[str, Tuple[str, int]],
        fallback: str = "auto",
        fallback_kwargs: Optional[Dict[str, Any]] = None,
        policy: Optional[MeasurementPolicy] = None,
        repeats: Optional[int] = None,
        deadline_s: float = 120.0,
        connect_timeout_s: float = 5.0,
        max_retries: int = 3,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        backpressure_budget_s: float = 60.0,
        max_nests_per_request: int = 64,
        reprobe_every_batches: int = 8,
        reprobe_after_s: float = 30.0,
        client_id: Optional[str] = None,
        inflight_window: int = 4,
        collect_poll_s: float = 5.0,
    ):
        super().__init__(policy=policy, repeats=repeats, measure="inproc")
        self.measure_mode = "remote"
        self.host, self.port = parse_addr(addr)
        if not isinstance(fallback, str):
            raise TypeError(
                "fallback must be a backend registry name (the degraded "
                f"path is built lazily), got {type(fallback).__name__}")
        if max_nests_per_request < 1:
            raise ValueError("max_nests_per_request must be >= 1")
        self.fallback_spec = fallback
        self.fallback_kwargs = dict(fallback_kwargs or {})
        self.deadline_s = deadline_s
        self.connect_timeout_s = connect_timeout_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.backpressure_budget_s = backpressure_budget_s
        self.max_nests_per_request = int(max_nests_per_request)
        self.reprobe_every_batches = max(1, int(reprobe_every_batches))
        self.reprobe_after_s = float(reprobe_after_s)
        # the fair-queue identity the farm schedules on: stable per backend
        # instance, unique across a fleet of tuner processes
        self.client_id = client_id or (
            f"{socket.gethostname()}-{os.getpid()}-"
            f"{random.getrandbits(24):06x}")
        self._sock: Optional[socket.socket] = None
        self._local: Optional[Backend] = None
        self._req_id = 0
        self.degraded = False
        self.degraded_reason: Optional[str] = None
        self._warned_fallback = False
        self._batches_since_probe = 0
        self._last_probe_t = time.monotonic()
        self.remote_hardware: Optional[str] = None
        self.remote_backend: Optional[str] = None
        self._remote_peak: Optional[float] = None
        # the farm counters tuner.stats() reports
        self.n_requests = 0
        self.n_retries = 0
        self.n_connects = 0
        self.n_reconnects = 0
        self.n_degraded_batches = 0
        self.n_degradations = 0
        self.n_repromotions = 0
        self.n_probes = 0
        self.n_backpressure_waits = 0
        self.backpressure_wait_s = 0.0
        self.farm_rtt_s = 0.0
        self.last_rtt_s = 0.0
        # pipelined submit/collect state: tickets outstanding on the farm,
        # results collected but not yet consumed by wait(), failures to
        # re-raise, and acks owed to the farm (piggybacked on the next
        # collect so parked results are released)
        self.inflight_window = max(1, int(inflight_window))
        self.collect_poll_s = float(collect_poll_s)
        self._ticket_seq = 0
        self._outstanding: Dict[str, List[LoopNest]] = {}
        self._ready: Dict[str, List[Measurement]] = {}
        self._failed: Dict[str, str] = {}
        self._ack_pending: List[str] = []
        self._resubmits: Dict[str, int] = {}
        self.n_tickets_submitted = 0
        self.n_tickets_collected = 0
        self.n_tickets_resubmitted = 0
        self.inflight_peak = 0
        # overlap instrumentation: wall-clock with >=1 ticket outstanding
        # vs. total measure wall-clock (first measure op -> last)
        self._overlap_s = 0.0
        self._overlap_t0: Optional[float] = None
        self._measure_t0: Optional[float] = None
        self._measure_t1: Optional[float] = None

    # -- executor surface (never used: measurement happens remotely) ----------

    def run_once(self, nest: LoopNest) -> None:
        raise RuntimeError("RemoteMeasuredBackend does not execute locally; "
                           "measurement is remote (or via the fallback "
                           "backend when degraded)")

    def pool_spec(self) -> Tuple[str, Dict[str, Any], Optional[str]]:
        raise TypeError("a remote backend cannot host a worker pool — run "
                        "the pool on the farm side (measure_farm --measure "
                        "pool)")

    # -- connection management -------------------------------------------------

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _ensure_conn(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout_s)
        try:
            send_frame(sock, {"op": "ping", "client": self.client_id})
            hello = recv_frame(sock)
            if hello is None or not hello.get("ok"):
                raise ProtocolError(f"bad handshake reply: {hello!r}")
        except BaseException:
            sock.close()
            raise
        self.n_connects += 1
        if self.n_connects > 1:
            self.n_reconnects += 1
        self.remote_hardware = hello.get("hardware")
        self.remote_backend = hello.get("backend")
        if hello.get("peak"):
            self._remote_peak = float(hello["peak"])
        self._sock = sock
        return sock

    def _request(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """One request with reconnect + capped exponential backoff/jitter.

        Transport faults consume ``max_retries``; explicit backpressure
        replies wait the server's ``retry_after_s`` (jittered) without
        consuming them, bounded by ``backpressure_budget_s`` per request.
        Raises :class:`FarmUnavailableError` past either budget and
        :class:`RemoteMeasureError` on an explicit server error reply."""
        self._req_id += 1
        payload = dict(payload, id=self._req_id, client=self.client_id,
                       deadline_s=self.deadline_s)
        faults = 0
        waited_s = 0.0
        last_err: Optional[BaseException] = None
        while True:
            if faults > self.max_retries:
                raise FarmUnavailableError(
                    f"measurement farm at {self.host}:{self.port} "
                    f"unavailable after {faults} attempts: {last_err}")
            if faults and last_err is not None:
                self.n_retries += 1
                delay = min(self.backoff_max_s,
                            self.backoff_base_s * (2 ** (faults - 1)))
                # full jitter: desynchronize a fleet of clients hammering a
                # farm that just came back
                time.sleep(delay * (0.5 + random.random()))
                last_err = None
            try:
                sock = self._ensure_conn()
                sock.settimeout(self.deadline_s)
                self.n_requests += 1
                t0 = time.perf_counter()
                send_frame(sock, payload)
                reply = recv_frame(sock)
                rtt = time.perf_counter() - t0
                self.farm_rtt_s += rtt
                self.last_rtt_s = rtt
                if reply is None:
                    raise ProtocolError("farm closed the connection")
                if reply.get("id") != self._req_id:
                    raise ProtocolError(
                        f"reply id {reply.get('id')} != {self._req_id}")
                if not reply.get("ok"):
                    kind = reply.get("error_kind")
                    if kind in BACKPRESSURE_KINDS:
                        wait = float(reply.get("retry_after_s") or 0.25)
                        wait *= 0.5 + random.random()  # jittered
                        if waited_s + wait > self.backpressure_budget_s:
                            raise FarmUnavailableError(
                                f"measurement farm at {self.host}:"
                                f"{self.port} still {kind} after waiting "
                                f"{waited_s:.1f}s (budget "
                                f"{self.backpressure_budget_s}s)")
                        self.n_backpressure_waits += 1
                        self.backpressure_wait_s += wait
                        waited_s += wait
                        time.sleep(wait)
                        continue  # not a fault: transport retries intact
                    raise RemoteMeasureError(
                        f"measurement farm at {self.host}:{self.port} "
                        f"failed the request:\n{reply.get('error')}")
                return reply
            except RemoteMeasureError:
                self._drop_conn()
                raise
            except FarmUnavailableError:
                self._drop_conn()
                raise
            except (OSError, ProtocolError) as e:
                last_err = e
                self._drop_conn()
                faults += 1

    # -- degradation / re-promotion ---------------------------------------------

    def _degrade(self, reason: str) -> None:
        if not self.degraded:
            self.degraded = True
            self.degraded_reason = reason
            self.n_degradations += 1
            self._batches_since_probe = 0
            self._last_probe_t = time.monotonic()
            if not self._warned_fallback:
                self._warned_fallback = True
                warnings.warn(
                    f"measurement farm at {self.host}:{self.port} "
                    f"unavailable ({reason}); falling back to local "
                    f"in-process measurement on backend "
                    f"{self.fallback_spec!r} (periodic re-probes will "
                    f"re-promote when the farm returns)", stacklevel=3)
        self._drop_conn()

    def _maybe_reprobe(self) -> bool:
        """While degraded, periodically attempt a fresh handshake and
        re-promote to remote measurement on success.  Returns True when no
        longer degraded.  Probe cadence is bounded (every
        ``reprobe_every_batches`` batches or ``reprobe_after_s`` seconds)
        so a dead farm costs one connect timeout per window, not per
        batch."""
        if not self.degraded:
            return True
        self._batches_since_probe += 1
        now = time.monotonic()
        due = (self._batches_since_probe >= self.reprobe_every_batches
               or now - self._last_probe_t >= self.reprobe_after_s)
        if not due:
            return False
        self._batches_since_probe = 0
        self._last_probe_t = now
        self.n_probes += 1
        try:
            self._ensure_conn()
        except (OSError, ProtocolError):
            self._drop_conn()
            return False
        self.degraded = False
        self.degraded_reason = None
        self.n_repromotions += 1
        return True

    def _ensure_local(self) -> Backend:
        if self._local is None:
            kw = dict(self.fallback_kwargs)
            kw.setdefault("policy", self.policy)
            self._local = make_backend(self.fallback_spec, **kw)
        return self._local

    def _measure_locally(self,
                         nests: Sequence[LoopNest]) -> List[Measurement]:
        local = self._ensure_local()
        if isinstance(local, MeasuredBackend):
            return local.measure_batch(list(nests))
        return [measure_local(local, n) for n in nests]

    # -- overlap instrumentation --------------------------------------------------

    def _mark_op(self) -> None:
        now = time.monotonic()
        if self._measure_t0 is None:
            self._measure_t0 = now
        self._measure_t1 = now

    def _outstanding_changed(self) -> None:
        now = time.monotonic()
        if self._outstanding and self._overlap_t0 is None:
            self._overlap_t0 = now
        elif not self._outstanding and self._overlap_t0 is not None:
            self._overlap_s += now - self._overlap_t0
            self._overlap_t0 = None

    def overlap_ratio(self) -> Optional[float]:
        """Share of the measure wall-clock (first op to last) spent with
        at least one ticket in flight — 0.0 for a purely blocking client,
        near 1.0 when the farm was kept busy behind tuner work."""
        if self._measure_t0 is None or self._measure_t1 is None:
            return None
        now = time.monotonic()
        overlap = self._overlap_s
        end = self._measure_t1
        if self._overlap_t0 is not None:
            overlap += now - self._overlap_t0
            end = now
        span = end - self._measure_t0
        if span <= 0.0:
            return None
        return min(1.0, overlap / span)

    # -- pipelined (ticketed) measurement -----------------------------------------

    def async_capacity(self) -> int:
        """Tickets that can be submitted right now without blocking on the
        in-flight window — advisory, for measure-ahead callers that must
        not stall."""
        if self.degraded:
            return 0
        return max(0, self.inflight_window - len(self._outstanding))

    def _submit_chunk(self, chunk: List[LoopNest]) -> str:
        self._ticket_seq += 1
        tid = f"{self.client_id}.{self._ticket_seq}"
        retries0 = self.n_retries
        self._request({"op": "submit", "ticket": tid,
                       "nests": [nest_to_wire(n) for n in chunk]})
        # every transport retry inside _request re-sent this ticket after a
        # reconnect; the farm deduped it — that is the exactly-once resubmit
        self.n_tickets_resubmitted += self.n_retries - retries0
        self._outstanding[tid] = list(chunk)
        self.n_tickets_submitted += 1
        self.inflight_peak = max(self.inflight_peak, len(self._outstanding))
        self._outstanding_changed()
        return tid

    def _collect_once(self, timeout_s: float) -> int:
        """One ``collect`` round-trip: deliver owed acks, gather finished
        tickets into ``_ready``/``_failed``, resubmit tickets the farm
        lost.  Returns the number of tickets newly collected."""
        if not self._outstanding:
            return 0
        payload: Dict[str, Any] = {
            "op": "collect", "tickets": list(self._outstanding),
            "timeout_s": round(max(0.0, float(timeout_s)), 3)}
        if self._ack_pending:
            payload["ack"] = list(self._ack_pending)
        reply = self._request(payload)
        self._ack_pending = []  # delivered (acks are idempotent on retry)
        got = 0
        for tid, body in (reply.get("done") or {}).items():
            chunk = self._outstanding.pop(tid, None)
            if chunk is None:
                continue  # re-delivery of an already-consumed ticket
            self._ack_pending.append(tid)
            self.n_tickets_collected += 1
            got += 1
            if body.get("ok"):
                shipped = body.get("measurements")
                if (not isinstance(shipped, list)
                        or len(shipped) != len(chunk)):
                    raise ProtocolError(
                        f"ticket {tid}: {len(chunk)} nests submitted, "
                        f"{len(shipped) if isinstance(shipped, list) else '?'}"
                        " measurements returned")
                if body.get("hardware"):
                    self.remote_hardware = body["hardware"]
                self._ready[tid] = [Measurement.unship(s) for s in shipped]
            else:
                self._failed[tid] = str(body.get("error"))
        for tid in reply.get("unknown") or []:
            chunk = self._outstanding.get(tid)
            if chunk is None:
                continue
            # the farm lost the ticket (restart / TTL): resubmit it — same
            # id, so a racing duplicate still measures once
            if self._resubmits.get(tid, 0) >= 2:
                raise FarmUnavailableError(
                    f"measurement farm at {self.host}:{self.port} lost "
                    f"ticket {tid} repeatedly")
            self._resubmits[tid] = self._resubmits.get(tid, 0) + 1
            self.n_tickets_resubmitted += 1
            self._request({"op": "submit", "ticket": tid,
                           "nests": [nest_to_wire(n) for n in chunk]})
        self._outstanding_changed()
        self._mark_op()
        return got

    def submit_batch(self, nests: Sequence[LoopNest]) -> FarmTicket:
        """Ship ``nests`` for measurement and return immediately with a
        :class:`FarmTicket`; resolve it later with :meth:`wait` (or
        :meth:`collect_batch` for the gflops array).  Blocks only when the
        in-flight window is full.  While degraded the tail measures
        synchronously on the fallback, so the handle always resolves."""
        nests = list(nests)
        handle = FarmTicket(nests)
        if not nests:
            return handle
        self._mark_op()
        if self.degraded:
            self._maybe_reprobe()
        i = 0
        while i < len(nests) and not self.degraded:
            chunk = nests[i:i + self.max_nests_per_request]
            try:
                while len(self._outstanding) >= self.inflight_window:
                    self._collect_once(self.collect_poll_s)
                tid = self._submit_chunk(chunk)
            except (FarmUnavailableError, ProtocolError) as e:
                self._degrade(str(e))
                break
            handle.tickets.append((tid, i, i + len(chunk)))
            i += len(chunk)
        if i < len(nests):
            self.n_degraded_batches += 1
            handle.local_at = i
            handle.local = self._measure_locally(nests[i:])
        self._mark_op()
        return handle

    def collect(self, timeout_s: float = 0.0) -> int:
        """Opportunistically drain finished tickets (one round-trip,
        blocking on the farm for at most ``timeout_s``).  Returns how many
        tickets were newly collected; 0 while degraded."""
        if not self._outstanding or self.degraded:
            return 0
        try:
            return self._collect_once(timeout_s)
        except (FarmUnavailableError, ProtocolError) as e:
            self._degrade(str(e))
            return 0

    def wait(self, handle: FarmTicket) -> List[Measurement]:
        """Block until every ticket of ``handle`` resolves and return its
        measurements in nest order (recorded, like :meth:`measure_batch`).
        Tickets the farm cannot serve (degradation mid-flight) measure on
        the local fallback; a server-side evaluator error re-raises."""
        out: List[Optional[Measurement]] = [None] * len(handle.nests)
        if handle.local is not None:
            for j, m in enumerate(handle.local):
                out[handle.local_at + j] = m
        own = {tid for tid, _, _ in handle.tickets}
        while not self.degraded and any(t in self._outstanding for t in own):
            try:
                self._collect_once(self.collect_poll_s)
            except (FarmUnavailableError, ProtocolError) as e:
                self._degrade(str(e))
        error: Optional[str] = None
        for tid, lo, hi in handle.tickets:
            ms = self._ready.pop(tid, None)
            if ms is None:
                err = self._failed.pop(tid, None)
                if err is not None:
                    error = error or f"ticket {tid}:\n{err}"
                    continue
                # unresolved (degraded with the ticket still in flight):
                # the fallback serves it — the farm's eventual result is
                # never collected, so nothing is recorded twice
                self._outstanding.pop(tid, None)
                self._outstanding_changed()
                self.n_degraded_batches += 1
                ms = self._measure_locally(handle.nests[lo:hi])
            for j, m in enumerate(ms):
                out[lo + j] = m
        self._mark_op()
        if error is not None:
            raise RemoteMeasureError(
                f"measurement farm at {self.host}:{self.port} failed "
                f"{error}")
        return [self._record(n, m) for n, m in zip(handle.nests, out)]

    def collect_batch(self, handle: FarmTicket,
                      timeout_s: Optional[float] = None) -> np.ndarray:
        return np.asarray([m.gflops for m in self.wait(handle)],
                          dtype=np.float64)

    def flush_acks(self) -> None:
        """Release parked results on the farm without collecting anything
        — lets a draining farm finish shutdown promptly."""
        if not self._ack_pending or self.degraded:
            return
        try:
            self._request({"op": "collect", "tickets": [], "timeout_s": 0.0,
                           "ack": list(self._ack_pending)})
            self._ack_pending = []
        except (FarmUnavailableError, ProtocolError, RemoteMeasureError):
            pass  # best-effort: the farm's ticket TTL is the backstop

    # -- measurement -------------------------------------------------------------

    def measure(self, nest: LoopNest, worker: int = -1) -> Measurement:
        return self.measure_batch([nest])[0]

    def measure_batch(self, nests: Sequence[LoopNest]) -> List[Measurement]:
        if not nests:
            return []
        nests = list(nests)
        if len(nests) > self.max_nests_per_request and not self.degraded:
            # multi-chunk batches pipeline through the ticketed path: all
            # chunks go in flight (window-bounded) instead of one blocking
            # round-trip per chunk in series
            return self.wait(self.submit_batch(nests))
        out: List[Measurement] = []
        idx = 0
        self._mark_op()
        if self.degraded:
            self._maybe_reprobe()
        while idx < len(nests) and not self.degraded:
            # bounded inflight: one request at a time, chunked so a giant
            # batch neither monopolizes the farm's queue nor balloons frames
            chunk = nests[idx:idx + self.max_nests_per_request]
            try:
                reply = self._request(
                    {"op": "measure",
                     "nests": [nest_to_wire(n) for n in chunk]})
                shipped = reply.get("measurements")
                if not isinstance(shipped, list) or len(shipped) != len(chunk):
                    raise ProtocolError(
                        f"{len(chunk)} nests sent, "
                        f"{len(shipped) if isinstance(shipped, list) else '?'}"
                        " measurements returned")
                if reply.get("hardware"):
                    self.remote_hardware = reply["hardware"]
                out.extend(Measurement.unship(s) for s in shipped)
                idx += len(chunk)
            except (FarmUnavailableError, ProtocolError) as e:
                self._degrade(str(e))
        if idx < len(nests):
            # whatever the farm did not serve measures locally, so the
            # batch always completes in full
            self.n_degraded_batches += 1
            out.extend(self._measure_locally(nests[idx:]))
        self._mark_op()
        return [self._record(n, m) for n, m in zip(nests, out)]

    # -- Backend protocol ---------------------------------------------------------

    def peak(self) -> float:
        """The farm host's peak GFLOPS (handshake) — rewards must be
        normalized by the machine doing the timing.  Unreachable farm:
        degrade and use the fallback's peak."""
        if self._remote_peak is None and not self.degraded:
            try:
                self._request({"op": "ping"})
            except FarmUnavailableError as e:
                self._degrade(str(e))
        if self._remote_peak is not None and not self.degraded:
            return self._remote_peak
        return float(self._ensure_local().peak())

    # -- observability -------------------------------------------------------------

    def measured_hardware(self) -> Optional[str]:
        """The measuring host's descriptor for registry stamping: the farm's
        (from the measure reply) while remote, None once degraded — records
        then carry the local host via ``current_hardware()``."""
        return None if self.degraded else self.remote_hardware

    def measured_backend_name(self) -> Optional[str]:
        """The backend that actually timed, for registry record keys: the
        farm's executor while remote (a record keyed ``"remote"`` would say
        nothing about where the schedule is good), the fallback spec once
        degraded, None before the first handshake."""
        if self.degraded:
            return self.fallback_spec
        return self.remote_backend

    def farm_stats(self) -> Dict[str, Any]:
        return {
            "addr": f"{self.host}:{self.port}",
            "client_id": self.client_id,
            "requests": self.n_requests,
            "retries": self.n_retries,
            "connects": self.n_connects,
            "reconnects": self.n_reconnects,
            "degraded": int(self.degraded),
            "degradations": self.n_degradations,
            "degraded_batches": self.n_degraded_batches,
            "degraded_reason": self.degraded_reason,
            "repromotions": self.n_repromotions,
            "probes": self.n_probes,
            "backpressure_waits": self.n_backpressure_waits,
            "backpressure_wait_s": round(self.backpressure_wait_s, 4),
            "farm_rtt_s": round(self.farm_rtt_s, 4),
            "last_rtt_s": round(self.last_rtt_s, 4),
            "inflight_tickets": len(self._outstanding),
            "inflight_tickets_peak": self.inflight_peak,
            "inflight_window": self.inflight_window,
            "tickets_submitted": self.n_tickets_submitted,
            "tickets_collected": self.n_tickets_collected,
            "tickets_resubmitted": self.n_tickets_resubmitted,
            "overlap_s": round(self._overlap_s, 4),
            "overlap_ratio": (round(r, 4)
                              if (r := self.overlap_ratio()) is not None
                              else None),
            "remote_hardware": self.remote_hardware,
            "remote_backend": self.remote_backend,
        }

    def measure_stats(self) -> Dict[str, Any]:
        out = super().measure_stats()
        out["mode"] = "remote"
        out["farm"] = self.farm_stats()
        return out

    def measure_settings(self) -> Dict[str, Any]:
        return {
            "mode": "remote",
            "addr": f"{self.host}:{self.port}",
            "fallback": self.fallback_spec,
            "deadline_s": self.deadline_s,
            "max_retries": self.max_retries,
            "backpressure_budget_s": self.backpressure_budget_s,
            "max_nests_per_request": self.max_nests_per_request,
            "reprobe_every_batches": self.reprobe_every_batches,
            "reprobe_after_s": self.reprobe_after_s,
            "inflight_window": self.inflight_window,
            "policy": self.policy.to_dict() if self.policy else None,
        }

    def close(self) -> None:
        self.flush_acks()
        self._drop_conn()
        if self._local is not None:
            close = getattr(self._local, "close", None)
            if close is not None:
                close()
            self._local = None
