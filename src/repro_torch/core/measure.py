"""Measurement subsystem: timing policy, variance guardrails, worker pool.

LoopTune's premise is that RL can learn from *measured* rewards in seconds —
which is only sound if the timings are trustworthy.  This module splits
"what to execute" from "how to time it": backends are pure executors
(:meth:`MeasuredBackend.run_once`, which on the card ends in
``torch.cuda.synchronize()``) and every wall-clock measurement flows
through one place:

* **Variance guardrails** — :class:`MeasurementPolicy` times best-of-
  ``repeats`` runs, computes the relative spread of the best-``repeats``
  window, and *auto-escalates* the repeat count when the spread exceeds a
  threshold.  A measurement whose spread is still above threshold at
  ``max_repeats`` is flagged ``noisy`` so the environment re-measures it
  instead of learning from it.  The clock is injectable, so the guardrail
  logic is unit-testable without real sleeps.

* **Out-of-process isolation** — :class:`WorkerPool` keeps warm worker
  processes (AutoTVM's RPC measurement pool, container-local): one per core,
  pinned, for the NumPy interpreter and the analytical model, and one per
  card for the card executor.  Schedules ship as ``(contraction,
  structure_key)`` and workers rebuild them with
  :meth:`LoopNest.from_structure_key`, so the parent's GC pauses and sibling
  threads never pollute a timed run — and, on the card, a kernel fault
  (an illegal address, a trap), which poisons the CUDA context of the
  process it happens in, takes down a worker instead of the tuner.  Dead
  workers are respawned and their in-flight schedules re-measured; a
  schedule that repeatedly kills workers resolves to a marked-failed record
  instead of wedging the batch.

  Two rules differ from the JAX package's pool, both for the card.  A
  child forked from a process that holds a CUDA context cannot use the
  card, so the card executor's pool *spawns* (the CPU executors keep fork).
  A spawned card worker pays the torch import, the CUDA context and the
  kernel libraries' load (``nvcc`` on a cold build directory) before it can
  measure anything, so each worker builds its executor at start-up and
  reports ``ready``; the hung-kill clock (``task_timeout_s``) starts only
  then, and start-up is bounded by its own ``startup_timeout_s``.

``Measurement`` records ride alongside the scalar GFLOPS that the
:class:`~repro_torch.core.schedule_cache.ScheduleCache` stores, via the
backend's bounded ``measurement_for`` record map — that is how the
environment surfaces reward quality in ``info`` without widening the cache.
"""
from __future__ import annotations

import abc
import dataclasses
import gc
import multiprocessing
import multiprocessing.connection
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..tracing import span
from .backend import Backend
from .loop_ir import LoopNest
from .schedule_cache import DEFAULT_CAPACITY, LRUCache

#: bounded per-backend map from structure_key to its latest Measurement.
#: Must not evict before the ScheduleCache holding the values does
#: (default capacity matched on purpose): a cached GFLOPS whose record was
#: evicted would read as clean, letting a noisy reward reach training
#: unmarked.  Records are a few hundred bytes each.
MEASUREMENT_RECORDS_CAPACITY = DEFAULT_CAPACITY


# ---------------------------------------------------------------------------
# Measurement record
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Measurement:
    """One schedule's timing outcome (what the reward is made of).

    ``spread`` is the relative spread of the best-``k`` timing window (see
    :meth:`MeasurementPolicy.window_spread`); ``noisy`` means the spread
    still exceeded the policy threshold after escalating to
    ``max_repeats`` — the reward is usable but should not be trusted
    unmarked.  ``worker`` is the pool worker id that produced the timings
    (-1 = in-process).  ``times`` keeps the raw per-repeat wall times so
    measurements of the same schedule from different processes can be
    merged into a best-of-N-across-processes record.
    """

    gflops: float
    best_s: float
    spread: float
    repeats: int
    escalations: int
    noisy: bool
    worker: int = -1
    times: Tuple[float, ...] = ()
    # set once an environment has already spent a re-measurement on this
    # record, so a persistently-noisy schedule is not re-measured forever
    remeasured: bool = False

    def to_info(self) -> Dict[str, Any]:
        """The compact dict envs attach to ``info["measurement"]``."""
        return {
            "gflops": self.gflops,
            "spread": self.spread,
            "repeats": self.repeats,
            "escalations": self.escalations,
            "noisy": self.noisy,
            "worker": self.worker,
            "remeasured": self.remeasured,
        }

    # -- pool transport (plain tuples pickle smaller & faster) --------------

    def ship(self) -> Tuple:
        return (self.gflops, self.best_s, self.spread, self.repeats,
                self.escalations, self.noisy, self.worker, tuple(self.times))

    @classmethod
    def unship(cls, t: Tuple) -> "Measurement":
        return cls(*t[:7], times=tuple(t[7]))

    @classmethod
    def merge(cls, parts: Sequence["Measurement"], flops: float,
              policy: "MeasurementPolicy") -> "Measurement":
        """Best-of-N across processes: combine measurements of the *same*
        schedule from different workers into one record (minimum best time,
        spread recomputed over the pooled timings)."""
        parts = list(parts)
        if len(parts) == 1:
            return parts[0]
        times = tuple(sorted(t for m in parts for t in m.times))
        if not times:  # degenerate (analytical) parts carry no raw times
            return max(parts, key=lambda m: m.gflops)
        best = times[0]
        spread = policy.window_spread(times)
        by_best = min((m for m in parts if m.times), key=lambda m: min(m.times))
        return cls(
            gflops=flops / max(best, 1e-12) / 1e9,
            best_s=best,
            spread=spread,
            repeats=len(times),
            escalations=sum(m.escalations for m in parts),
            noisy=spread > policy.spread_threshold,
            worker=by_best.worker,
            times=times,
        )


def degenerate_measurement(gflops: float, worker: int = -1) -> Measurement:
    """A zero-spread record for backends with no wall clock in the loop
    (the analytical cost model): deterministic, never noisy."""
    return Measurement(gflops=float(gflops), best_s=0.0, spread=0.0,
                       repeats=1, escalations=0, noisy=False, worker=worker)


def failed_measurement() -> Measurement:
    """The record for a schedule that could not be measured (it repeatedly
    killed its workers): zero GFLOPS, flagged noisy and already past its
    re-measurement, so nothing trusts or endlessly retries it."""
    return Measurement(gflops=0.0, best_s=float("inf"), spread=float("inf"),
                       repeats=0, escalations=0, noisy=True, worker=-1,
                       remeasured=True)


# ---------------------------------------------------------------------------
# Timing policy (variance guardrails)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeasurementPolicy:
    """How a single schedule is timed, and when not to trust the result.

    Best-of-``repeats`` with ``warmup`` untimed runs (LoopNest's "exclude
    warm-up, take the fastest").  After each window the relative spread of
    the ``repeats`` fastest timings is checked; above ``spread_threshold``
    the repeat count escalates by ``escalate_factor`` (up to
    ``max_repeats``) so a GC pause or scheduler blip buys more samples
    instead of a corrupted reward.  If the spread never settles the
    measurement is flagged ``noisy``.

    ``warm_elide`` lets *isolated* execution sites (pool workers — warm
    processes with nothing else running) skip the per-measurement warmup
    once the contraction's operands are hot; in-process measurement always
    warms up, because the surrounding process is not quiescent.
    ``gc_guard`` disables the cyclic GC around the timed loop (best-of
    already sheds most pauses; this stops them from inflating every
    repeat).  ``clock`` is injectable for tests and never ships to workers.
    """

    repeats: int = 3
    max_repeats: int = 12
    warmup: int = 1
    spread_threshold: float = 0.25
    escalate_factor: int = 2
    warm_elide: bool = True
    gc_guard: bool = True
    clock: Optional[Callable[[], float]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.repeats < 1:
            raise ValueError(f"repeats must be >= 1, got {self.repeats}")
        if self.max_repeats < self.repeats:
            raise ValueError(
                f"max_repeats {self.max_repeats} < repeats {self.repeats}")
        if self.escalate_factor < 2:
            raise ValueError(
                f"escalate_factor must be >= 2, got {self.escalate_factor}")
        if self.spread_threshold <= 0:
            raise ValueError("spread_threshold must be > 0")

    # -- (de)serialization (checkpoint meta / pool shipping) -----------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "repeats": self.repeats,
            "max_repeats": self.max_repeats,
            "warmup": self.warmup,
            "spread_threshold": self.spread_threshold,
            "escalate_factor": self.escalate_factor,
            "warm_elide": self.warm_elide,
            "gc_guard": self.gc_guard,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MeasurementPolicy":
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}
                      and k != "clock"})

    def shippable(self) -> "MeasurementPolicy":
        """A copy safe to pickle into a worker (custom clocks stay home)."""
        return dataclasses.replace(self, clock=None)

    # -- spread metric -------------------------------------------------------

    def window_spread(self, times: Sequence[float]) -> float:
        """Relative spread ``(max - min) / min`` of the ``repeats`` fastest
        timings.  Using the best window (not all samples) is what lets
        escalation converge: one GC-pause outlier stops mattering once
        enough clean samples exist, while persistent jitter keeps even the
        fastest window wide."""
        window = sorted(times)[: self.repeats]
        lo = max(window[0], 1e-12)
        return (window[-1] - window[0]) / lo

    # -- the timing loop -----------------------------------------------------

    def measure(
        self,
        run_once: Callable[[], Any],
        flops: float,
        warm: bool = False,
        worker: int = -1,
    ) -> Measurement:
        """Time ``run_once`` under the guardrails; returns a
        :class:`Measurement`.  ``warm=True`` marks an isolated, already-warm
        execution site (warmups elided when ``warm_elide``)."""
        clock = self.clock if self.clock is not None else time.perf_counter
        if not (warm and self.warm_elide):
            for _ in range(self.warmup):
                run_once()
        times: List[float] = []
        target = self.repeats
        escalations = 0
        gc_was_on = self.gc_guard and gc.isenabled()
        if gc_was_on:
            gc.disable()
        try:
            while True:
                while len(times) < target:
                    t0 = clock()
                    run_once()
                    times.append(clock() - t0)
                spread = self.window_spread(times)
                if spread <= self.spread_threshold or target >= self.max_repeats:
                    break
                escalations += 1
                target = min(self.max_repeats, target * self.escalate_factor)
        finally:
            if gc_was_on:
                gc.enable()
        best = min(times)
        return Measurement(
            gflops=flops / max(best, 1e-12) / 1e9,
            best_s=best,
            spread=spread,
            repeats=len(times),
            escalations=escalations,
            noisy=spread > self.spread_threshold,
            worker=worker,
            times=tuple(sorted(times)),
        )


# ---------------------------------------------------------------------------
# Local measurement helper (pool workers measure through this)
# ---------------------------------------------------------------------------


def measure_local(backend: Backend, nest: LoopNest, worker: int = -1) -> Measurement:
    """Measure ``nest`` on ``backend`` in this process.  Measured backends
    go through their policy's timing loop; analytical backends return a
    degenerate zero-spread record (their ``evaluate`` has no clock)."""
    if isinstance(backend, MeasuredBackend):
        return backend.measure(nest, worker=worker)
    return degenerate_measurement(float(backend.evaluate(nest)), worker)


def measurement_of(backend: Backend, nest: LoopNest) -> Optional[Measurement]:
    """The backend's latest measurement record for this structure, if the
    backend keeps records (analytical backends don't)."""
    getter = getattr(backend, "measurement_for", None)
    return getter(nest) if getter is not None else None


def measure_settings(backend: Backend) -> Optional[Dict[str, Any]]:
    """The measurement configuration a backend runs with, for checkpoint
    metadata (None for backends with no measurement settings at all)."""
    getter = getattr(backend, "measure_settings", None)
    return getter() if getter is not None else None


def measure_stats(backend: Backend) -> Dict[str, Any]:
    """The backend's measurement counters, ``{}`` for backends that keep
    none.  On a remote farm client the ``["farm"]`` sub-dict carries the
    pipelining observability: tickets submitted/collected/resubmitted,
    in-flight depth (current/peak) and the overlap ratio (fraction of
    measurement wall-clock with at least one ticket outstanding)."""
    getter = getattr(backend, "measure_stats", None)
    return getter() if getter is not None else {}


# ---------------------------------------------------------------------------
# Measured-backend base: pure executor + delegated timing
# ---------------------------------------------------------------------------


class PoolHostBackend(Backend):
    """Shared pool-hosting plumbing for backends that can route evaluation
    through a :class:`WorkerPool`: measurement-mode state, lazy pool
    construction, settings reporting and shutdown.  Subclasses provide
    :meth:`pool_spec`."""

    def _init_pool_host(self, measure: str,
                        pool_workers: Optional[int],
                        policy: Optional[MeasurementPolicy],
                        pool_timeout_s: Optional[float] = None) -> None:
        if measure not in ("inproc", "pool"):
            raise ValueError(f"measure must be 'inproc' or 'pool', got {measure!r}")
        self.measure_mode = measure
        self.pool_workers = pool_workers
        self.policy = policy
        #: per-task hung-kill budget forwarded to the pool (None = pool
        #: default) — the measurement farm sets this so a wedged schedule
        #: bounds a client's batch instead of stalling it
        self.pool_timeout_s = pool_timeout_s
        self._pool: Optional[WorkerPool] = None

    @abc.abstractmethod
    def pool_spec(self) -> Tuple[str, Dict[str, Any], Optional[str]]:
        """``(registry_name, kwargs, start_method)`` a worker process uses
        to build an equivalent in-process executor (``start_method`` None =
        pool default).  A kwarg whose value is a :class:`PerWorker` gives
        each worker its own value (the card executor's device)."""

    def default_pool_workers(self) -> Optional[int]:
        """The pool size when ``pool_workers`` is not given (None = one
        worker a core, the pool's default)."""
        return None

    def _ensure_pool(self) -> "WorkerPool":
        if self._pool is None:
            spec, kwargs, method = self.pool_spec()
            extra = ({"task_timeout_s": self.pool_timeout_s}
                     if self.pool_timeout_s is not None else {})
            self._pool = WorkerPool(spec, kwargs, policy=self.policy,
                                    n_workers=(self.pool_workers
                                               or self.default_pool_workers()),
                                    start_method=method, **extra)
        return self._pool

    def measure_settings(self) -> Dict[str, Any]:
        return {
            "mode": self.measure_mode,
            "workers": (self._pool.n_workers if self._pool is not None
                        else self.pool_workers),
            "policy": (self.policy.to_dict()
                       if self.policy is not None else None),
        }

    def close(self) -> None:
        """Shut the worker pool down (no-op in-process).  Safe to call
        repeatedly; the pool is rebuilt lazily if measured again."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None


class MeasuredBackend(PoolHostBackend):
    """Base for backends whose GFLOPS come from wall-clock measurement.

    Subclasses are *pure executors*: they implement :meth:`run_once` (one
    synchronized execution of a schedule) and :meth:`pool_spec` (how a
    worker process rebuilds an equivalent executor); all timing, variance
    tracking and pool dispatch lives here.

    ``measure="inproc"`` times in this process through the policy;
    ``measure="pool"`` ships batches to a :class:`WorkerPool` (built
    lazily) so ``evaluate_batch`` measures out of process, in parallel
    across the workers.  ``repeats`` is a convenience alias for ``MeasurementPolicy(repeats=...)`` — setting it
    together with a conflicting explicit ``policy`` is an error.
    """

    def __init__(
        self,
        policy: Optional[MeasurementPolicy] = None,
        repeats: Optional[int] = None,
        measure: str = "inproc",
        pool_workers: Optional[int] = None,
        isolated: bool = False,
        pool_timeout_s: Optional[float] = None,
    ):
        if policy is None:
            policy = (MeasurementPolicy(
                repeats=repeats,
                max_repeats=max(repeats, MeasurementPolicy.max_repeats))
                if repeats is not None else MeasurementPolicy())
        elif repeats is not None and repeats != policy.repeats:
            raise ValueError(
                f"conflicting repeats: {repeats} vs policy.repeats "
                f"{policy.repeats} — set one or the other")
        self._init_pool_host(measure, pool_workers, policy, pool_timeout_s)
        #: True inside a pool worker: a warm, quiescent process where the
        #: policy may elide per-measurement warmups once operands are hot
        self.isolated = isolated
        self._warm_contractions: set = set()
        self._records: LRUCache = LRUCache(MEASUREMENT_RECORDS_CAPACITY)
        self.n_measurements = 0
        self.n_escalations = 0
        self.n_noisy = 0

    @property
    def repeats(self) -> int:
        """Base best-of window (the historical constructor arg)."""
        return self.policy.repeats

    # -- executor surface (subclass responsibility) --------------------------

    @abc.abstractmethod
    def run_once(self, nest: LoopNest) -> None:
        """Execute the schedule once, synchronously (operands cached by the
        subclass; compilation may happen on the first call)."""

    def is_warm(self, nest: LoopNest) -> bool:
        """Whether this execution site can skip the pre-measurement warmup
        for ``nest`` (isolated worker + contraction operands already hot).
        Subclasses with per-structure warm state (JIT compiles) tighten
        this."""
        return self.isolated and nest.contraction.name in self._warm_contractions

    def cost_hint(self, nest: LoopNest) -> float:
        """Relative expected measurement cost, for the pool's longest-first
        scheduling.  Only the ordering matters; subclasses that know their
        cost driver (the interpreter's Python slab count) override this."""
        return float(nest.contraction.flops())

    # -- measurement ----------------------------------------------------------

    def worker_ready(self) -> Dict[str, Any]:
        """Pay a pool worker's start-up cost before it reports ready (the
        hung-kill clock starts after this returns); returns what the worker
        tells the parent about itself.  Executors with expensive start-up
        (the card's context and kernel libraries) override this."""
        return {}

    # -- measurement ----------------------------------------------------------

    def measure(self, nest: LoopNest, worker: int = -1) -> Measurement:
        """Measure one schedule; in pool mode this fans the schedule out to
        the idle workers and merges best-of across processes."""
        if self.measure_mode == "pool" and not self.isolated:
            return self.measure_batch([nest])[0]
        with span("measure.reward") as sp:
            warm = self.policy.warm_elide and self.is_warm(nest)
            m = self.policy.measure(
                lambda: self.run_once(nest), nest.contraction.flops(),
                warm=warm, worker=worker)
            sp.set(launches=m.repeats + (0 if warm else self.policy.warmup),
                   escalations=m.escalations)
        self._warm_contractions.add(nest.contraction.name)
        return self._record(nest, m)

    def measure_batch(self, nests: Sequence[LoopNest]) -> List[Measurement]:
        if not nests:
            return []
        if self.measure_mode == "pool" and not self.isolated:
            ms = self._ensure_pool().measure_batch(
                nests, cost_hint=self.cost_hint,
                compiled_hint=getattr(self, "is_compiled", None))
            return [self._record(n, m) for n, m in zip(nests, ms)]
        return [self.measure(n) for n in nests]

    def _record(self, nest: LoopNest, m: Measurement) -> Measurement:
        self.n_measurements += 1
        self.n_escalations += m.escalations
        self.n_noisy += int(m.noisy)
        self._records.put(nest.structure_key(), m)
        return m

    # -- Backend protocol -----------------------------------------------------

    def evaluate(self, nest: LoopNest) -> float:
        return self.measure(nest).gflops

    def evaluate_batch(self, nests: Sequence[LoopNest]) -> np.ndarray:
        return np.array([m.gflops for m in self.measure_batch(nests)],
                        dtype=np.float64)

    # -- observability --------------------------------------------------------

    def measurement_for(self, nest: LoopNest) -> Optional[Measurement]:
        """Latest measurement record for this structure (None if never
        measured here, or evicted from the bounded record map)."""
        return self._records.get(nest.structure_key())

    def measure_stats(self) -> Dict[str, Any]:
        out = {
            "measurements": self.n_measurements,
            "escalations": self.n_escalations,
            "noisy": self.n_noisy,
            "records": len(self._records),
            "mode": self.measure_mode,
        }
        if self._pool is not None:
            out["pool"] = self._pool.stats()
        return out


# ---------------------------------------------------------------------------
# Worker pool
# ---------------------------------------------------------------------------


def _default_workers() -> int:
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):
        return max(1, os.cpu_count() or 1)


class PerWorker:
    """A :meth:`PoolHostBackend.pool_spec` kwarg whose value differs by
    worker: worker ``wid`` gets ``values[wid % len(values)]`` (the card
    executor gives each worker its own card)."""

    __slots__ = ("values",)

    def __init__(self, values: Sequence[Any]):
        if not values:
            raise ValueError("PerWorker needs at least one value")
        self.values = tuple(values)

    def pick(self, wid: int) -> Any:
        return self.values[wid % len(self.values)]

    def __repr__(self) -> str:
        return f"PerWorker({list(self.values)!r})"


def _pool_worker(wid: int, spec: str, kwargs: Dict[str, Any],
                 task_q, result_conn, ready_at) -> None:
    """Worker main loop: pin to a core, build the executor and pay its
    start-up (:meth:`MeasuredBackend.worker_ready`), report ``ready``, then
    measure shipped ``(contraction, structure_key)`` schedules until the
    None sentinel arrives.  Every task answers with ``("ok", shipped)`` or
    ``("err", traceback)`` — the parent decides what is fatal; an executor
    that failed to build answers every task with its traceback.

    Results go to the parent through this worker's own pipe, sent
    synchronously: a shared ``multiprocessing.Queue`` writes from a feeder
    thread under a lock that every worker shares, and a worker that dies
    while that thread holds it (a schedule that ends its process right
    after the ready message) leaves the lock taken, so that no later
    worker's result ever arrives."""
    t0 = time.perf_counter()
    try:
        os.sched_setaffinity(0, {wid % (os.cpu_count() or 1)})
    except (AttributeError, OSError, ValueError):
        pass  # pinning is best-effort (non-Linux / restricted cgroups)
    backend: Optional[Backend] = None
    info: Dict[str, Any] = {}
    startup_error: Optional[str] = None
    try:
        from .backend import make_backend

        backend = make_backend(spec, **kwargs)
        if isinstance(backend, MeasuredBackend):
            backend.isolated = True
            info = dict(backend.worker_ready())
        # long-lived survivors (the executor, operand caches) stop being
        # traversed by the cyclic GC: measurement processes should spend
        # their cycles executing schedules
        gc.freeze()
    except BaseException:  # noqa: BLE001 — reported with the first task
        startup_error = traceback.format_exc()
    info["executor_s"] = round(time.perf_counter() - t0, 4)
    # shared memory, written at once: the parent sees it even if this
    # process dies before the parent has read its ready message.  The wall
    # clock, so the parent can count the interpreter's start and the
    # imports, which happen before this function runs
    ready_at.value = time.time()
    result_conn.send((wid, None, ("ready", os.getpid(), info)))
    while True:
        task = task_q.get()
        if task is None:
            return
        tid, contraction, key = task
        try:
            if startup_error is not None:
                raise RuntimeError(
                    f"the worker's executor failed to build:\n{startup_error}")
            nest = LoopNest.from_structure_key(contraction, key)
            m = measure_local(backend, nest, worker=wid)
            result_conn.send((wid, tid, ("ok", m.ship())))
        except BaseException:  # noqa: BLE001 — report, let the parent decide
            try:
                result_conn.send((wid, tid, ("err", traceback.format_exc())))
            except Exception:  # noqa: BLE001 — the parent's end already closed
                return


class _Worker:
    __slots__ = ("process", "task_q", "result_conn", "ready_at", "outstanding",
                 "busy_since", "ready", "spawned_at", "spawned_wall", "startup_s", "info")

    def __init__(self, process, task_q, result_conn, ready_at):
        self.process = process
        self.task_q = task_q
        self.result_conn = result_conn  # the parent's end of this worker's result pipe
        self.ready_at = ready_at  # shared: the worker's wall clock at ready
        self.outstanding: Dict[Tuple, Tuple] = {}  # tid -> task payload
        self.busy_since: Optional[float] = None  # monotonic, None = idle
        self.ready = False  # start-up done, as the parent has seen
        self.spawned_at = time.monotonic()
        self.spawned_wall = time.time()
        self.startup_s: Optional[float] = None
        self.info: Dict[str, Any] = {}


class WorkerPool:
    """Warm worker processes measuring schedules in parallel.

    One process per core by default (the card executor asks for one per
    card, :meth:`PoolHostBackend.default_pool_workers`), each pinned to a
    core and kept warm across batches (operand caches, lowered schedules
    and loaded kernel libraries persist inside the worker).  Tasks are
    ``(contraction, structure_key)`` pairs; workers rebuild the schedule
    with :meth:`LoopNest.from_structure_key` and measure it with their own
    in-process executor built from ``make_backend(spec, **kwargs)``
    (:class:`PerWorker` kwargs resolved for the worker).

    Each worker builds its executor at start-up and reports ``ready``.  The
    hung-kill clock only runs for ready workers, so a card worker's torch
    import, CUDA context and kernel build never count against
    ``task_timeout_s``; start-up itself is bounded by
    ``startup_timeout_s``.  Workers that die or are killed before they are
    ready more than ``max_task_retries`` times in a row raise in the parent:
    an executor that cannot start is no schedule's fault.

    Fault tolerance: a worker that dies mid-batch is respawned and its
    in-flight schedules are re-measured, and a ready worker that makes no
    progress for ``task_timeout_s`` (hung, not dead) is killed and treated
    the same way; a schedule that kills workers ``max_task_retries`` times
    resolves to a marked-failed record (zero GFLOPS, flagged noisy) instead
    of either wedging the batch or — worse — running the killer schedule in
    the parent.  Worker *exceptions* (as opposed to deaths) re-raise in the
    parent — an evaluator bug is not a fault to retry around.
    """

    def __init__(
        self,
        spec: str,
        kwargs: Optional[Dict[str, Any]] = None,
        policy: Optional[MeasurementPolicy] = None,
        n_workers: Optional[int] = None,
        start_method: Optional[str] = None,
        max_task_retries: int = 2,
        task_timeout_s: Optional[float] = 120.0,
        startup_timeout_s: Optional[float] = 900.0,
    ):
        if not isinstance(spec, str):
            raise TypeError(
                f"WorkerPool spec must be a backend registry name, got "
                f"{type(spec).__name__} (instances cannot ship to workers)")
        self.spec = spec
        self.kwargs = dict(kwargs or {})
        self.policy = (policy if policy is not None
                       else MeasurementPolicy()).shippable()
        self.n_workers = n_workers if n_workers else _default_workers()
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.max_task_retries = max_task_retries
        self.task_timeout_s = task_timeout_s
        self.startup_timeout_s = startup_timeout_s
        methods = multiprocessing.get_all_start_methods()
        if start_method is None:
            start_method = "fork" if "fork" in methods else "spawn"
        self._ctx = multiprocessing.get_context(start_method)
        self.start_method = start_method
        self._workers: List[Optional[_Worker]] = [None] * self.n_workers
        self._batch_serial = 0
        self._closed = False
        self.respawns = 0
        self.tasks_done = 0
        self.failed_tasks = 0
        self.hung_killed = 0
        self.startup_killed = 0
        self._startup_deaths = 0  # in a row, since a worker was last ready
        self.last_batch_s = 0.0
        for wid in range(self.n_workers):
            self._spawn(wid)

    # -- lifecycle ------------------------------------------------------------

    def _worker_kwargs(self, wid: int) -> Dict[str, Any]:
        kw = {k: (v.pick(wid) if isinstance(v, PerWorker) else v)
              for k, v in self.kwargs.items()}
        kw.pop("measure", None)  # workers always measure in-process
        kw.pop("pool_workers", None)
        kw.pop("pool_timeout_s", None)  # hung-kill is the parent's job
        kw["policy"] = self.policy
        return kw

    def _spawn(self, wid: int) -> _Worker:
        old = self._workers[wid]
        if old is not None:
            old.result_conn.close()  # a dead incarnation's pipe, with anything half-sent
        task_q = self._ctx.Queue()
        result_conn, send_end = self._ctx.Pipe(duplex=False)
        ready_at = self._ctx.Value("d", 0.0, lock=False)
        p = self._ctx.Process(
            target=_pool_worker,
            args=(wid, self.spec, self._worker_kwargs(wid), task_q, send_end, ready_at),
            daemon=True,
            name=f"looptune-measure-{self.spec}-{wid}",
        )
        p.start()
        send_end.close()  # the worker's copy is the only writer: its death is EOF here
        w = _Worker(p, task_q, result_conn, ready_at)
        self._workers[wid] = w
        return w

    def _next_result(self, timeout_s: float) -> Optional[Tuple]:
        """The next ``(wid, tid, payload)`` any worker sent, or None when
        none arrives within ``timeout_s``.  A dead worker's pipe reads what
        it sent before it died, then end of file: the pipe is closed then,
        and ``_reap`` respawns the worker."""
        conns = [w.result_conn for w in self._workers
                 if w is not None and not w.result_conn.closed]
        for conn in multiprocessing.connection.wait(conns, timeout_s):
            try:
                return conn.recv()
            except (EOFError, OSError):
                conn.close()
        return None

    def _revive(self, wid: int) -> _Worker:
        """Respawn a dead worker, carrying its queue contents over is not
        possible — the caller re-issues the outstanding tasks."""
        old = self._workers[wid]
        if old is not None and old.process.is_alive():
            return old
        self.respawns += 1
        return self._spawn(wid)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            if w is None:
                continue
            try:
                w.task_q.put(None)
            except Exception:  # noqa: BLE001
                pass
        for w in self._workers:
            if w is None:
                continue
            w.process.join(timeout=2.0)
            if w.process.is_alive():
                w.process.terminate()
                w.process.join(timeout=1.0)
            w.result_conn.close()
        self._workers = [None] * self.n_workers

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort: daemons die with the parent anyway
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    def wait_ready(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every worker has reported ready (True) or
        ``timeout_s`` passes (False).  Optional: batches wait on their own."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not all(w is not None and self._check_ready(w) for w in self._workers):
            if deadline is not None and time.monotonic() >= deadline:
                return False
            got = self._next_result(0.25)
            if got is not None and got[1] is None:
                self._on_ready(got[0], got[2])
        return True

    def _check_ready(self, w: _Worker) -> bool:
        """Whether the worker has finished starting up; the first time the
        parent sees it, the hung clock starts for the task it holds."""
        if not w.ready and w.ready_at.value > 0.0:
            w.ready = True
            self._startup_deaths = 0
            w.startup_s = w.ready_at.value - w.spawned_wall  # spawn to ready
            if w.outstanding:
                w.busy_since = time.monotonic()
        return w.ready

    def _on_ready(self, wid: int, payload: Tuple) -> None:
        _, pid, info = payload
        w = self._workers[wid]
        # a ready message from a killed incarnation must not describe its
        # replacement: match the process
        if w is not None and w.process.pid == pid:
            w.info = dict(info)
            self._check_ready(w)

    # -- measurement ----------------------------------------------------------

    def measure_batch(
        self,
        nests: Sequence[LoopNest],
        cost_hint: Optional[Callable[[LoopNest], float]] = None,
        compiled_hint: Optional[Callable[[LoopNest], bool]] = None,
    ) -> List[Measurement]:
        """Measure every nest, in parallel across the pool.

        Scheduling is *pull-based*: each worker holds at most one queued
        task, and receives its next schedule when a result comes back —
        heterogeneous schedule costs therefore balance dynamically.  The
        backlog is ordered already-compiled-first (``compiled_hint``), then
        longest-expected-first (``cost_hint``, LPT scheduling) so no
        heavyweight schedule starts last.  Duplicate structures are
        measured once; when the batch is smaller than the pool, each
        schedule fans out to the idle workers and the per-worker
        measurements merge into one best-of-across-processes record.
        """
        if self._closed:
            raise RuntimeError("WorkerPool is closed")
        if not nests:
            return []
        t_batch0 = time.monotonic()
        self._batch_serial += 1
        serial = self._batch_serial
        for w in self._workers:
            if w is not None:
                # tasks abandoned by an aborted batch (worker-error raise)
                # must not wedge this one; their late results are dropped by
                # the serial check below
                w.outstanding.clear()
                w.busy_since = None

        # dedup by structure: one measurement per distinct schedule
        uniq_keys: List[Tuple] = []
        uniq_nests: List[LoopNest] = []
        slot_of: Dict[Tuple, int] = {}
        for n in nests:
            k = n.structure_key()
            if k not in slot_of:
                slot_of[k] = len(uniq_keys)
                uniq_keys.append(k)
                uniq_nests.append(n)

        # compiled-first, then longest-expected-first backlog; small batches
        # fan each schedule out to the idle workers (best-of across
        # processes)
        order = list(range(len(uniq_nests)))
        if cost_hint is not None or compiled_hint is not None:
            cold = (
                (lambda s: not compiled_hint(uniq_nests[s]))
                if compiled_hint is not None else (lambda s: False))
            cost = (
                (lambda s: -cost_hint(uniq_nests[s]))
                if cost_hint is not None else (lambda s: 0.0))
            order.sort(key=lambda s: (cold(s), cost(s)))
        dups = max(1, self.n_workers // len(uniq_nests))
        tasks: Dict[Tuple, Tuple] = {}  # tid -> (contraction, key)
        backlog: List[Tuple] = []  # tids, next-to-dispatch last
        for slot in order:
            for d in range(dups):
                tid = (serial, slot, d)
                tasks[tid] = (uniq_nests[slot].contraction, uniq_keys[slot])
                backlog.append(tid)
        backlog.reverse()  # pop() takes the longest-expected first

        self._fill(backlog, tasks)  # one task per worker; results pull more

        parts: Dict[int, List[Measurement]] = {}
        retries: Dict[Tuple, int] = {}
        while backlog or any(
                w is not None and w.outstanding for w in self._workers):
            got = self._next_result(0.25)
            if got is None:
                self._kill_hung()
                self._reap(retries, tasks, backlog, parts)
                # tasks a dead worker returned to the backlog must reach an
                # idle worker even when no result will arrive to pull them
                self._fill(backlog, tasks)
                continue
            src, tid, payload = got
            if tid is None:
                self._on_ready(src, payload)
                continue
            if tid[0] != serial:
                continue  # stale result from a pre-respawn batch
            owner_wid = self._owner_of(tid)
            if owner_wid is None:
                continue  # duplicate delivery after a respawn re-issue
            owner = self._workers[owner_wid]
            owner.outstanding.pop(tid)
            owner.busy_since = (None if not owner.outstanding
                                else time.monotonic())
            status, data = payload
            if status == "err":
                raise RuntimeError(
                    f"measurement worker {src} failed on task {tid}:\n{data}")
            self.tasks_done += 1
            parts.setdefault(tid[1], []).append(Measurement.unship(data))
            if backlog:  # pull: the freed worker takes the next schedule
                self._dispatch(owner_wid, backlog.pop(), tasks)

        merged: List[Measurement] = []
        for slot, nest in enumerate(uniq_nests):
            merged.append(Measurement.merge(
                parts[slot], nest.contraction.flops(), self.policy))
        self.last_batch_s = time.monotonic() - t_batch0
        return [merged[slot_of[n.structure_key()]] for n in nests]

    def _fill(self, backlog: List[Tuple], tasks: Dict[Tuple, Tuple]) -> None:
        """Hand every idle worker one task from the backlog.  Depth one on
        purpose: a queued-behind-a-heavy task cannot migrate between the
        per-worker queues, and a dispatch round-trip is microseconds
        against measurements of many milliseconds."""
        for wid in range(self.n_workers):
            w = self._workers[wid]
            if backlog and (w is None or not w.outstanding):
                self._dispatch(wid, backlog.pop(), tasks)

    def _dispatch(self, wid: int, tid: Tuple, tasks: Dict[Tuple, Tuple]) -> None:
        w = self._workers[wid]
        if w is None or not w.process.is_alive():
            w = self._revive(wid)
        task = tasks[tid]
        if not w.outstanding:
            # a worker still starting up starts its clock when it is ready
            w.busy_since = time.monotonic() if self._check_ready(w) else None
        w.outstanding[tid] = task
        w.task_q.put((tid, *task))

    def _owner_of(self, tid: Tuple) -> Optional[int]:
        for wid, w in enumerate(self._workers):
            if w is not None and tid in w.outstanding:
                return wid
        return None

    @staticmethod
    def _kill(w: _Worker) -> None:
        w.process.terminate()
        w.process.join(timeout=1.0)
        if w.process.is_alive():
            w.process.kill()
            w.process.join(timeout=1.0)

    def _kill_hung(self) -> None:
        """Kill workers that hold tasks but have made no progress for
        ``task_timeout_s`` since they were ready (a runaway evaluator, a
        kernel that never returns), or that have not finished starting up
        within ``startup_timeout_s``.  The kill turns it into a dead
        worker, which ``_reap`` then respawns and whose tasks it re-issues
        (counting retries, so a schedule that hangs every worker eventually
        resolves as failed)."""
        now = time.monotonic()
        for w in self._workers:
            if w is None or not w.outstanding or not w.process.is_alive():
                continue
            if self._check_ready(w):
                if (self.task_timeout_s is not None and w.busy_since is not None
                        and now - w.busy_since > self.task_timeout_s):
                    self.hung_killed += 1
                    self._kill(w)
            elif (self.startup_timeout_s is not None
                  and now - w.spawned_at > self.startup_timeout_s):
                self.startup_killed += 1
                self._kill(w)

    def _reap(self, retries: Dict[Tuple, int], tasks: Dict[Tuple, Tuple],
              backlog: List[Tuple],
              parts: Dict[int, List[Measurement]]) -> None:
        """Respawn dead workers and re-issue their in-flight tasks (a task
        past its retry budget resolves as a failed measurement)."""
        for wid, w in enumerate(self._workers):
            if w is None or w.process.is_alive() or not w.outstanding:
                continue
            if not self._check_ready(w):
                # died (or was killed) before it could measure anything: the
                # executor cannot start here, which is no schedule's fault
                self._startup_deaths += 1
                if self._startup_deaths > self.max_task_retries:
                    raise RuntimeError(
                        f"measurement workers for {self.spec!r} died during "
                        f"start-up {self._startup_deaths} times in a row (last "
                        f"exit code {w.process.exitcode})")
            pending = dict(w.outstanding)
            w.outstanding.clear()
            self._revive(wid)
            for tid, task in pending.items():
                retries[tid] = retries.get(tid, 0) + 1
                if retries[tid] > self.max_task_retries:
                    # poison schedule: it keeps killing workers.  Running
                    # it in the parent would defeat the isolation the pool
                    # exists for (on the card, a sticky CUDA fault would
                    # end the tuner), so it resolves to a marked-failed
                    # record: zero GFLOPS, flagged noisy — training
                    # down-weights it, search never prefers it, and the
                    # batch completes
                    self.failed_tasks += 1
                    parts.setdefault(tid[1], []).append(
                        failed_measurement())
                else:
                    backlog.append(tid)  # re-issued to the next free worker

    def stats(self) -> Dict[str, Any]:
        live = [w for w in self._workers if w is not None]
        return {
            "workers": self.n_workers,
            "start_method": self.start_method,
            "alive": sum(1 for w in live if w.process.is_alive()),
            "ready": sum(1 for w in live if self._check_ready(w)),
            "busy_workers": sum(1 for w in live if w.outstanding),
            "tasks_done": self.tasks_done,
            "respawns": self.respawns,
            "failed_tasks": self.failed_tasks,
            "hung_killed": self.hung_killed,
            "startup_killed": self.startup_killed,
            "last_batch_s": round(self.last_batch_s, 4),
            # per worker: its pid, start-up seconds and what its executor
            # reported when ready (the card executor: device and builds)
            "worker_info": [
                {"pid": w.process.pid, "startup_s": w.startup_s, **w.info}
                if w is not None else None for w in self._workers],
        }
