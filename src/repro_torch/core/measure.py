"""Measurement subsystem: timing policy and variance guardrails.

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

* **Measurement mode** — only ``measure="inproc"`` exists in this package
  so far.  The out-of-process worker pool (``measure="pool"``) is queued in
  ROADMAP.md ("WorkerPool"): a CUDA worker needs the spawn start method
  and one worker per card, so it is not a copy of the CPU pool.

``Measurement`` records ride alongside the scalar GFLOPS that the
:class:`~repro_torch.core.schedule_cache.ScheduleCache` stores, via the
backend's bounded ``measurement_for`` record map — that is how the
environment surfaces reward quality in ``info`` without widening the cache.
"""
from __future__ import annotations

import abc
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

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
    """Shared measurement-mode plumbing for backends that will be able to
    route evaluation through a worker pool: mode state, settings reporting
    and shutdown.  Subclasses provide :meth:`pool_spec`."""

    def _init_pool_host(self, measure: str,
                        pool_workers: Optional[int],
                        policy: Optional[MeasurementPolicy],
                        pool_timeout_s: Optional[float] = None) -> None:
        if measure == "pool":
            raise NotImplementedError(
                "measure='pool' needs the worker pool, which is not ported "
                "yet (ROADMAP.md, 'WorkerPool'); use measure='inproc'")
        if measure != "inproc":
            raise ValueError(f"measure must be 'inproc' or 'pool', got {measure!r}")
        self.measure_mode = measure
        self.pool_workers = pool_workers
        self.policy = policy
        self.pool_timeout_s = pool_timeout_s

    @abc.abstractmethod
    def pool_spec(self) -> Tuple[str, Dict[str, Any], Optional[str]]:
        """``(registry_name, kwargs, start_method)`` a worker process uses
        to build an equivalent in-process executor (``start_method`` None =
        pool default)."""

    def measure_settings(self) -> Dict[str, Any]:
        return {
            "mode": self.measure_mode,
            "workers": self.pool_workers,
            "policy": (self.policy.to_dict()
                       if self.policy is not None else None),
        }

    def close(self) -> None:
        """Release measurement resources (nothing to release in-process)."""


class MeasuredBackend(PoolHostBackend):
    """Base for backends whose GFLOPS come from wall-clock measurement.

    Subclasses are *pure executors*: they implement :meth:`run_once` (one
    synchronized execution of a schedule) and :meth:`pool_spec` (how a
    worker process rebuilds an equivalent executor); all timing, variance
    tracking and pool dispatch lives here.

    ``measure="inproc"`` times in this process through the policy (the
    only mode ported so far).  ``repeats`` is a
    convenience alias for ``MeasurementPolicy(repeats=...)`` — setting it
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

    def measure(self, nest: LoopNest, worker: int = -1) -> Measurement:
        """Measure one schedule in this process through the policy."""
        warm = self.policy.warm_elide and self.is_warm(nest)
        m = self.policy.measure(
            lambda: self.run_once(nest), nest.contraction.flops(),
            warm=warm, worker=worker)
        self._warm_contractions.add(nest.contraction.name)
        return self._record(nest, m)

    def measure_batch(self, nests: Sequence[LoopNest]) -> List[Measurement]:
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
        return out
