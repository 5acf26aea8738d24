"""Fault tolerance for the training loop (the port's copy of the JAX
package's ``runtime/ft.py``, which is NumPy only).

* :class:`FaultTolerantRunner` — wraps the step: on a device/host
  failure (any exception from the step, including injected ones) it reloads
  the latest checkpoint and replays from there.  Because the data pipeline
  is a pure function of the step counter, the replayed batches are identical
  — deterministic restart.
* :class:`StragglerWatchdog` — per-host step-time EWMA + robust z-score;
  hosts slower than ``k`` MADs above the median for ``patience`` consecutive
  steps are flagged (on a fleet the controller would evict/reshard; here the
  policy hook fires and the event is logged).
* :class:`FailureInjector` — deterministic fault schedule for tests/examples
  ("fail at step 7 twice").
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("repro_torch.ft")


class FailureInjector:
    """Raises at scheduled steps (each entry fires once)."""

    def __init__(self, fail_steps: Optional[List[int]] = None):
        self.pending = sorted(fail_steps or [])
        self.fired: List[int] = []

    def maybe_fail(self, step: int) -> None:
        if self.pending and step >= self.pending[0]:
            s = self.pending.pop(0)
            self.fired.append(s)
            raise RuntimeError(f"injected device failure at step {s}")


@dataclass
class StragglerWatchdog:
    n_hosts: int
    k_mads: float = 4.0
    patience: int = 3
    ewma: float = 0.7
    on_straggler: Optional[Callable[[int, float], None]] = None
    _t: Optional[np.ndarray] = None
    _bad: Optional[np.ndarray] = None
    events: List[Tuple[int, int, float]] = field(default_factory=list)

    def record(self, step: int, host_times: np.ndarray) -> List[int]:
        """host_times: per-host step seconds.  Returns flagged host ids."""
        host_times = np.asarray(host_times, np.float64)
        if self._t is None:
            self._t = host_times.copy()
            self._bad = np.zeros(self.n_hosts, np.int32)
        else:
            self._t = self.ewma * self._t + (1 - self.ewma) * host_times
        med = np.median(self._t)
        mad = np.median(np.abs(self._t - med)) + 1e-9
        slow = self._t > med + self.k_mads * mad
        self._bad = np.where(slow, self._bad + 1, 0)
        flagged = [int(h) for h in np.flatnonzero(self._bad >= self.patience)]
        for h in flagged:
            self.events.append((step, h, float(self._t[h])))
            if self.on_straggler:
                self.on_straggler(h, float(self._t[h]))
            self._bad[h] = 0  # re-arm after firing
        return flagged


class FaultTolerantRunner:
    """step_fn(state, batch) -> (state, metrics); state is any pytree."""

    def __init__(
        self,
        step_fn: Callable,
        ckpt_manager,
        save_every: int = 50,
        max_restarts: int = 5,
        injector: Optional[FailureInjector] = None,
        extras_fn: Optional[Callable[[int], dict]] = None,
    ):
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.injector = injector
        self.extras_fn = extras_fn
        self.restarts = 0
        self.restart_log: List[Tuple[int, str]] = []

    def run(
        self,
        state: Any,
        batch_fn: Callable[[int], Any],
        start_step: int,
        n_steps: int,
        hooks: Optional[List[Callable[[int, dict], None]]] = None,
    ) -> Tuple[Any, int, List[dict]]:
        """Runs to ``start_step + n_steps`` surviving injected failures."""
        step = start_step
        end = start_step + n_steps
        metrics_log: List[dict] = []
        while step < end:
            try:
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch_fn(step))
                dt = time.perf_counter() - t0
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, step_time_s=dt)
                metrics_log.append(m)
                for h in hooks or []:
                    h(step, m)
                step += 1
                if step % self.save_every == 0:
                    self.ckpt.save(
                        step, state,
                        extras=self.extras_fn(step) if self.extras_fn else {})
            except Exception as e:  # noqa: BLE001 — the whole point
                self.restarts += 1
                self.restart_log.append((step, repr(e)))
                log.warning("step %d failed (%s); restart %d/%d",
                            step, e, self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise
                restored = self.ckpt.restore_latest(state)
                if restored is None:
                    # no checkpoint yet: replay from the beginning
                    step = start_step
                    continue
                step, state, _ = restored
        return state, step, metrics_log
