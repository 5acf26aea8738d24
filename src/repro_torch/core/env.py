"""Gym-like RL environment for LoopTune (paper Fig. 2).

``reset()`` annotates the first loop with the agent cursor; ``step(a)``
applies an action, re-evaluates the nest on the reward backend only when the
structure changed, and returns the paper's normalized reward::

    reward = (GFLOPS(S') - GFLOPS(S)) / GFLOPS_peak

Episodes are fixed length (paper: 10 actions, implicit stop); structure
evaluations are cached in a shared :class:`ScheduleCache` (LRU, keyed by
canonical schedule key) so searches, vectorized lanes and replayed states
never re-measure.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .actions import Action, apply_action, build_action_space, legal_mask
from .backend import Backend, backend_name, make_backend
from .graph_features import FlatFeaturizer
from .loop_ir import Contraction, LoopNest
from .measure import Measurement, measurement_of
from .schedule_cache import DEFAULT_CAPACITY, ScheduleCache

DEFAULT_EPISODE_LEN = 10


def _settle_one(backend, cache, nest: LoopNest, gflops: float,
                remeasure: bool) -> Tuple[float, Optional[Measurement]]:
    """Reward-quality guardrail: if the measurement behind ``gflops`` is
    flagged noisy and has not already spent its one re-measurement, drop
    the cached value and measure again.  Returns the (possibly refreshed)
    gflops and the record (None on record-less backends)."""
    m = measurement_of(backend, nest)
    if m is not None and m.noisy and not m.remeasured and remeasure:
        cache.invalidate(nest.structure_key())
        gflops = cache.evaluate(backend, nest)
        m = measurement_of(backend, nest) or m
        m.remeasured = True
    return gflops, m


def _settle_batch(backend, cache, nests: Sequence[LoopNest],
                  gflops: np.ndarray, remeasure: bool
                  ) -> Tuple[np.ndarray, list]:
    """Batched :func:`_settle_one`: the noisy subset re-measures through
    one extra (deduped) ``evaluate_batch`` call."""
    ms = [measurement_of(backend, n) for n in nests]
    if remeasure:
        redo = [j for j, m in enumerate(ms)
                if m is not None and m.noisy and not m.remeasured]
        if redo:
            for j in redo:
                cache.invalidate(nests[j].structure_key())
            re_g = cache.evaluate_batch(backend, [nests[j] for j in redo])
            gflops = np.array(gflops, dtype=np.float64, copy=True)
            for k, j in enumerate(redo):
                gflops[j] = re_g[k]
                m = measurement_of(backend, nests[j])
                ms[j] = m if m is not None else ms[j]
                ms[j].remeasured = True
    return gflops, ms


class LoopTuneEnv:
    def __init__(
        self,
        benchmarks: Sequence[Contraction],
        backend="auto",
        actions: Optional[Sequence[Action]] = None,
        episode_len: int = DEFAULT_EPISODE_LEN,
        seed: int = 0,
        cache_size: int = DEFAULT_CAPACITY,
        cache: Optional[ScheduleCache] = None,
        featurizer=None,
        peak: Optional[float] = None,
        remeasure_noisy: bool = True,
    ):
        self.benchmarks = list(benchmarks)
        # backend may be a Backend instance or a registry name
        # ("numpy" | "torch" | "tpu" | "auto" | ...) — see core.backend
        self.backend = make_backend(backend)
        self.actions = list(actions) if actions is not None else build_action_space()
        self.episode_len = episode_len
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # how the nest becomes the observation vector: FlatFeaturizer (the
        # paper's MAX_LOOPS x 20 flattening, the default) or GraphFeaturizer
        # (packed graph obs for the message-passing encoder) — see
        # graph_features.py; the policy's EncoderConfig dictates the choice
        self.featurizer = featurizer if featurizer is not None else FlatFeaturizer()
        self.cache = cache if cache is not None else ScheduleCache(cache_size)
        # reward normalizer: the backend's live peak() unless the caller
        # supplies a calibrated one (LoopTuner.from_checkpoint passes the
        # train-time peak recorded in checkpoint meta, so rewards keep the
        # exact scale the policy was trained on — see core.measure)
        self._peak_override = peak
        self.peak = float(peak) if peak is not None else self.backend.peak()
        # a measurement the backend flags as noisy (spread above the policy
        # threshold even after repeat escalation) is re-measured once before
        # its reward is trusted; still-noisy rewards are marked in info
        self.remeasure_noisy = remeasure_noisy
        self.nest: Optional[LoopNest] = None
        self.t = 0
        self._gflops = 0.0
        # whether the measurement behind the current baseline _gflops was
        # still noisy after re-measurement: a delta reward is only as clean
        # as BOTH of its endpoints, so this propagates into the next
        # step's noisy mark
        self._g_noisy = False
        self.initial_gflops = 0.0

    # -- evaluation with caching ----------------------------------------------

    def gflops(self, nest: LoopNest) -> float:
        """Cached evaluation, with the reward-quality guardrail applied:
        a measurement the backend flags noisy is re-measured once (cache
        entry dropped) before its value is served — to RL steps, searches
        and surrogate harvesting alike."""
        g = self.cache.evaluate(self.backend, nest)
        return _settle_one(self.backend, self.cache, nest, g,
                           self.remeasure_noisy)[0]

    def gflops_batch(self, nests: Sequence[LoopNest]) -> np.ndarray:
        """Cached batched evaluation (one ``Backend.evaluate_batch`` call for
        the deduped misses), noisy measurements re-measured in one extra
        batched call."""
        self.prepare_eval(nests)
        g = self.cache.evaluate_batch(self.backend, nests)
        return _settle_batch(self.backend, self.cache, nests, g,
                             self.remeasure_noisy)[0]

    def prepare_eval(self, nests: Sequence[LoopNest]) -> int:
        """Compile-ahead hint to the backend: schedules about to be (or soon
        to be) evaluated.  Nests whose value is already cached are filtered
        out — their executables will never be rebuilt on this path.  Purely
        advisory: rewards are identical with or without the hint."""
        if not getattr(self.backend, "can_prepare", False):
            return 0
        cold = [n for n in nests if n.structure_key() not in self.cache]
        return self.backend.prepare_batch(cold) if cold else 0

    def submit_eval(self, nests: Sequence[LoopNest]) -> int:
        """Measure-ahead hint, the async sibling of :meth:`prepare_eval`:
        cache-cold schedules likely to be evaluated next go *in flight* on
        an async backend (``can_measure_async``) while the caller keeps
        working — frontier generation, surrogate ranking, compile-ahead —
        and a later ``gflops``/``gflops_batch`` collects them instead of
        measuring cold.  The cache's in-flight table guarantees nothing is
        measured twice.  Advisory and always safe: returns 0 when the
        backend has no async path."""
        if not getattr(self.backend, "can_measure_async", False):
            return 0
        return self.cache.submit_eval(self.backend, nests)

    def _noisy_of(self, nest: LoopNest) -> bool:
        m = measurement_of(self.backend, nest)
        return bool(m is not None and m.noisy)

    def clear_cache(self) -> None:
        self.cache.clear()

    # -- backend selection ------------------------------------------------------

    @property
    def backend_name(self) -> str:
        return backend_name(self.backend)

    def with_backend(self, backend) -> "LoopTuneEnv":
        """A sibling env on the named executor.  Same benchmarks, actions,
        episode length and featurizer; the evaluation cache is shared only
        when the executor is unchanged — GFLOPS measured by one backend
        would poison another's rewards.  A *name* matching the current
        executor reuses it (and the cache); an explicit Backend *instance*
        is always honored as given (it may carry different repeats/seed, so
        its measurements get a fresh cache unless it is this very
        instance)."""
        be = backend if isinstance(backend, Backend) else make_backend(backend)
        if not isinstance(backend, Backend) and (
                backend_name(be) == self.backend_name):
            be = self.backend
        same = be is self.backend
        return LoopTuneEnv(
            self.benchmarks, be,
            actions=self.actions, episode_len=self.episode_len,
            seed=self.seed, cache=self.cache if same else None,
            featurizer=self.featurizer,
            # a calibrated reward normalizer is only meaningful against the
            # executor it was recorded for
            peak=self._peak_override if same else None,
            remeasure_noisy=self.remeasure_noisy)

    # -- gym API ----------------------------------------------------------------

    @property
    def n_actions(self) -> int:
        return len(self.actions)

    @property
    def state_dim(self) -> int:
        return self.featurizer.state_dim

    def reset(self, benchmark_idx: Optional[int] = None) -> np.ndarray:
        if benchmark_idx is None:
            benchmark_idx = int(self.rng.integers(len(self.benchmarks)))
        self.nest = LoopNest(self.benchmarks[benchmark_idx])
        self.t = 0
        self._gflops = self.gflops(self.nest)
        self._g_noisy = self._noisy_of(self.nest)
        self.initial_gflops = self._gflops
        return self.observe()

    def observe(self) -> np.ndarray:
        return self.featurizer(self.nest)

    def action_mask(self) -> np.ndarray:
        return np.asarray(legal_mask(self.nest, self.actions), dtype=bool)

    def step(self, a_idx: int) -> Tuple[np.ndarray, float, bool, dict]:
        assert self.nest is not None, "call reset() first"
        action = self.actions[a_idx]
        changed = apply_action(self.nest, action)
        reward = 0.0
        reward_noisy = False
        measurement: Optional[Measurement] = None
        if changed:
            new_gflops = self.gflops(self.nest)  # settled by the guardrail
            measurement = measurement_of(self.backend, self.nest)
            new_noisy = bool(measurement is not None and measurement.noisy)
            reward = (new_gflops - self._gflops) / self.peak
            # a delta reward embeds the noise of EITHER endpoint: the mark
            # carries the baseline's noisiness forward so the correction
            # step after a noisy measurement is not trusted at full weight
            reward_noisy = new_noisy or self._g_noisy
            self._gflops = new_gflops
            self._g_noisy = new_noisy
        self.t += 1
        done = self.t >= self.episode_len
        info = {"gflops": self._gflops, "action": action.name,
                # reward quality: False for unchanged structures, cached
                # clean measurements and deterministic backends; True when
                # either endpoint of the delta was a still-noisy measurement
                "noisy": reward_noisy}
        if measurement is not None:
            info["measurement"] = measurement.to_info()
        return self.observe(), reward, done, info

    # -- snapshots for tree search -----------------------------------------------

    def snapshot(self) -> Tuple[LoopNest, int, float]:
        return self.nest.clone(), self.t, self._gflops

    def restore(self, snap: Tuple[LoopNest, int, float]) -> None:
        nest, t, g = snap
        self.nest = nest.clone()
        self.t = t
        self._gflops = g
        self._g_noisy = self._noisy_of(self.nest)

    @property
    def current_gflops(self) -> float:
        return self._gflops
