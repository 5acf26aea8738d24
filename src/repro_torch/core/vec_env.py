"""Vectorized LoopTune environment: N independent nests stepped as a batch.

``VecLoopTuneEnv`` holds N lanes, each semantically identical to a scalar
:class:`LoopTuneEnv` seeded ``seed + lane``: same featurization, same action
legality, same normalized-GFLOPS-delta reward.  The difference is cost
shape — per step, only the lanes whose *structure* changed are re-evaluated,
and those go through the shared :class:`ScheduleCache` /
:meth:`Backend.evaluate_batch` in a single call, so lanes exploring the same
schedules amortize each other's measurements and batched policies pay one
network call per step instead of N.

This is the rollout substrate for the RL trainers
(:func:`repro_torch.core.rl_common.collect_vec_rollout`) and for the tuner's
``tune_many`` (one lane per contraction).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .actions import Action, apply_action, build_action_space, legal_mask
from .backend import Backend, backend_name, make_backend
from .env import DEFAULT_EPISODE_LEN, LoopTuneEnv, _settle_batch
from .graph_features import FlatFeaturizer
from .loop_ir import Contraction, LoopNest
from .measure import Measurement, measurement_of
from .schedule_cache import DEFAULT_CAPACITY, ScheduleCache


class VecLoopTuneEnv:
    def __init__(
        self,
        benchmarks: Sequence[Contraction],
        backend,
        n_envs: int,
        actions: Optional[Sequence[Action]] = None,
        episode_len: int = DEFAULT_EPISODE_LEN,
        seed: int = 0,
        cache_size: int = DEFAULT_CAPACITY,
        cache: Optional[ScheduleCache] = None,
        featurizer=None,
        peak: Optional[float] = None,
        remeasure_noisy: bool = True,
    ):
        if n_envs < 1:
            raise ValueError(f"n_envs must be >= 1, got {n_envs}")
        self.benchmarks = list(benchmarks)
        # backend may be a Backend instance or a registry name — see
        # core.backend.make_backend
        self.backend = make_backend(backend)
        self.actions = list(actions) if actions is not None else build_action_space()
        self.n_envs = n_envs
        self.episode_len = episode_len
        # lane i draws benchmarks exactly like LoopTuneEnv(seed=seed + i)
        self.rngs = [np.random.default_rng(seed + i) for i in range(n_envs)]
        # same pluggable observation function as LoopTuneEnv (all lanes share)
        self.featurizer = featurizer if featurizer is not None else FlatFeaturizer()
        self.cache = cache if cache is not None else ScheduleCache(cache_size)
        # calibrated reward normalizer override — same semantics as
        # LoopTuneEnv(peak=...)
        self._peak_override = peak
        self.peak = float(peak) if peak is not None else self.backend.peak()
        self.remeasure_noisy = remeasure_noisy
        self.nests: List[Optional[LoopNest]] = [None] * n_envs
        self.t = np.zeros(n_envs, dtype=np.int64)
        self._gflops = np.zeros(n_envs, dtype=np.float64)
        # per-lane baseline reward quality — see LoopTuneEnv._g_noisy
        self._g_noisy = np.zeros(n_envs, dtype=bool)
        self.initial_gflops = np.zeros(n_envs, dtype=np.float64)

    @classmethod
    def from_env(cls, env: LoopTuneEnv, n_envs: int, seed: int = 0,
                 featurizer=None, backend=None) -> "VecLoopTuneEnv":
        """Vectorize an existing scalar env: share its benchmarks, backend,
        action space, episode length and evaluation cache.  ``featurizer``
        overrides the scalar env's observation function (the trainers pass
        the one their EncoderConfig demands).  ``backend`` (a registry name
        or instance) overrides the scalar env's executor — the evaluation
        cache is then shared only if the executor is actually unchanged,
        since one backend's measurements would poison another's rewards."""
        be, cache = env.backend, env.cache
        if backend is not None:
            if isinstance(backend, Backend):
                # an explicit instance is honored as given (it may carry
                # different repeats/seed): fresh cache unless it IS the
                # env's own backend
                if backend is not env.backend:
                    be, cache = backend, None
            else:
                cand = make_backend(backend)
                if backend_name(cand) != backend_name(be):
                    be, cache = cand, None
        return cls(env.benchmarks, be, n_envs, actions=env.actions,
                   episode_len=env.episode_len, seed=seed, cache=cache,
                   featurizer=featurizer if featurizer is not None
                   else env.featurizer,
                   # a calibrated normalizer only carries over to the same
                   # executor (cache is None exactly when it changed)
                   peak=env._peak_override if cache is env.cache else None,
                   remeasure_noisy=env.remeasure_noisy)

    @classmethod
    def ensure(cls, env, n_envs: int, seed: int = 0,
               featurizer=None, backend=None) -> "VecLoopTuneEnv":
        """Pass a VecLoopTuneEnv through unchanged; vectorize a scalar env.

        A demanded ``featurizer`` (what the trainer's EncoderConfig needs)
        must be compatible with an already-vectorized env's observation
        format — mutating the caller's env in place would silently break any
        policy already acting on its old observations, so mismatch is an
        error: construct the VecLoopTuneEnv with the right ``featurizer=``
        (or pass a scalar env / factory and let the trainer wrap it).  The
        same holds for a demanded ``backend`` (a trainer config's explicit
        executor choice): an already-vectorized env keeps its backend, so a
        name mismatch is an error rather than a silent reward-source swap."""
        if isinstance(env, cls):
            if featurizer is not None and (
                    featurizer.kind != env.featurizer.kind
                    or featurizer.state_dim != env.featurizer.state_dim):
                raise ValueError(
                    f"env featurizer {env.featurizer!r} does not match the "
                    f"encoder's required {featurizer!r}; build the "
                    f"VecLoopTuneEnv with featurizer={featurizer!r} or pass "
                    f"a scalar env")
            if backend is not None and (
                    backend_name(make_backend(backend))
                    != backend_name(env.backend)):
                raise ValueError(
                    f"env backend {backend_name(env.backend)!r} does not "
                    f"match the config's required {backend!r}; build the "
                    f"VecLoopTuneEnv with backend={backend!r} or pass a "
                    f"scalar env")
            return env
        return cls.from_env(env, n_envs, seed=seed, featurizer=featurizer,
                            backend=backend)

    # -- evaluation -----------------------------------------------------------

    @property
    def backend_name(self) -> str:
        return backend_name(self.backend)

    def gflops_batch(self, nests: Sequence[LoopNest]) -> np.ndarray:
        """Cached batched evaluation with the reward-quality guardrail:
        noisy measurements re-measure once through one extra batched call
        (same semantics as ``LoopTuneEnv.gflops``)."""
        self.prepare_eval(nests)
        g = self.cache.evaluate_batch(self.backend, nests)
        return _settle_batch(self.backend, self.cache, nests, g,
                             self.remeasure_noisy)[0]

    def prepare_eval(self, nests: Sequence[LoopNest]) -> int:
        """Compile-ahead hint to the backend (see
        ``LoopTuneEnv.prepare_eval``): cache-cold schedules about to be
        evaluated compile in the background while the current ones measure."""
        if not getattr(self.backend, "can_prepare", False):
            return 0
        cold = [n for n in nests if n.structure_key() not in self.cache]
        return self.backend.prepare_batch(cold) if cold else 0

    def submit_eval(self, nests: Sequence[LoopNest]) -> int:
        """Measure-ahead hint (see ``LoopTuneEnv.submit_eval``): cache-cold
        schedules go in flight on an async backend; the cache collects them
        when their value is actually needed.  Advisory, returns 0 when the
        backend has no async path."""
        if not getattr(self.backend, "can_measure_async", False):
            return 0
        return self.cache.submit_eval(self.backend, nests)

    def _noisy_of(self, nest: LoopNest) -> bool:
        m = measurement_of(self.backend, nest)
        return bool(m is not None and m.noisy)

    def clear_cache(self) -> None:
        self.cache.clear()

    # -- gym-like vector API ---------------------------------------------------

    @property
    def n_actions(self) -> int:
        return len(self.actions)

    @property
    def state_dim(self) -> int:
        return self.featurizer.state_dim

    @property
    def current_gflops(self) -> np.ndarray:
        return self._gflops

    def reset(
        self, benchmark_indices: Optional[Sequence[int]] = None
    ) -> np.ndarray:
        """Reset every lane; returns observations ``(n_envs, state_dim)``."""
        if benchmark_indices is None:
            benchmark_indices = [
                int(rng.integers(len(self.benchmarks))) for rng in self.rngs
            ]
        if len(benchmark_indices) != self.n_envs:
            raise ValueError(
                f"benchmark_indices has {len(benchmark_indices)} entries "
                f"for {self.n_envs} lanes")
        for i, bi in enumerate(benchmark_indices):
            self.nests[i] = LoopNest(self.benchmarks[bi])
            self.t[i] = 0
        g = self.gflops_batch(self.nests)
        self._gflops[:] = g
        self._g_noisy[:] = [self._noisy_of(n) for n in self.nests]
        self.initial_gflops[:] = g
        return self.observe()

    def reset_lane(self, i: int, benchmark_idx: Optional[int] = None) -> np.ndarray:
        """Reset lane ``i`` only; returns its observation ``(state_dim,)``."""
        self.reset_lanes([i], None if benchmark_idx is None else [benchmark_idx])
        return self.observe_lane(i)

    def reset_lanes(
        self,
        lanes: Sequence[int],
        benchmark_indices: Optional[Sequence[int]] = None,
    ) -> None:
        """Reset a subset of lanes, evaluating their fresh nests in one
        batched (cached) backend call."""
        if benchmark_indices is None:
            benchmark_indices = [
                int(self.rngs[i].integers(len(self.benchmarks))) for i in lanes
            ]
        for i, bi in zip(lanes, benchmark_indices):
            self.nests[i] = LoopNest(self.benchmarks[bi])
            self.t[i] = 0
        g = self.gflops_batch([self.nests[i] for i in lanes])
        for j, i in enumerate(lanes):
            self._gflops[i] = g[j]
            self._g_noisy[i] = self._noisy_of(self.nests[i])
            self.initial_gflops[i] = g[j]

    def observe_lane(self, i: int) -> np.ndarray:
        return self.featurizer(self.nests[i])

    def observe(self) -> np.ndarray:
        return np.stack([self.observe_lane(i) for i in range(self.n_envs)])

    def action_mask_lane(self, i: int) -> np.ndarray:
        return np.asarray(legal_mask(self.nests[i], self.actions), dtype=bool)

    def action_mask(self) -> np.ndarray:
        """Legal-action mask ``(n_envs, n_actions)`` bool."""
        return np.asarray(
            [legal_mask(nest, self.actions) for nest in self.nests], dtype=bool
        )

    def step(
        self, action_indices: Sequence[int]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[dict]]:
        """Apply one action per lane.  Only the structurally-changed lanes are
        re-evaluated, through a single batched (cached) backend call.  On an
        async backend the changed lanes go in flight first and the whole
        fleet's featurization runs while they measure — the actor-side work
        hides behind the farm instead of stalling per step.  Returns
        ``(obs (N, D), rewards (N,), dones (N,), infos)``.  Lanes are NOT
        auto-reset on done — callers decide (see ``collect_vec_rollout``)."""
        assert all(n is not None for n in self.nests), "call reset() first"
        n = self.n_envs
        assert len(action_indices) == n, (len(action_indices), n)
        names: List[str] = [""] * n
        changed: List[int] = []
        for i in range(n):
            action = self.actions[int(action_indices[i])]
            names[i] = action.name
            if apply_action(self.nests[i], action):
                changed.append(i)
        rewards = np.zeros(n, dtype=np.float64)
        noisy = [False] * n
        measurements: List[Optional[Measurement]] = [None] * n
        obs = None
        if changed:
            # measure-ahead: put the changed lanes in flight, featurize all
            # lanes while the farm works, then collect (observations depend
            # only on the nests, never on their measured GFLOPS)
            if self.submit_eval([self.nests[i] for i in changed]):
                obs = self.observe()
            # gflops_batch applies the reward-quality guardrail (noisy
            # measurements re-measured once, batched)
            new_g = self.gflops_batch([self.nests[i] for i in changed])
            for j, i in enumerate(changed):
                m = measurement_of(self.backend, self.nests[i])
                new_noisy = bool(m is not None and m.noisy)
                # same float64 arithmetic as the scalar env's step(); a
                # delta reward embeds the noise of EITHER endpoint
                rewards[i] = (float(new_g[j]) - float(self._gflops[i])) / self.peak
                noisy[i] = new_noisy or bool(self._g_noisy[i])
                self._gflops[i] = new_g[j]
                self._g_noisy[i] = new_noisy
                measurements[i] = m
        self.t += 1
        dones = self.t >= self.episode_len
        infos = []
        for i in range(n):
            info = {"gflops": float(self._gflops[i]), "action": names[i],
                    "noisy": noisy[i]}
            if measurements[i] is not None:
                info["measurement"] = measurements[i].to_info()
            infos.append(info)
        if obs is None:
            obs = self.observe()
        return obs, rewards, dones, infos

    # -- snapshots (per-lane, mirroring LoopTuneEnv) ---------------------------

    def snapshot_lane(self, i: int) -> Tuple[LoopNest, int, float]:
        return self.nests[i].clone(), int(self.t[i]), float(self._gflops[i])

    def restore_lane(self, i: int, snap: Tuple[LoopNest, int, float]) -> None:
        nest, t, g = snap
        self.nests[i] = nest.clone()
        self.t[i] = t
        self._gflops[i] = g
        self._g_noisy[i] = self._noisy_of(self.nests[i])
