"""LoopTuner — the framework-facing auto-tuning service.

This is the paper's headline property as a first-class feature: a *trained*
policy tunes a new kernel in ~a second of pure inference (§III: "the policy
network quickly reaches the desired state in a matter of seconds"), and the
resulting schedule is lowered to a block shape and grid order that the
tiled-matmul kernel then runs with at serve time::

    tuner = LoopTuner.from_checkpoint("apex.pkl", backend="torch")
    entry = tuner.tune(matmul_benchmark(1024, 2048, 2048))
    # -> registry maps mm:1024x2048x2048 -> {block, grid_order, gflops}

``policy="policy"`` rolls a trained policy out greedily (``act=``, or
:meth:`LoopTuner.from_checkpoint`); ``policy="search"`` runs greedy and
beam search and keeps the better result, optionally pre-ranked by the
learned surrogate (``surrogate="auto"``); ``policy="default"`` records the
untuned nest.

Defaults differ from the JAX package's on purpose: ``backend="torch"`` (the
card executor; JAX: ``"tpu"``), ``policy="search"`` (JAX: ``"policy"``,
which needs a checkpoint) and ``surrogate="off"`` (JAX: ``"auto"``).  The
policy and surrogate networks run on ``device`` (``"cuda"``, which raises
without a card).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..tracing import span
from .actions import CPU_SPLITS, TPU_SPLITS, actions_from_names, build_action_space
from .backend import backend_name, make_backend
from .encoders import EncoderConfig, build_network, get_encoder, make_score_fn
from .env import LoopTuneEnv
from .loop_ir import Contraction, matmul_benchmark
from .measure import measure_settings
from .networks import params_from_numpy
from .registry import ScheduleRegistry
from .rl_common import (ActFn, greedy_rollout, greedy_rollout_vec, load_checkpoint,
                        make_masked_act)
from .schedule_cache import ScheduleCache
from .search import beam_search, greedy_search
from .surrogate import SurrogateScorer
from .vec_env import VecLoopTuneEnv

# "warn once": legacy checkpoints without a recorded peak trip this on the
# first load in a process, not on every tune() call
_WARNED_NO_PEAK = False

# legacy checkpoints (no meta) carry only the algo name; map it to the
# network head the trainer used so they keep loading with flat defaults
_DEFAULT_HEADS = {
    "dqn": "q",
    "apex_dqn": "dueling",
    "ppo": "actor_critic",
    "a2c": "actor_critic",
    "impala": "actor_critic",
}


def _n_actions(head: str, params) -> int:
    """The output width of a parameter tree's head (its last layer)."""
    tree = params["head"] if isinstance(params, dict) and "enc" in params else params
    if head == "dueling":
        tree = tree["a"]
    elif head == "actor_critic":
        tree = tree["pi"]
    return int(tree[-1]["w"].shape[1])


def load_policy(path: str, device="cuda") -> Tuple[ActFn, Dict[str, Any], EncoderConfig]:
    """Rebuild greedy acting from a checkpoint's embedded metadata, with the
    network on ``device`` (``"cuda"`` raises without a card).

    Returns ``(act, meta, encoder_config)``.  The metadata (head, encoder
    config, action space — see ``encoders.checkpoint_meta``) removes all
    guessing; pre-metadata checkpoints fall back to the per-algo default
    head and the flat encoder, which is exactly what produced them.  The
    params are the JAX package's tree, so checkpoints of either package
    load."""
    d = load_checkpoint(path)
    algo, meta = d["algo"], d["meta"]
    head = meta.get("head") or _DEFAULT_HEADS.get(algo)
    if head is None:
        raise ValueError(f"unknown algo {algo!r} in {path}")
    enc_cfg = (EncoderConfig.from_dict(meta["encoder"])
               if meta.get("encoder") else EncoderConfig()).resolved()
    net = build_network(head, enc_cfg, _n_actions(head, d["params"]), device)
    module = net.init()
    module.load_state_dict(params_from_numpy(d["params"], net.device))
    return make_masked_act(make_score_fn(net))([module]), meta, enc_cfg


def make_act_from_checkpoint(path: str, device="cuda") -> ActFn:
    """Rebuild the greedy act() for a saved TrainResult checkpoint."""
    return load_policy(path, device)[0]


class LoopTuner:
    """Tunes contractions and persists schedules for the kernel layer."""

    def __init__(
        self,
        backend: Any = "torch",
        registry: Optional[ScheduleRegistry] = None,
        policy: str = "search",  # "policy" | "search" | "default"
        search_budget_s: float = 10.0,
        surrogate: Optional[str] = "off",  # "auto" | "off": cost-model-guided search
        *,
        act: Optional[ActFn] = None,
        episode_len: int = 10,
        featurizer=None,  # None -> env default (flat); set to match the act
        device="cuda",  # where the surrogate's network runs
        cache_dir: Optional[str] = None,  # persistent kernel store
    ):
        if policy not in ("policy", "search", "default"):
            raise ValueError(
                f"policy must be 'policy', 'search' or 'default', got {policy!r}")
        surrogate = "off" if surrogate is None else surrogate
        if surrogate not in ("auto", "off"):
            raise ValueError(f"surrogate must be 'auto' or 'off', got {surrogate!r}")
        self.act = act
        # any registered backend name ("torch" | "tpu" | "numpy" | "auto" |
        # "remote") or a ready Backend instance — see
        # core.backend.make_backend.  cache_dir (the kernel store the card
        # executor's libraries build through; the others tolerate it) can
        # only be applied when the tuner builds the backend
        self.backend = (make_backend(backend, cache_dir=cache_dir)
                        if cache_dir is not None and isinstance(backend, str)
                        else make_backend(backend))
        self.cache_dir = cache_dir
        self.backend_kind = backend_name(self.backend)
        self.registry = registry if registry is not None else ScheduleRegistry()
        self.episode_len = episode_len
        # a policy tuner without an act falls back to search, as in the JAX
        # package
        self.policy = policy if act is not None or policy != "policy" else "search"
        self.search_budget_s = search_budget_s
        self.featurizer = featurizer
        self.surrogate = surrogate
        self.device = device
        # the analytical TPU model tunes over MXU-aligned splits; every
        # measured executor, the card's included, over the paper's CPU ladder
        splits = TPU_SPLITS if self.backend_kind == "tpu" else CPU_SPLITS
        self.actions = build_action_space(splits)
        # one evaluation cache for every env this tuner creates, so repeated
        # tune() calls and tune_many() lanes amortize each other
        self.cache = ScheduleCache()
        # reward calibration (set by from_checkpoint): when not None, every
        # env this tuner builds normalizes rewards by this peak instead of
        # re-timing the live backend's — see _calibrate
        self.peak_override: Optional[float] = None
        self.calibration: Dict[str, Any] = {"mode": "live"}
        # one learned cost model shared by every search-mode tune() call —
        # built lazily against the first env's featurizer, then warmed by
        # each tuned benchmark's measurements (see _scorer_for)
        self._scorer: Optional[SurrogateScorer] = None
        # registry-record provenance: where did this schedule come from
        # (from_checkpoint overwrites with the checkpoint identity)
        self.provenance: Dict[str, Any] = {"policy": self.policy}

    @classmethod
    def from_checkpoint(cls, path: str, backend: Optional[str] = None,
                        device="cuda", **kw) -> "LoopTuner":
        """Rebuild the exact tuning setup a checkpoint was trained with: the
        network (head + encoder, on ``device``), the matching observation
        featurizer, the trained action space, and — unless overridden — the
        backend that produced the training reward signal, all from the
        embedded metadata.  A checkpoint of the JAX package's ``"jax"``
        executor names a backend the port does not register: without a
        ``backend=`` override that raises the registry's error."""
        act, meta, enc_cfg = load_policy(path, device)
        kw.setdefault("surrogate", meta.get("surrogate", "auto"))
        kw.setdefault("policy", "policy")
        if backend is None:
            # pre-backend-metadata checkpoints were all trained on the
            # analytical model, which is also the JAX package's default
            backend = meta.get("backend") or "tpu"
        tuner = cls(backend, act=act, device=device, **kw)
        tuner.featurizer = get_encoder(enc_cfg.kind).featurizer(enc_cfg)
        if meta.get("actions") is not None:
            # the full recorded list, not just the split ladder: index i must
            # mean exactly what the policy's output unit i was trained on
            tuner.actions = actions_from_names(meta["actions"])
        tuner._calibrate(meta)
        tuner.provenance = {"policy": "policy", "checkpoint": path,
                            "algo": meta.get("algo"),
                            "trained_backend": meta.get("backend")}
        return tuner

    def _calibrate(self, meta: Dict[str, Any]) -> None:
        """Cross-backend reward calibration.

        Rewards are normalized GFLOPS deltas, ``(g' - g) / peak``.  The
        policy's value scale is therefore tied to the ``peak`` its trainer
        recorded:

        * same executor as training — reuse the *recorded* peak, so the
          reward scale is exactly training's (``"recorded"``);
        * different executor — normalize by the live executor's own peak
          and surface the recorded/live ratio (``"cross-backend"``);
        * legacy checkpoint with no recorded peak — warn once and fall
          back to the live backend's ``peak()`` (``"legacy-live-peak"``).
        """
        global _WARNED_NO_PEAK
        recorded = meta.get("peak")
        trained_on = meta.get("backend")
        if recorded is None:
            if not _WARNED_NO_PEAK:
                _WARNED_NO_PEAK = True
                warnings.warn(
                    "checkpoint metadata records no training-time peak(); "
                    "rewards will be normalized by the live backend's peak "
                    "— the reward scale may differ from training "
                    "(re-train or re-save to embed `peak` in meta)",
                    stacklevel=3)
            self.peak_override = None
            self.calibration = {"mode": "legacy-live-peak",
                                "trained_on": trained_on}
        elif trained_on == self.backend_kind:
            self.peak_override = float(recorded)
            self.calibration = {"mode": "recorded",
                                "trained_on": trained_on,
                                "peak": float(recorded)}
        else:
            live = self.backend.peak()
            self.peak_override = None
            self.calibration = {"mode": "cross-backend",
                                "trained_on": trained_on,
                                "recorded_peak": float(recorded),
                                "live_peak": float(live),
                                "scale_ratio": float(recorded) / float(live)}

    # ------------------------------------------------------------------

    def _env_for(self, bench: Contraction) -> LoopTuneEnv:
        return LoopTuneEnv([bench], self.backend, actions=self.actions,
                           episode_len=self.episode_len, cache=self.cache,
                           featurizer=self.featurizer,
                           peak=self.peak_override)

    def _scorer_for(self, env: LoopTuneEnv) -> Optional[SurrogateScorer]:
        """The tuner-lifetime surrogate scorer (None when disabled).  Shared
        across tune() calls so the cost model learned on one contraction
        pre-ranks the next one's frontiers."""
        if self.surrogate == "off":
            return None
        if self._scorer is None:
            self._scorer = SurrogateScorer.for_env(env, device=self.device)
        return self._scorer

    def _record(self, kernel: str, bench: Contraction, gflops: float,
                actions: List[str], nest, dtype: str) -> Dict[str, Any]:
        """Registry write with full v2 record context: executor + hardware
        keying, the measurement spread the variance guardrails recorded for
        the winning schedule, and tuner provenance."""
        dims = tuple(bench.iter_sizes.values())
        measurement = None
        mfor = getattr(self.backend, "measurement_for", None)
        if mfor is not None and nest is not None:
            measurement = mfor(nest)
        # stamp the *measuring* host: with a remote farm the timing ran on
        # the farm's hardware, and the record key must say so — local
        # current_hardware() (registry.put's default) only when the backend
        # has no better answer (or the farm degraded to local fallback)
        mhw = getattr(self.backend, "measured_hardware", None)
        hardware = mhw() if mhw is not None else None
        mbn = getattr(self.backend, "measured_backend_name", None)
        backend = (mbn() if mbn is not None else None) or self.backend_kind
        self.registry.put(kernel, dims, gflops, list(actions), nest,
                          dtype=dtype, backend=backend,
                          hardware=hardware,
                          measurement=measurement,
                          provenance=self.provenance)
        return dict(self.registry.get(kernel, dims, dtype))

    @staticmethod
    def _typed(bench: Contraction, dtype: str) -> Contraction:
        """The contraction relabelled with its record's dtype, so a measured
        backend times its rewards on operands of that type."""
        return bench if bench.dtype == dtype else dataclasses.replace(bench, dtype=dtype)

    def tune(self, bench: Contraction, kernel: str = "mm", *,
             dtype: str = "float32", budget_s: Optional[float] = None,
             max_evals: Optional[int] = None) -> Dict[str, Any]:
        """Tune one contraction; returns the registry entry.

        The rewards are timed at ``dtype``: the contraction is relabelled
        with it, so a measured backend times its operands in that type (the
        card's kernel on bf16 for a ``"bfloat16"`` record) and the shared
        evaluation cache keeps each type's measurements apart."""
        t0 = time.perf_counter()
        budget_s = budget_s if budget_s is not None else self.search_budget_s
        bench = self._typed(bench, dtype)
        with span("tuner.tune", policy=self.policy) as sp:
            if sp:
                sp.set(key=ScheduleRegistry.key(
                    kernel, tuple(bench.iter_sizes.values()), dtype))
            env = self._env_for(bench)
            if self.policy == "policy":
                best_g, actions, nest = greedy_rollout(env, self.act, 0)
            elif self.policy == "search":
                scorer = self._scorer_for(env)
                with span("search.greedy") as ss:
                    res = greedy_search(env, 0, lookahead=1, budget_s=budget_s,
                                        max_evals=max_evals, surrogate=scorer)
                    ss.set(evals=res.n_evals)
                with span("search.beam") as ss:
                    res2 = beam_search(env, 0, width=4, order="dfs",
                                       budget_s=budget_s, max_evals=max_evals,
                                       surrogate=scorer)
                    ss.set(evals=res2.n_evals)
                res = res2 if res2.best_gflops > res.best_gflops else res
                best_g, actions, nest = res.best_gflops, res.actions, res.best_nest
            else:  # default / untuned
                env.reset(0)
                best_g, actions, nest = env.current_gflops, [], env.nest.clone()
            # bank speculative measure-ahead work: anything the searches put
            # in flight on an async farm but never collected still lands in
            # the shared cache (a later tune() call may hit it for free)
            self.cache.drain_ahead()
            entry = self._record(kernel, bench, best_g, list(actions), nest, dtype)
        entry["tune_time_s"] = time.perf_counter() - t0
        entry["base_gflops"] = env.initial_gflops
        return entry

    def tune_matmul(self, m: int, k: int, n: int) -> Dict[str, Any]:
        return self.tune(matmul_benchmark(m, k, n), kernel="mm")

    def tune_many(self, benches: Sequence[Contraction], kernel: str = "mm",
                  vec_size: int = 16, *,
                  weights: Optional[Sequence[float]] = None,
                  dtypes: Optional[Sequence[str]] = None,
                  budget_s: Optional[float] = None,
                  eval_budget: Optional[int] = None,
                  on_entry: Optional[Callable[[int, Dict[str, Any]], None]]
                  = None) -> List[Dict[str, Any]]:
        """Tune many contractions.

        With a trained policy, the contractions become lanes of a
        :class:`VecLoopTuneEnv` (chunks of ``vec_size``), each relabelled
        with its record's dtype, and the policy is rolled out greedily over
        all of them at once — one batched act() and one batched backend call
        per step.  Search/default policies tune one contraction after
        another.

        ``weights`` (normalized internally) split a *total* search budget —
        ``budget_s`` seconds and optionally ``eval_budget`` backend
        evaluations — across the contractions, so callers can spend the
        budget where the executed FLOPs are.  Without weights each
        contraction gets the tuner's per-bench default.  ``on_entry(i,
        entry)`` fires as soon as contraction ``i``'s entry is recorded.
        """
        dtypes = list(dtypes) if dtypes is not None else ["float32"] * len(benches)
        if self.policy != "policy":
            if weights is None:
                share = [None] * len(benches)
            else:
                total = float(sum(weights)) or 1.0
                share = [w / total for w in weights]
            total_s = (budget_s if budget_s is not None
                       else self.search_budget_s * len(benches))
            entries = []
            for i, (b, dt, w) in enumerate(zip(benches, dtypes, share)):
                if w is None:
                    entry = self.tune(b, kernel, dtype=dt)
                else:
                    evals = (max(2, int(round(eval_budget * w)))
                             if eval_budget is not None else None)
                    entry = self.tune(b, kernel, dtype=dt,
                                      budget_s=total_s * w, max_evals=evals)
                entries.append(entry)
                if on_entry is not None:
                    on_entry(i, entry)
            return entries
        entries = []
        for lo in range(0, len(benches), vec_size):
            chunk = [self._typed(b, dt) for b, dt in
                     zip(benches[lo:lo + vec_size], dtypes[lo:lo + vec_size])]
            t0 = time.perf_counter()
            venv = VecLoopTuneEnv(chunk, self.backend, n_envs=len(chunk),
                                  actions=self.actions,
                                  episode_len=self.episode_len,
                                  cache=self.cache,
                                  featurizer=self.featurizer,
                                  peak=self.peak_override)
            best_g, names, nests = greedy_rollout_vec(
                venv, self.act, benchmark_indices=list(range(len(chunk))))
            self.cache.drain_ahead()
            per_bench_s = (time.perf_counter() - t0) / len(chunk)
            for i, bench in enumerate(chunk):
                entry = self._record(kernel, bench, float(best_g[i]),
                                     list(names[i]), nests[i], bench.dtype)
                entry["tune_time_s"] = per_bench_s
                entry["base_gflops"] = float(venv.initial_gflops[i])
                entries.append(entry)
                if on_entry is not None:
                    on_entry(lo + i, entry)
        return entries

    def stats(self) -> Dict[str, Any]:
        """Observability: tuned-schedule count, the shared evaluation
        cache's counters, the backend's lowering and measurement counters,
        the surrogate scorer's and the active reward calibration."""
        ms = getattr(self.backend, "measure_stats", None)
        cs = getattr(self.backend, "compile_stats", None)
        measurement = {"settings": measure_settings(self.backend),
                       **(ms() if ms is not None else {})}
        return {
            "policy": self.policy,
            "backend": self.backend_kind,
            "registry_size": len(self.registry),
            "cache": self.cache.stats(),
            "compile": (cs() if cs is not None
                        else {"compile_misses": 0, "compile_hits": 0,
                              "compile_s": 0.0}),
            # stable shape regardless of whether a scorer exists yet
            "surrogate": {"mode": self.surrogate,
                          **(self._scorer.stats()
                             if self._scorer is not None else {})},
            # farm counters (requests/retries/reconnects/degraded/farm_rtt)
            # ride under ["farm"]
            "measurement": measurement,
            "calibration": dict(self.calibration),
        }

    def save(self, path: str) -> None:
        self.registry.save(path)
