"""LoopTuner — the framework-facing auto-tuning service.

Tunes contractions by search under a budget and persists the schedules in a
:class:`ScheduleRegistry`, lowered to a block shape and grid order that the
tiled-matmul kernel then runs with at serve time::

    tuner = LoopTuner(policy="search", backend="torch")
    entry = tuner.tune(matmul_benchmark(1024, 2048, 2048))
    # -> registry maps mm:1024x2048x2048 -> {block, grid_order, gflops}

``policy="search"`` runs greedy and beam search and keeps the better result;
``policy="default"`` records the untuned nest.  A trained policy
(``policy="policy"``, :meth:`LoopTuner.from_checkpoint`) comes with the
policy slice (ROADMAP.md) and raises ``NotImplementedError`` until then.

Defaults differ from the JAX package's on purpose: ``backend="torch"`` (the
card executor; JAX: ``"tpu"``) and ``surrogate="off"`` (JAX: ``"auto"``,
the learned surrogate, not ported yet).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .actions import CPU_SPLITS, TPU_SPLITS, build_action_space
from .backend import backend_name, make_backend
from .env import LoopTuneEnv
from .loop_ir import Contraction, matmul_benchmark
from .measure import measure_settings
from .registry import ScheduleRegistry
from .schedule_cache import ScheduleCache
from .search import beam_search, check_surrogate, greedy_search

_NOT_PORTED = ("tuning with a trained policy is not ported yet (ROADMAP.md, "
               "policy path); use policy='search' or policy='default'")


class LoopTuner:
    """Tunes contractions and persists schedules for the kernel layer."""

    def __init__(
        self,
        backend: Any = "torch",
        registry: Optional[ScheduleRegistry] = None,
        policy: str = "search",  # "search" | "default" ("policy": not yet)
        search_budget_s: float = 10.0,
        surrogate: Optional[str] = "off",
    ):
        if policy == "policy":
            raise NotImplementedError(_NOT_PORTED)
        if policy not in ("search", "default"):
            raise ValueError(f"policy must be 'search' or 'default', got {policy!r}")
        check_surrogate(surrogate)  # NotImplementedError unless None / "off"
        self.surrogate = "off"
        # any registered backend name ("torch" | "tpu" | "numpy" | "auto")
        # or a ready Backend instance — see core.backend.make_backend
        self.backend = make_backend(backend)
        self.backend_kind = backend_name(self.backend)
        self.registry = registry if registry is not None else ScheduleRegistry()
        self.policy = policy
        self.search_budget_s = search_budget_s
        # the analytical TPU model tunes over MXU-aligned splits; every
        # measured executor, the card's included, over the paper's CPU ladder
        splits = TPU_SPLITS if self.backend_kind == "tpu" else CPU_SPLITS
        self.actions = build_action_space(splits)
        # one evaluation cache for every env this tuner creates, so repeated
        # tune() calls amortize each other
        self.cache = ScheduleCache()
        # registry-record provenance: where did this schedule come from
        self.provenance: Dict[str, Any] = {"policy": self.policy}

    @classmethod
    def from_checkpoint(cls, path: str, backend: Optional[str] = None,
                        **kw) -> "LoopTuner":
        raise NotImplementedError(_NOT_PORTED)

    # ------------------------------------------------------------------

    def _env_for(self, bench: Contraction) -> LoopTuneEnv:
        return LoopTuneEnv([bench], self.backend, actions=self.actions,
                           cache=self.cache)

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
        self.registry.put(kernel, dims, gflops, list(actions), nest,
                          dtype=dtype, backend=self.backend_kind,
                          measurement=measurement,
                          provenance=self.provenance)
        return dict(self.registry.get(kernel, dims, dtype))

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
        if bench.dtype != dtype:
            bench = dataclasses.replace(bench, dtype=dtype)
        env = self._env_for(bench)
        if self.policy == "search":
            res = greedy_search(env, 0, lookahead=1, budget_s=budget_s,
                                max_evals=max_evals)
            res2 = beam_search(env, 0, width=4, order="dfs",
                               budget_s=budget_s, max_evals=max_evals)
            res = res2 if res2.best_gflops > res.best_gflops else res
            best_g, actions, nest = res.best_gflops, res.actions, res.best_nest
        else:  # default / untuned
            env.reset(0)
            best_g, actions, nest = env.current_gflops, [], env.nest.clone()
        entry = self._record(kernel, bench, best_g, list(actions), nest, dtype)
        entry["tune_time_s"] = time.perf_counter() - t0
        entry["base_gflops"] = env.initial_gflops
        return entry

    def tune_matmul(self, m: int, k: int, n: int) -> Dict[str, Any]:
        return self.tune(matmul_benchmark(m, k, n), kernel="mm")

    def tune_many(self, benches: Sequence[Contraction], kernel: str = "mm", *,
                  weights: Optional[Sequence[float]] = None,
                  dtypes: Optional[Sequence[str]] = None,
                  budget_s: Optional[float] = None,
                  eval_budget: Optional[int] = None,
                  on_entry: Optional[Callable[[int, Dict[str, Any]], None]]
                  = None) -> List[Dict[str, Any]]:
        """Tune many contractions, one after another.

        ``weights`` (normalized internally) split a *total* search budget —
        ``budget_s`` seconds and optionally ``eval_budget`` backend
        evaluations — across the contractions, so callers can spend the
        budget where the executed FLOPs are.  Without weights each
        contraction gets the tuner's per-bench default.  ``on_entry(i,
        entry)`` fires as soon as contraction ``i``'s entry is recorded.
        """
        dtypes = list(dtypes) if dtypes is not None else ["float32"] * len(benches)
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

    def stats(self) -> Dict[str, Any]:
        """Observability: tuned-schedule count, the shared evaluation
        cache's counters, and the backend's lowering and measurement
        counters."""
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
            "surrogate": {"mode": self.surrogate},
            "measurement": measurement,
        }

    def save(self, path: str) -> None:
        self.registry.save(path)
