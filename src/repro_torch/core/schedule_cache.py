"""Shared LRU caching: a generic :class:`LRUCache` plus the structure-keyed
:class:`ScheduleCache` for schedule evaluations.

The paper caches every state evaluation ("we implemented each search with
caching to avoid repeating evaluations of the same states"); previously that
cache lived as a private dict inside :class:`LoopTuneEnv` with
clear-everything-on-overflow eviction, and searches reached into
``env._cache`` directly.  :class:`ScheduleCache` makes it a first-class,
shareable component: true LRU eviction, hit/miss/eviction counters, and
batched lookup-or-evaluate that dedups within the batch and sends only the
misses to :meth:`Backend.evaluate_batch`.

:class:`LRUCache` is the shared eviction discipline — the same
bounded-recency policy also backs the measured backend's per-contraction
input arrays and the card executor's built schedule functions
(:class:`~repro_torch.core.torch_backend.CompiledKernelCache`), so no cache
in the evaluation path ever clears wholesale on overflow.

One cache instance can back many environments (scalar and vectorized lanes
alike), so a policy rollout, a search, and a tuner all amortize each other's
measurements.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from .loop_ir import LoopNest

DEFAULT_CAPACITY = 200_000


class LRUCache:
    """Bounded map with least-recently-used eviction and traffic counters.

    ``get`` refreshes recency; ``put`` evicts the coldest entries (one at a
    time, never clear-all) once ``capacity`` is exceeded.  Subclasses may
    override :meth:`on_evict` to release per-entry resources.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    # -- plain mapping surface ------------------------------------------------

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    def get(self, key: Hashable) -> Optional[Any]:
        """Value for ``key`` (refreshing recency), or None."""
        val = self._data.get(key)
        if val is not None:
            self._data.move_to_end(key)
        return val

    def peek(self, key: Hashable) -> Optional[Any]:
        """Value for ``key`` without refreshing recency or touching any
        counter — for advisory probes (compile-ahead filtering, dispatch
        hints) that must not perturb what the cache keeps warm."""
        return self._data.get(key)

    def put(self, key: Hashable, value: Any) -> None:
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.capacity:
            old_key, old_val = self._data.popitem(last=False)
            self.evictions += 1
            self.on_evict(old_key, old_val)

    def on_evict(self, key: Hashable, value: Any) -> None:
        """Eviction hook (default: nothing)."""

    def get_or_create(self, key: Hashable, factory: Callable[[], Any]) -> Any:
        """Cached value for ``key`` (counted as a hit), else ``factory()``
        stored and counted as a miss — the one place lookup bookkeeping
        lives, so every cache's ``stats()`` stays honest."""
        val = self.get(key)
        if val is not None:
            self.hits += 1
            return val
        self.misses += 1
        val = factory()
        self.put(key, val)
        return val

    def clear(self) -> None:
        self._data.clear()

    def invalidate(self, key: Hashable) -> bool:
        """Drop ``key`` so the next lookup re-creates it (used by the envs
        to force re-measurement of a noisy reward).  Returns whether the
        key was present."""
        if key in self._data:
            del self._data[key]
            self.invalidations += 1
            return True
        return False

    def entries(self) -> List[Tuple[Hashable, Any]]:
        """Snapshot of ``(key, value)`` pairs, oldest first, without touching
        recency."""
        return list(self._data.items())

    def stats(self) -> Dict[str, int]:
        return {
            "size": len(self._data),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
        }


class ScheduleCache(LRUCache):
    """LRU map from ``nest.structure_key()`` to evaluated GFLOPS.

    Besides lookup-or-evaluate, the cache is the **measure-ahead** join
    point for async backends (``can_measure_async``): :meth:`submit_eval`
    puts cache-cold structures in flight on the backend and parks the
    handle; any later :meth:`evaluate` / :meth:`evaluate_batch` that needs
    an in-flight key collects its group first.  Keeping the in-flight
    table *inside* the cache is what makes pipelining safe: a structure is
    either cached, in flight, or cold — it can never be measured twice by
    a speculative submit racing a blocking evaluation.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        super().__init__(capacity)
        # structure_key -> shared group dict {"backend", "handle", "keys"};
        # one submit_batch call resolves a whole group at once
        self._inflight: Dict[Hashable, Dict[str, Any]] = {}
        self.submitted_ahead = 0
        self.collected_ahead = 0

    # -- measure-ahead --------------------------------------------------------

    def inflight_size(self) -> int:
        return len(self._inflight)

    def submit_eval(self, backend, nests: Sequence[LoopNest]) -> int:
        """Measure-ahead hint: put cache-cold ``nests`` in flight on an
        async backend, deduped against the cache, the in-flight table and
        the batch itself.  Bounded by the backend's advisory
        ``async_capacity`` so the hint never blocks the caller on a full
        window.  Returns how many nests were submitted (0 for non-async
        backends — always safe to call)."""
        if not getattr(backend, "can_measure_async", False):
            return 0
        capacity = getattr(backend, "async_capacity", None)
        room = capacity() if capacity is not None else None
        if room == 0:
            return 0
        chunk = getattr(backend, "max_nests_per_request", None)
        limit = room * chunk if (room is not None and chunk) else None
        todo_keys: List[Hashable] = []
        todo_nests: List[LoopNest] = []
        for n in nests:
            k = n.structure_key()
            if k in self._data or k in self._inflight or k in todo_keys:
                continue
            todo_keys.append(k)
            todo_nests.append(n)
            if limit is not None and len(todo_nests) >= limit:
                break
        if not todo_nests:
            return 0
        group = {"backend": backend,
                 "handle": backend.submit_batch(todo_nests),
                 "keys": todo_keys}
        for k in todo_keys:
            self._inflight[k] = group
        self.submitted_ahead += len(todo_nests)
        return len(todo_nests)

    def _collect_inflight(self, keys: Sequence[Hashable]) -> None:
        """Resolve every in-flight group covering ``keys`` into the cache.
        Each landed key counts as a **miss** — it cost a real backend
        measurement, and budget accounting charges by the miss delta."""
        groups: List[Dict[str, Any]] = []
        seen = set()
        for k in keys:
            g = self._inflight.get(k)
            if g is not None and id(g) not in seen:
                seen.add(id(g))
                groups.append(g)
        for g in groups:
            vals = np.asarray(g["backend"].collect_batch(g["handle"]),
                              np.float64)
            for k, v in zip(g["keys"], vals):
                # a key invalidated (or re-submitted) while in flight must
                # not resurrect its stale value
                if self._inflight.get(k) is g:
                    del self._inflight[k]
                    self.put(k, float(v))
                    self.misses += 1
                    self.collected_ahead += 1

    def drain_ahead(self) -> int:
        """Collect every outstanding measure-ahead group (end-of-search
        cleanup, so speculative farm work still lands in the cache)."""
        n = len(self._inflight)
        self._collect_inflight(list(self._inflight))
        return n

    def invalidate(self, key: Hashable) -> bool:
        self._inflight.pop(key, None)
        return super().invalidate(key)

    def clear(self) -> None:
        self._inflight.clear()
        super().clear()

    def stats(self) -> Dict[str, int]:
        return {**super().stats(),
                "inflight": len(self._inflight),
                "submitted_ahead": self.submitted_ahead,
                "collected_ahead": self.collected_ahead}

    # -- lookup-or-evaluate ---------------------------------------------------

    def evaluate(self, backend, nest: LoopNest) -> float:
        """Cached ``backend.evaluate(nest)`` keyed by structure."""
        key = nest.structure_key()
        if key in self._inflight:
            self._collect_inflight([key])
        hit = self.get(key)
        if hit is not None:
            self.hits += 1
            return hit
        self.misses += 1
        val = float(backend.evaluate(nest))
        self.put(key, val)
        return val

    def evaluate_batch(self, backend, nests: Sequence[LoopNest]) -> np.ndarray:
        """Cached GFLOPS for each nest; misses are deduped by structure key
        and evaluated in one ``backend.evaluate_batch`` call.  Keys with a
        measure-ahead submission in flight are collected first, so a
        pipelined frontier never stalls on work it already started."""
        keys = [n.structure_key() for n in nests]
        if self._inflight:
            needed = [k for k in keys
                      if k in self._inflight and k not in self._data]
            if needed:
                self._collect_inflight(needed)
        out = np.empty(len(nests), dtype=np.float64)
        miss_keys: List[Hashable] = []
        miss_nests: List[LoopNest] = []
        miss_slots: Dict[Hashable, List[int]] = {}
        for i, (key, nest) in enumerate(zip(keys, nests)):
            hit = self.get(key)
            if hit is not None:
                self.hits += 1
                out[i] = hit
            elif key in miss_slots:
                miss_slots[key].append(i)
            else:
                self.misses += 1
                miss_slots[key] = [i]
                miss_keys.append(key)
                miss_nests.append(nest)
        if miss_nests:
            vals = np.asarray(backend.evaluate_batch(miss_nests), np.float64)
            for key, val in zip(miss_keys, vals):
                v = float(val)
                self.put(key, v)
                for i in miss_slots[key]:
                    out[i] = v
        return out
