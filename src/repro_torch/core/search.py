"""Traditional search baselines (paper §V, Figs. 6/8/9/10).

* Greedy with lookahead L   — O(steps * |A|^L) evaluations
* Beam DFS / BFS width W    — O(W^steps), expansion order differs when the
                              time budget elapses before the full graph
* Random search             — uniform random action sequences

All searches share the environment's structure-keyed :class:`ScheduleCache`
(paper: "we implemented each search with caching to avoid repeating
evaluations of the same states") and a wall-clock budget.  Expansion is
batched: all children of a frontier node are scored through one
``Backend.evaluate_batch`` call (cache-deduped), so measurement cost is
amortized exactly like the vectorized RL rollouts.

Every search additionally accepts ``surrogate`` ("auto" | "off" | a shared
:class:`~repro_torch.core.surrogate.SurrogateScorer`): two-stage frontier
scoring where the learned cost model ranks the frontier and only the top
slice of cache misses is charged against the budget and measured for real
(``surrogate.py``).  Measured GFLOPS stream back into the model, which
re-fits periodically — evaluations saved compound as the search proceeds.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .actions import apply_action, is_legal
from .env import LoopTuneEnv
from .loop_ir import LoopNest
from .surrogate import SurrogateScorer, make_surrogate


@dataclass
class SearchResult:
    name: str
    best_gflops: float
    base_gflops: float
    actions: List[str]
    n_evals: int
    time_s: float
    best_nest: Optional[LoopNest] = None
    # best-so-far after each search step (paper Fig. 10 upper)
    trace: List[Tuple[float, float]] = field(default_factory=list)  # (t, gflops)
    # ScheduleCache traffic attributable to this search (delta of the shared
    # cache's counters): how much of the frontier was amortized vs measured
    cache_hits: int = 0
    cache_misses: int = 0
    # measurement-guardrail traffic attributable to this search (delta of
    # the backend's counters; zero on deterministic backends): how many
    # measurements escalated repeats, and how many stayed noisy anyway
    n_escalated: int = 0
    n_noisy: int = 0
    # compile accounting attributable to this search (delta of the compiled
    # backend's ledger; zero on backends with no compile step): wall-clock
    # spent tracing, executables served without a trace (in-memory +
    # persistent-store), and actual traces performed
    compile_s: float = 0.0
    compile_hits: int = 0
    compile_misses: int = 0

    @property
    def speedup(self) -> float:
        if self.best_gflops == self.base_gflops:
            # covers the zero-eval budget case (nothing measured, best is the
            # base) without manufacturing a huge ratio from a tiny base
            return 1.0
        return self.best_gflops / max(self.base_gflops, 1e-9)

    # two-stage scoring observability (None when the search ran without a
    # surrogate): dataset size, fit count, frontier candidates skipped
    surrogate_stats: Optional[Dict[str, Any]] = None

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of this search's cache traffic served from cache.
        Well-defined (0.0) when the search spent no evaluations at all —
        e.g. a ``max_evals=0`` budget exhausted on the first frontier."""
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0


class _Budget:
    def __init__(self, seconds: float, max_evals: Optional[int] = None):
        self.t0 = time.perf_counter()
        self.seconds = seconds
        self.max_evals = max_evals
        self.evals = 0

    def spend_eval(self) -> None:
        self.evals += 1

    def exhausted(self) -> bool:
        if self.max_evals is not None and self.evals >= self.max_evals:
            return True
        return time.perf_counter() - self.t0 > self.seconds

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0


def _eval(env: LoopTuneEnv, nest: LoopNest, budget: _Budget) -> float:
    key = nest.structure_key()
    cached = key in env.cache
    if not cached:
        if budget.exhausted():
            # never spend past the budget: an unmeasured state under an
            # exhausted budget scores -inf (unusable) instead of silently
            # pushing n_evals beyond max_evals
            return float("-inf")
        budget.spend_eval()
    return env.gflops(nest)


def _eval_batch(env: LoopTuneEnv, nests: Sequence[LoopNest],
                budget: _Budget) -> np.ndarray:
    """Score ``nests`` through one cached ``evaluate_batch`` call; the budget
    is charged once per deduped cache miss.  When ``max_evals`` is set the
    batch is truncated so the eval budget is never exceeded (mirroring the
    old per-child break) — the returned array may then be shorter than
    ``nests``.  The wall-clock budget is checked between batches, so it can
    overshoot by at most one frontier."""
    if budget.max_evals is not None:
        allowed = max(0, budget.max_evals - budget.evals)
        keep, misses = [], set()
        for n in nests:
            k = n.structure_key()
            if k in env.cache or k in misses:
                keep.append(n)
            elif len(misses) < allowed:
                misses.add(k)
                keep.append(n)
            else:
                break  # budget exhausted: later children stay unscored
        nests = keep
    misses_before = env.cache.misses
    gs = env.gflops_batch(nests)
    for _ in range(env.cache.misses - misses_before):
        budget.spend_eval()
    return gs


def _score_frontier(
    env: LoopTuneEnv,
    nests: Sequence[LoopNest],
    budget: _Budget,
    surrogate: Optional[SurrogateScorer] = None,
    root: bool = False,
    prune: bool = True,
) -> Tuple[List[int], np.ndarray]:
    """Two-stage frontier scoring.  Returns ``(indices, gflops)`` where
    ``gflops[j]`` is the *measured* score of ``nests[indices[j]]``.

    Stage 1 (cheap): the surrogate ranks the frontier and keeps cache hits
    plus the top slice of misses.  Stage 2 (real): the survivors go through
    one cached ``evaluate_batch`` call, charged against the budget (which may
    truncate the tail — dropped candidates simply stay unscored, and
    unscored candidates are never expanded).  Fresh measurements are fed
    back to the surrogate.  With ``surrogate=None`` stage 1 keeps everything;
    ``prune=False`` also keeps everything but still feeds the measurements
    back (greedy's full-frontier verification pass).
    """
    if surrogate is None:
        gs = _eval_batch(env, nests, budget)
        return list(range(len(gs))), gs
    # measure-ahead: put the frontier's cache-cold children in flight on an
    # async backend *before* ranking, so the surrogate's featurize+forward
    # pass overlaps farm measurement and stage 2 collects instead of
    # measuring cold.  Bounded by the client's in-flight window, and
    # collection is charged as the same cache miss a blocking evaluation
    # would be — search decisions (and tuned gflops) are identical, only
    # the stalls shrink.
    if getattr(env.backend, "can_measure_async", False):
        env.submit_eval(nests)
    order = (surrogate.select(env, nests, root=root) if prune
             else list(range(len(nests))))
    gs = _eval_batch(env, [nests[i] for i in order], budget)
    order = order[: len(gs)]
    surrogate.observe([nests[i] for i in order], gs)
    return order, gs


def _children(env: LoopTuneEnv, nest: LoopNest) -> List[Tuple[int, LoopNest]]:
    out = []
    for ai, act in enumerate(env.actions):
        if not is_legal(nest, act):
            continue
        child = nest.clone()
        apply_action(child, act)
        out.append((ai, child))
    return out


def _compile_counters(env: LoopTuneEnv) -> Tuple[float, int, int]:
    """Snapshot (compile_s, compile_hits, compile_misses) of the backend's
    compile ledger (zeros for backends with no compile step)."""
    stats = getattr(env.backend, "compile_stats", None)
    if stats is None:
        return (0.0, 0, 0)
    d = stats()
    return (d["compile_s"], d["compile_hits"], d["compile_misses"])


def _cache_counters(env: LoopTuneEnv) -> Tuple:
    """Snapshot (hits, misses, escalations, noisy, compile_s, compile_hits,
    compile_misses) of the env's shared ScheduleCache, the backend's
    measurement-guardrail counters, and its compile ledger (zero for
    deterministic backends, which have neither)."""
    return (env.cache.hits, env.cache.misses,
            getattr(env.backend, "n_escalations", 0),
            getattr(env.backend, "n_noisy", 0),
            *_compile_counters(env))


def _mk_result(name, env, base, best_g, best_seq, best_nest, budget, trace,
               cache0=(0, 0, 0, 0, 0.0, 0, 0), surrogate=None):
    h0, m0, e0, z0, cs0, ch0, cm0 = cache0
    cs1, ch1, cm1 = _compile_counters(env)
    return SearchResult(
        name=name,
        best_gflops=best_g,
        base_gflops=base,
        actions=[env.actions[a].name for a in best_seq],
        n_evals=budget.evals,
        time_s=budget.elapsed(),
        best_nest=best_nest,
        trace=trace,
        cache_hits=env.cache.hits - h0,
        cache_misses=env.cache.misses - m0,
        n_escalated=getattr(env.backend, "n_escalations", 0) - e0,
        n_noisy=getattr(env.backend, "n_noisy", 0) - z0,
        compile_s=round(cs1 - cs0, 4),
        compile_hits=ch1 - ch0,
        compile_misses=cm1 - cm0,
        surrogate_stats=surrogate.stats() if surrogate is not None else None,
    )


# ---------------------------------------------------------------------------
# Greedy with lookahead
# ---------------------------------------------------------------------------


def greedy_search(
    env: LoopTuneEnv,
    benchmark_idx: int,
    lookahead: int = 1,
    steps: int = 10,
    budget_s: float = 60.0,
    max_evals: Optional[int] = None,
    surrogate=None,
) -> SearchResult:
    cache0 = _cache_counters(env)
    env.reset(benchmark_idx)
    base = env.current_gflops
    # the scorer (a network on its device) is built before the budget clock
    # starts: building the cost model is setup, not search time
    scorer = make_surrogate(surrogate, env)
    budget = _Budget(budget_s, max_evals)
    nest = env.nest.clone()
    cur_g = base
    best_g, best_nest, best_seq = base, nest.clone(), []
    seq: List[int] = []
    trace = [(0.0, base)]

    def expand(n: LoopNest, depth: int, sc,
               prune: bool = True) -> Tuple[float, List[int]]:
        """Best achievable gflops within `depth` more actions (dfs)."""
        g_here = _eval(env, n, budget)
        if depth == 0 or budget.exhausted():
            return g_here, []
        kids = _children(env, n)
        # two-stage frontier scoring: one batched backend call for the kept
        # slice; only scored children are expanded (unscored ones were either
        # surrogate-pruned or out of budget), and the recursion below then
        # hits the cache for each scored child's own evaluation.  The ROOT
        # frontier (depth == lookahead) is greedy's per-step commitment, so
        # it gets the scorer's gentler ``root_keep_frac`` prune; the
        # exponentially larger lookahead levels take the full prune.
        kept, _ = _score_frontier(env, [child for _, child in kids],
                                  budget, sc, root=depth == lookahead,
                                  prune=prune)
        best, bseq = g_here, []
        for j in kept:
            ai, child = kids[j]
            g_c, s_c = expand(child, depth - 1, sc, prune)
            if g_c > best:
                best, bseq = g_c, [ai] + s_c
            if budget.exhausted():
                break
        return best, bseq

    for _ in range(steps):
        if budget.exhausted():
            break
        g_best, sub = expand(nest, lookahead, scorer)
        if ((not sub or g_best <= cur_g + 1e-12)
                and scorer is not None and scorer.active
                and not budget.exhausted()):
            # the surrogate claims a local optimum — greedy would terminate,
            # so verify against the FULL frontier before stopping (children
            # the surrogate kept are cache hits now; only the pruned
            # remainder is paid for, and its measurements feed the model the
            # exact frontier it just mis-ranked).  The surrogate can never
            # end a greedy search earlier than measured search would.
            g_best, sub = expand(nest, lookahead, scorer, prune=False)
        if not sub or g_best <= cur_g + 1e-12:
            break  # greedy terminates when no better state within lookahead
        ai = sub[0]
        apply_action(nest, env.actions[ai])
        seq.append(ai)
        ahead = (getattr(env.backend, "can_prepare", False)
                 or getattr(env.backend, "can_measure_async", False))
        if ahead:
            # compile-ahead + measure-ahead: the next step's root frontier
            # (this node's children) goes in flight on the farm while the
            # committed state evaluates below and the next expand() ranks
            # its frontier — the search never stalls on work it could have
            # started a step earlier.  The card executor has nothing to
            # compile ahead (a lowered schedule is a block shape), so only
            # a farm client takes this branch there
            next_frontier = [child for _, child in _children(env, nest)]
            env.prepare_eval(next_frontier)
            env.submit_eval(next_frontier)
        cur_g = _eval(env, nest, budget)
        if cur_g > best_g:
            best_g, best_nest, best_seq = cur_g, nest.clone(), list(seq)
        trace.append((budget.elapsed(), best_g))
    return _mk_result(f"greedy{lookahead}", env, base, best_g, best_seq,
                      best_nest, budget, trace, cache0, scorer)


# ---------------------------------------------------------------------------
# Beam search (DFS / BFS expansion)
# ---------------------------------------------------------------------------


def beam_search(
    env: LoopTuneEnv,
    benchmark_idx: int,
    width: int = 2,
    depth: int = 10,
    order: str = "dfs",
    budget_s: float = 60.0,
    max_evals: Optional[int] = None,
    surrogate=None,
) -> SearchResult:
    cache0 = _cache_counters(env)
    env.reset(benchmark_idx)
    base = env.current_gflops
    # the scorer is built before the budget clock starts (setup, not search)
    scorer = make_surrogate(surrogate, env)
    budget = _Budget(budget_s, max_evals)
    root = env.nest.clone()
    best_g, best_nest, best_seq = base, root.clone(), []
    trace = [(0.0, base)]
    visited: Dict[Tuple, float] = {}

    def ranked_children(n: LoopNest) -> List[Tuple[float, int, LoopNest]]:
        fresh, seen_here = [], set()
        for ai, child in _children(env, n):
            k = child.key()  # cursor-aware: moves reach distinct states
            if k in visited or k in seen_here:
                continue  # already expanded: costs no budget at all
            seen_here.add(k)
            fresh.append((ai, child, k))
        if not fresh:
            return []
        # two-stage scoring of the node's frontier in one batched call
        # (surrogate-pruned or out-of-budget children stay unvisited)
        kept, gs = _score_frontier(env, [child for _, child, _ in fresh],
                                   budget, scorer)
        scored = []
        for j, g in zip(kept, gs):
            ai, child, k = fresh[j]
            g = float(g)
            visited[k] = g
            scored.append((g, ai, child))
        scored.sort(key=lambda t: -t[0])
        return scored[:width]

    def note(g: float, n: LoopNest, seq: List[int]) -> None:
        nonlocal best_g, best_nest, best_seq
        if g > best_g:
            best_g, best_nest, best_seq = g, n.clone(), list(seq)
        trace.append((budget.elapsed(), best_g))

    if order == "dfs":

        def dfs(n: LoopNest, seq: List[int], d: int) -> None:
            if d == 0 or budget.exhausted():
                return
            for g, ai, child in ranked_children(n):
                note(g, child, seq + [ai])
                dfs(child, seq + [ai], d - 1)
                if budget.exhausted():
                    return

        dfs(root, [], depth)
    else:  # bfs: complete each layer before going deeper
        frontier: List[Tuple[LoopNest, List[int]]] = [(root, [])]
        for _ in range(depth):
            if budget.exhausted() or not frontier:
                break
            # gather the ENTIRE layer's fresh children and score them through
            # one two-stage call: the surrogate ranks the full layer frontier
            # (not per-node slices), so keep_frac bites even when each node
            # contributes only a few children
            cand: List[Tuple[int, LoopNest, Tuple, List[int], int]] = []
            seen_layer = set()
            for pi, (n, seq) in enumerate(frontier):
                for ai, child in _children(env, n):
                    k = child.key()  # cursor-aware: moves reach distinct states
                    if k in visited or k in seen_layer:
                        continue  # already expanded: costs no budget at all
                    seen_layer.add(k)
                    cand.append((ai, child, k, seq, pi))
            if not cand:
                break
            kept, gs = _score_frontier(env, [c[1] for c in cand],
                                       budget, scorer)
            # beam semantics as before layer-batching: each parent node
            # contributes at most its top `width` children, then the global
            # top width^2 bounds the next frontier
            per_parent: Dict[int, List[Tuple[float, LoopNest, List[int]]]] = {}
            for j, g in zip(kept, gs):
                ai, child, k, seq, pi = cand[j]
                g = float(g)
                visited[k] = g
                note(g, child, seq + [ai])
                per_parent.setdefault(pi, []).append((g, child, seq + [ai]))
            nxt: List[Tuple[float, LoopNest, List[int]]] = []
            for kids in per_parent.values():
                kids.sort(key=lambda t: -t[0])
                nxt.extend(kids[:width])
            nxt.sort(key=lambda t: -t[0])
            frontier = [(n, s) for _, n, s in nxt[: width * width]]
            if frontier and (getattr(env.backend, "can_prepare", False)
                             or getattr(env.backend, "can_measure_async",
                                        False)):
                # compile-ahead + measure-ahead: the surviving beam's
                # children are the next layer's frontier — put them in
                # flight on the farm now, so the layer boundary overlaps
                # with child generation and surrogate ranking instead of
                # stalling on blocking round-trips
                next_layer = [child for n, _ in frontier
                              for _, child in _children(env, n)]
                env.prepare_eval(next_layer)
                env.submit_eval(next_layer)
    return _mk_result(f"beam{width}{order}", env, base, best_g, best_seq,
                      best_nest, budget, trace, cache0, scorer)


# ---------------------------------------------------------------------------
# Random search
# ---------------------------------------------------------------------------


def random_search(
    env: LoopTuneEnv,
    benchmark_idx: int,
    seq_len: int = 10,
    budget_s: float = 60.0,
    max_evals: Optional[int] = None,
    seed: int = 0,
    surrogate=None,
    n_probe: int = 4,
) -> SearchResult:
    """Uniform random action sequences.  With a surrogate, each step becomes
    two-stage: ``n_probe`` random candidate actions are drawn, the surrogate
    ranks their children, and only the best-predicted one is measured — the
    same one-real-eval-per-step cost, spent on a better-directed step.
    Without a surrogate the action draw is single-sample and bit-identical
    to the JAX package's for a fixed ``seed``."""
    cache0 = _cache_counters(env)
    env.reset(benchmark_idx)
    base = env.current_gflops
    # the scorer is built before the budget clock starts (setup, not search)
    scorer = make_surrogate(surrogate, env)
    budget = _Budget(budget_s, max_evals)
    rng = np.random.default_rng(seed)
    root = env.nest.clone()
    best_g, best_nest, best_seq = base, root.clone(), []
    trace = [(0.0, base)]
    while not budget.exhausted():
        nest = root.clone()
        seq: List[int] = []
        for _ in range(seq_len):
            legal = [ai for ai, a in enumerate(env.actions) if is_legal(nest, a)]
            if not legal:
                break
            if scorer is not None and scorer.active and len(legal) > 1:
                cand = rng.choice(legal, size=min(n_probe, len(legal)),
                                  replace=False)
                kids = []
                for ci in cand:
                    child = nest.clone()
                    apply_action(child, env.actions[int(ci)])
                    kids.append(child)
                ai = int(cand[int(np.argmax(scorer.model.predict(kids)))])
            else:
                ai = int(rng.choice(legal))
            apply_action(nest, env.actions[ai])
            seq.append(ai)
            g = _eval(env, nest, budget)
            if scorer is not None and np.isfinite(g):
                scorer.observe([nest], [g])
            if g > best_g:
                best_g, best_nest, best_seq = g, nest.clone(), list(seq)
            if budget.exhausted():
                break
        trace.append((budget.elapsed(), best_g))
    return _mk_result("random", env, base, best_g, best_seq, best_nest,
                      budget, trace, cache0, scorer)


# ---------------------------------------------------------------------------
# Suite runner (paper Fig. 8 grid)
# ---------------------------------------------------------------------------

SEARCHES = {
    "greedy1": lambda env, bi, **kw: greedy_search(env, bi, lookahead=1, **kw),
    "greedy2": lambda env, bi, **kw: greedy_search(env, bi, lookahead=2, **kw),
    "beam2dfs": lambda env, bi, **kw: beam_search(env, bi, width=2, order="dfs", **kw),
    "beam4dfs": lambda env, bi, **kw: beam_search(env, bi, width=4, order="dfs", **kw),
    "beam2bfs": lambda env, bi, **kw: beam_search(env, bi, width=2, order="bfs", **kw),
    "beam4bfs": lambda env, bi, **kw: beam_search(env, bi, width=4, order="bfs", **kw),
    "random": lambda env, bi, **kw: random_search(env, bi, **kw),
}


def run_all_searches(
    env: LoopTuneEnv,
    benchmark_idx: int,
    budget_s: float = 60.0,
    max_evals: Optional[int] = None,
    fresh_cache: bool = True,
    surrogate=None,
    backend=None,
) -> Dict[str, SearchResult]:
    """Run the full paper suite.  ``surrogate``: None/"off" (measured-only,
    the default), "auto" (each search trains its own cost model from
    scratch — fair per-search eval counts, like ``fresh_cache``), or a
    shared :class:`SurrogateScorer` (learning accumulates across searches).
    ``backend`` selects the reward executor by registry name
    ("numpy" | "torch" | "tpu" | "auto"; see ``core.backend.make_backend``) —
    the suite then runs on a sibling of ``env`` wired to that executor
    (fresh evaluation cache unless the executor is unchanged)."""
    if backend is not None:
        env = env.with_backend(backend)
    out = {}
    for name, fn in SEARCHES.items():
        if fresh_cache:
            env.clear_cache()  # fair per-search eval counts / times
        out[name] = fn(env, benchmark_idx, budget_s=budget_s,
                       max_evals=max_evals, surrogate=surrogate)
    return out
