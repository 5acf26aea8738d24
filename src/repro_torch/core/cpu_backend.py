"""Blocked NumPy executor — the container-local "LoopNest" analogue.

Executes a :class:`LoopNest` schedule *faithfully*: outer loop levels run as
Python loops in schedule order; the innermost suffix whose iteration volume
fits a vector capacity (a register-file/L1 stand-in, like LoopNest's register
tiling + AVX vectorization) is executed as one contiguous-slice einsum.
Timing therefore reflects schedule quality: good tilings yield few Python
iterations over large contiguous blocks; bad ones thrash.

Semantics: per-level trip counts clamp to the *remaining* extent of the
enclosing chunk (LoopTool's size/tail model), so every reachable schedule
computes exactly the reference einsum — property-tested in
``tests/test_property.py``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .loop_ir import Contraction, LoopLevel, LoopNest
from .measure import MeasuredBackend, MeasurementPolicy
from .schedule_cache import LRUCache

VEC_CAP_DEFAULT = 4096  # max elements enumerated by the vectorized suffix
INPUTS_CACHE_CAPACITY = 64  # per-contraction operand arrays kept hot


# ---------------------------------------------------------------------------
# Reference oracle
# ---------------------------------------------------------------------------

_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _einsum_expr(c: Contraction) -> str:
    its = list(c.iter_sizes)
    sym = {it: _LETTERS[i] for i, it in enumerate(its)}
    ins = [("".join(sym[i] for i in t.iterators)) for t in c.inputs()]
    out = "".join(sym[i] for i in c.out.iterators)
    return ",".join(ins) + "->" + out


def make_inputs(c: Contraction, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        t.name: rng.standard_normal(t.dims, dtype=np.float32) for t in c.inputs()
    }


def execute_reference(c: Contraction, arrays: Dict[str, np.ndarray]) -> np.ndarray:
    ops = [arrays[t.name] for t in c.inputs()]
    return np.einsum(_einsum_expr(c), *ops, optimize=True).astype(np.float32)


# ---------------------------------------------------------------------------
# Blocked executor
# ---------------------------------------------------------------------------


def _suffix_boundary(levels: List[LoopLevel], vec_cap: int) -> int:
    """Largest suffix of ``levels`` whose count-product is <= vec_cap."""
    vol = 1
    b = len(levels)
    while b > 0 and vol * levels[b - 1].count <= vec_cap:
        vol *= levels[b - 1].count
        b -= 1
    return b


def _nearest_outer_step(
    levels: List[LoopLevel], idx: int, iterator: str, full: int
) -> int:
    for j in range(idx - 1, -1, -1):
        if levels[j].iterator == iterator:
            return levels[j].step
    return full


def _run_section(
    levels: List[LoopLevel],
    c: Contraction,
    body,
    vec_cap: int,
) -> None:
    """Drive ``body(offsets, extents)`` over the blocked iteration space."""
    b = _suffix_boundary(levels, vec_cap)
    sizes = c.iter_sizes
    # Parent step (chunk size) for each python-side level, computed statically.
    parent = [
        _nearest_outer_step(levels, i, levels[i].iterator, sizes[levels[i].iterator])
        for i in range(b)
    ]
    # Block extent source per iterator: step of its innermost python-side level
    # (or the full dimension if it is entirely inside the vector suffix).
    block_parent: Dict[str, int] = {it: sizes[it] for it in sizes}
    for i in range(b):
        block_parent[levels[i].iterator] = levels[i].step

    offsets: Dict[str, int] = {it: 0 for it in sizes}

    def rec(i: int) -> None:
        if i == b:
            extents = {
                it: min(block_parent[it], sizes[it] - offsets[it]) for it in sizes
            }
            body(offsets, extents)
            return
        lv = levels[i]
        it = lv.iterator
        remaining = min(parent[i], sizes[it] - offsets[it])
        trips = -(-remaining // lv.step)  # ceil
        saved = offsets[it]
        for pos in range(trips):
            offsets[it] = saved + pos * lv.step
            rec(i + 1)
        offsets[it] = saved

    rec(0)


def execute(
    nest: LoopNest,
    arrays: Dict[str, np.ndarray],
    vec_cap: int = VEC_CAP_DEFAULT,
) -> np.ndarray:
    """Execute the schedule; returns the output tensor (after write-back)."""
    c = nest.contraction
    expr = _einsum_expr(c)
    acc = np.zeros(c.out.dims, dtype=np.float32)  # accumulator "T"
    ins = [arrays[t.name] for t in c.inputs()]

    def compute_body(off: Dict[str, int], ext: Dict[str, int]) -> None:
        slices = []
        for t in c.inputs():
            sl = tuple(
                slice(off[it], off[it] + ext[it]) for it in t.iterators
            )
            slices.append(arrays[t.name][sl])
        osl = tuple(slice(off[it], off[it] + ext[it]) for it in c.out.iterators)
        acc[osl] += np.einsum(expr, *slices)

    _run_section(nest.compute_loops, c, compute_body, vec_cap)

    # Write-back nest: copy the accumulator into the output buffer in the
    # scheduled traversal order (paper Fig. 4's write-back section).
    out = np.empty_like(acc)

    def wb_body(off: Dict[str, int], ext: Dict[str, int]) -> None:
        osl = tuple(slice(off[it], off[it] + ext[it]) for it in c.out.iterators)
        out[osl] = acc[osl]

    _run_section(nest.writeback_loops, c, wb_body, vec_cap)
    del ins
    return out


# ---------------------------------------------------------------------------
# Timing backend (the paper's reward source)
# ---------------------------------------------------------------------------


def estimated_slab_count(nest: LoopNest, vec_cap: int) -> float:
    """Relative execution-cost estimate ~ slab count: wall time of both the
    interpreter (one Python ``np.einsum`` per slab) and the compiled
    executor (one fused einsum + accumulator update per slab) is dominated
    by how many slabs the schedule leaves outside the vectorized suffix,
    not by FLOPs (which every schedule of a contraction shares).  Drives
    the worker pool's longest-first dispatch ordering."""
    from .loop_ir import level_trip_counts

    trips = level_trip_counts(nest)
    slabs = 1.0
    for section, lo in ((nest.compute_loops, 0),
                        (nest.writeback_loops, nest.n_compute)):
        b = _suffix_boundary(section, vec_cap)
        for i in range(b):
            slabs *= trips[lo + i]
    return slabs


# peak GFLOPS is a property of the machine + executor, constant within a
# process: memoized per (vec_cap, process) so env construction never pays
# repeated multi-repeat calibration timing
_PEAK_CACHE: Dict[int, float] = {}


class CPUMeasuredBackend(MeasuredBackend):
    """Measured-GFLOPS reward backend (paper §III-B) — a *pure executor*.

    Execution lives here (:meth:`run_once` runs one blocked traversal);
    warm-up, best-of-``repeats`` selection, variance guardrails and
    optional out-of-process pooling live in
    :class:`~repro_torch.core.measure.MeasuredBackend` /
    :class:`~repro_torch.core.measure.MeasurementPolicy` — the same LoopNest
    "exclude warm-up, take the fastest measurement" protocol as before,
    now with spread tracking and repeat escalation.
    """

    name = "numpy"

    def __init__(
        self,
        vec_cap: int = VEC_CAP_DEFAULT,
        repeats: Optional[int] = None,
        seed: int = 0,
        policy: Optional[MeasurementPolicy] = None,
        measure: str = "inproc",
        pool_workers: Optional[int] = None,
        isolated: bool = False,
        pool_timeout_s: Optional[float] = None,
    ):
        super().__init__(policy=policy, repeats=repeats, measure=measure,
                         pool_workers=pool_workers, isolated=isolated,
                         pool_timeout_s=pool_timeout_s)
        self.vec_cap = vec_cap
        self.seed = seed
        # LRU, not clear-all-on-overflow: evaluating a 65th contraction must
        # not throw away the 64 hot operand sets (the same eviction
        # discipline as ScheduleCache / CompiledKernelCache)
        self._inputs_cache: LRUCache = LRUCache(INPUTS_CACHE_CAPACITY)

    def _inputs(self, c: Contraction) -> Dict[str, np.ndarray]:
        return self._inputs_cache.get_or_create(
            c.name, lambda: make_inputs(c, self.seed))

    # -- executor surface (timing lives in MeasuredBackend) ------------------

    def run_once(self, nest: LoopNest) -> None:
        execute(nest, self._inputs(nest.contraction), self.vec_cap)

    def pool_spec(self) -> Tuple[str, Dict[str, Any], Optional[str]]:
        return "numpy", {"vec_cap": self.vec_cap, "seed": self.seed}, None

    def cost_hint(self, nest: LoopNest) -> float:
        return estimated_slab_count(nest, self.vec_cap)

    def peak(self) -> float:
        """Empirical peak GFLOPS: time a high-arithmetic-intensity kernel
        (paper: 'a series of kernels with high arithmetic intensity').
        Memoized per (vec_cap, process) — the calibration kernel is timed
        once, not once per backend instance."""
        peak = _PEAK_CACHE.get(self.vec_cap)
        if peak is None:
            n = 512
            a = np.random.default_rng(0).standard_normal((n, n), dtype=np.float32)
            b = np.random.default_rng(1).standard_normal((n, n), dtype=np.float32)
            a @ b  # warm-up
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                a @ b
                best = min(best, time.perf_counter() - t0)
            peak = 2 * n**3 / best / 1e9
            _PEAK_CACHE[self.vec_cap] = peak
        return peak
