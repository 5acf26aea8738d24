"""Loop-nest intermediate representation for LoopTune.

A *benchmark* is an einsum-like tensor contraction::

    C[m, n] += A[m, k] * B[k, n]        (optionally post(..) elementwise)

The IR mirrors LoopTool's model (paper Figs. 3-4):

* Each **loop level** is ``(iterator, count, step)``.  The index contributed
  by a level at position ``pos`` is ``pos * step``; the full index of an
  iterator is the sum over its levels.  The innermost level of every iterator
  has ``step == 1``.
* ``split(v)`` rewrites a level ``(it, S, st)`` into an outer level
  ``(it, ceil(S/v), st*v)`` (reported to the agent as ``size = S // v``,
  ``tail = S % v`` — the paper's features) plus a new inner level
  ``(it, v, st)`` inserted directly below.
* A nest has a **compute** section and a **write-back** section (the loops
  that copy the accumulator T into C).  The agent cursor walks both; swaps
  never cross the boundary.

Execution (``cpu_backend``) clamps indices at dimension bounds, so *any*
interleaving of levels is semantically valid — the property tests check every
reachable schedule against the einsum oracle.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Benchmark specification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor operand: name, ordered iterator names, concrete dims."""

    name: str
    iterators: Tuple[str, ...]
    dims: Tuple[int, ...]

    def __post_init__(self):
        if len(self.iterators) != len(self.dims):
            raise ValueError(
                f"{self.name}: {len(self.iterators)} iterators vs {len(self.dims)} dims"
            )

    def base_stride(self, iterator: str) -> int:
        """Row-major stride of ``iterator`` in this tensor (0 if absent)."""
        stride = 0
        if iterator in self.iterators:
            axis = self.iterators.index(iterator)
            stride = 1
            for d in self.dims[axis + 1 :]:
                stride *= d
        return stride


@dataclasses.dataclass(frozen=True)
class Contraction:
    """``out[...] = post(sum_k  lhs[...] * rhs[...])`` in named-iterator form.

    ``rhs`` may be None for unary ops (reduction / transpose / copy).
    """

    name: str
    out: TensorSpec
    lhs: TensorSpec
    rhs: Optional[TensorSpec]
    iter_sizes: Dict[str, int]  # iterator -> extent

    @property
    def reduce_iters(self) -> Tuple[str, ...]:
        """Iterators summed over (present in inputs, absent in output)."""
        out_its = set(self.out.iterators)
        its: List[str] = []
        for t in self.inputs():
            for it in t.iterators:
                if it not in out_its and it not in its:
                    its.append(it)
        return tuple(its)

    def inputs(self) -> Tuple[TensorSpec, ...]:
        return (self.lhs,) if self.rhs is None else (self.lhs, self.rhs)

    def tensors(self) -> Tuple[TensorSpec, ...]:
        return self.inputs() + (self.out,)

    def flops(self) -> int:
        """2 * prod(iter extents) for binary contraction, prod for unary."""
        vol = 1
        for s in self.iter_sizes.values():
            vol *= s
        return 2 * vol if self.rhs is not None else vol


def matmul_benchmark(m: int, k: int, n: int) -> Contraction:
    """``C[m,n] = A[m,k] @ B[k,n]`` — the paper's benchmark family."""
    return Contraction(
        name=f"mm_{m}_{k}_{n}",
        out=TensorSpec("C", ("m", "n"), (m, n)),
        lhs=TensorSpec("A", ("m", "k"), (m, k)),
        rhs=TensorSpec("B", ("k", "n"), (k, n)),
        iter_sizes={"m": m, "k": k, "n": n},
    )


def conv2d_benchmark(r: int, c: int, kh: int, kw: int) -> Contraction:
    """``O[r,c] = sum_{i,j} I[r+i, c+j] * W[i,j]`` linearized as strided access.

    We model the image access with iterators (r, c, i, j) where I's strides
    for r/i and c/j coincide — captured by giving I iterator axes (r, i, c, j)
    over a padded buffer.  Good enough for stride-histogram fidelity.
    """
    return Contraction(
        name=f"conv_{r}x{c}_{kh}x{kw}",
        out=TensorSpec("O", ("r", "c"), (r, c)),
        lhs=TensorSpec("I", ("r", "i", "c", "j"), (r, kh, c, kw)),
        rhs=TensorSpec("W", ("i", "j"), (kh, kw)),
        iter_sizes={"r": r, "c": c, "i": kh, "j": kw},
    )


def reduction_benchmark(r: int, c: int) -> Contraction:
    """``O[r] = sum_c I[r,c]``."""
    return Contraction(
        name=f"red_{r}x{c}",
        out=TensorSpec("O", ("r",), (r,)),
        lhs=TensorSpec("I", ("r", "c"), (r, c)),
        rhs=None,
        iter_sizes={"r": r, "c": c},
    )


def transpose_benchmark(r: int, c: int) -> Contraction:
    """``O[c,r] = I[r,c]``."""
    return Contraction(
        name=f"tr_{r}x{c}",
        out=TensorSpec("O", ("c", "r"), (c, r)),
        lhs=TensorSpec("I", ("r", "c"), (r, c)),
        rhs=None,
        iter_sizes={"r": r, "c": c},
    )


# ---------------------------------------------------------------------------
# Loop levels and nests
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoopLevel:
    """One loop in the nest: iterates ``count`` times with stride ``step``."""

    iterator: str
    count: int  # number of full iterations at this level (ceil semantics)
    step: int  # index stride per iteration

    def copy(self) -> "LoopLevel":
        return LoopLevel(self.iterator, self.count, self.step)


class LoopNest:
    """Mutable schedule state: compute nest + write-back nest + cursor.

    ``loops`` is the flat list ``compute + writeback``; ``n_compute`` marks the
    boundary.  The cursor is an index into ``loops``.
    """

    def __init__(self, contraction: Contraction):
        self.contraction = contraction
        self.loops: List[LoopLevel] = []
        # Canonical initial order: output iterators first, then reduce iters
        # (paper Fig. 3 starts from the naive m, k, n nest for matmul: we use
        # the textual order m, k, n — out iter m, reduce k, out iter n — to
        # match the figure).
        order = self._initial_order()
        for it in order:
            self.loops.append(LoopLevel(it, contraction.iter_sizes[it], 1))
        self.n_compute = len(self.loops)
        # Write-back nest: loops over the *output* iterators (copy T -> C).
        for it in contraction.out.iterators:
            self.loops.append(LoopLevel(it, contraction.iter_sizes[it], 1))
        self.cursor = 0

    def _initial_order(self) -> List[str]:
        c = self.contraction
        if c.rhs is not None and set(c.out.iterators) == {"m", "n"}:
            return ["m", "k", "n"] if "k" in c.iter_sizes else list(c.iter_sizes)
        # generic: output iterators, then reduction iterators
        order = list(c.out.iterators)
        for it in c.iter_sizes:
            if it not in order:
                order.append(it)
        return order

    # -- structure queries ---------------------------------------------------

    @property
    def compute_loops(self) -> List[LoopLevel]:
        return self.loops[: self.n_compute]

    @property
    def writeback_loops(self) -> List[LoopLevel]:
        return self.loops[self.n_compute :]

    def in_compute(self, idx: int) -> bool:
        return idx < self.n_compute

    def parent_extent(self, idx: int) -> int:
        """Extent the level at ``idx`` must cover: the step of the next-outer
        level of the same iterator in the same section, else the full dim."""
        lv = self.loops[idx]
        lo = 0 if self.in_compute(idx) else self.n_compute
        for j in range(idx - 1, lo - 1, -1):
            if self.loops[j].iterator == lv.iterator:
                return self.loops[j].step
        return self.contraction.iter_sizes[lv.iterator]

    def size_tail(self, idx: int) -> Tuple[int, int]:
        """The paper's (size, tail) features for the level at ``idx``."""
        lv = self.loops[idx]
        ext = self.parent_extent(idx)
        return ext // lv.step, ext % lv.step

    # -- actions (raw; legality checked by actions.py) -----------------------

    def swap(self, idx: int, other: int) -> None:
        if self.in_compute(idx) != self.in_compute(other):
            raise ValueError("swap across compute/write-back boundary")
        self.loops[idx], self.loops[other] = self.loops[other], self.loops[idx]

    def split(self, idx: int, factor: int) -> None:
        """Split level ``idx`` by ``factor`` (paper semantics, see module doc)."""
        lv = self.loops[idx]
        if factor <= 1 or factor >= lv.count:
            raise ValueError(f"illegal split {factor} of count {lv.count}")
        outer = LoopLevel(lv.iterator, math.ceil(lv.count / factor), lv.step * factor)
        inner = LoopLevel(lv.iterator, factor, lv.step)
        self.loops[idx : idx + 1] = [outer, inner]
        if idx < self.n_compute:
            self.n_compute += 1

    # -- featurization helpers ------------------------------------------------

    def effective_strides(self, idx: int) -> List[int]:
        """Memory-jump per increment of level ``idx``, one entry per tensor
        access this level drives (paper's red edges).  Compute-nest levels
        drive the input tensors (+ accumulator writes); write-back levels
        drive the output tensor."""
        lv = self.loops[idx]
        strides: List[int] = []
        if self.in_compute(idx):
            tensors: Sequence[TensorSpec] = self.contraction.inputs()
        else:
            tensors = (self.contraction.out,)
        for t in tensors:
            base = t.base_stride(lv.iterator)
            if base:
                strides.append(base * lv.step)
        return strides

    # -- canonical key (for search caching / oscillation detection) ----------

    def key(self, with_cursor: bool = True) -> Tuple:
        body = tuple((l.iterator, l.count, l.step) for l in self.loops)
        # the contraction name disambiguates structurally-identical schedules
        # of different contractions (tensor layouts change the evaluation),
        # so caches may be shared across benchmarks
        return (self.contraction.name, body, self.n_compute,
                self.cursor if with_cursor else -1)

    def structure_key(self) -> Tuple:
        return self.key(with_cursor=False)

    @classmethod
    def from_structure_key(cls, contraction: Contraction, key: Tuple) -> "LoopNest":
        """Rebuild a nest from ``structure_key()`` output (cursor resets to
        0).  Keys carry the full loop body, so cached measurements can be
        turned back into featurizable schedules — e.g. to harvest a
        :class:`ScheduleCache` into surrogate training data."""
        name, body, n_compute, _cursor = key
        if name != contraction.name:
            raise ValueError(
                f"key is for contraction {name!r}, not {contraction.name!r}")
        out = object.__new__(cls)
        out.contraction = contraction
        out.loops = [LoopLevel(it, count, step) for it, count, step in body]
        out.n_compute = n_compute
        out.cursor = 0
        return out

    def clone(self) -> "LoopNest":
        out = object.__new__(LoopNest)
        out.contraction = self.contraction
        out.loops = [l.copy() for l in self.loops]
        out.n_compute = self.n_compute
        out.cursor = self.cursor
        return out

    # -- pretty printing (paper Fig. 4 "text representation") ----------------

    def __repr__(self) -> str:
        lines = []
        for i, l in enumerate(self.loops):
            mark = "*" if i == self.cursor else " "
            sec = "C" if self.in_compute(i) else "W"
            size, tail = self.size_tail(i)
            lines.append(
                f"{mark}[{sec}] for {l.iterator} in {l.count}x (step {l.step},"
                f" size {size}, tail {tail})"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Iteration-space utilities (used by executor, cost model and tests)
# ---------------------------------------------------------------------------


def level_trip_counts(nest: LoopNest) -> List[int]:
    """Static trip count per level with clamping (ceil semantics)."""
    trips = []
    for i, lv in enumerate(nest.loops):
        ext = nest.parent_extent(i)
        trips.append(math.ceil(ext / lv.step))
    return trips


def compute_iteration_volume(nest: LoopNest) -> int:
    """Exact number of innermost compute-body executions (with clamping this
    equals prod(iter extents) of the contraction)."""
    vol = 1
    for s in nest.contraction.iter_sizes.values():
        vol *= s
    return vol
