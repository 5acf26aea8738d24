"""The card executor — LoopNest schedules run and timed on the CUDA device.

The counterpart of the JAX package's compiled executor.  Each schedule is
lowered once into a function of the contraction's operands:

1. **Kernel routes.**  Nests whose contraction matches a registered kernel
   shape run a hand-written kernel.  The ``"matmul"`` route lowers the
   schedule to a block shape and grid order (the resident suffix against
   the card's shared memory, :func:`~repro_torch.core.registry.card_boundary`)
   and calls :func:`repro_torch.kernels.matmul.matmul`, the tiled-matmul
   kernel; every reward of a matmul nest on the card is a timed launch of
   it, on operands of the contraction's dtype (a ``"bfloat16"`` record is
   timed on bf16 operands, on the kernel's tensor-core route, the route
   that serves it).  See :func:`register_kernel_route`.
2. **The slab path.**  Any other contraction replays the blocked
   interpreter's slab plan (``cpu_backend._run_section``, so the plans match
   by construction) in plain torch ops: each slab is sliced, ``torch.einsum``-
   ed into an f32 accumulator window, and the accumulator is written back in
   scheduled order.  It enumerates slabs in Python, so it is for non-matmul
   contractions and small CPU parity runs, not for matmul nests at the
   sizes the card is tuned at.

Lowered functions are cached by ``(structure_key, vec_cap, route, dtype)`` in
:class:`CompiledKernelCache` (LRU).  Timing lives in
:class:`~repro_torch.core.measure.MeasuredBackend`; :meth:`run_once` ends in
``torch.cuda.synchronize()`` on the card.

``measure="pool"`` times in spawned worker processes, one a card by
default (:meth:`TorchBackend.pool_spec`), so a kernel fault poisons a
worker's CUDA context, not the tuner's.  ``cache_dir`` (default: the
``LOOPTUNE_KERNEL_CACHE`` environment variable) opens the persistent kernel
store for the built kernel libraries (``kernels._build``): the workers, and
every process given the same directory, run ``nvcc`` once per source.  A
lowered schedule is only a block shape, cheap to make, so the executor
has nothing to compile ahead (``can_prepare`` stays False) and the store
holds libraries, not programs.

TF32 is switched off (``torch.backends.cuda.matmul.allow_tf32 = False``)
when an executor is built, so the ``peak()`` normaliser, the slab path's
einsums and the oracles all run in full f32, as the kernel does.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tracing import span
from .cpu_backend import (INPUTS_CACHE_CAPACITY, VEC_CAP_DEFAULT,
                          _einsum_expr, _run_section, make_inputs)
from .loop_ir import Contraction, LoopNest
from .measure import MeasuredBackend, MeasurementPolicy, PerWorker
from .schedule_cache import LRUCache

#: environment fallback for ``cache_dir`` (the JAX package's variable), so
#: launchers that never grew a ``cache_dir`` flag still share the store
CACHE_DIR_ENV = "LOOPTUNE_KERNEL_CACHE"

# lowered functions hold only slab plans or a block shape; the bound keeps
# the working set of a long tuning run in check all the same
COMPILED_CACHE_CAPACITY = 1024


# ---------------------------------------------------------------------------
# Slab path: LoopNest -> plain torch ops
# ---------------------------------------------------------------------------


def _slab_plan(levels, c: Contraction, vec_cap: int
               ) -> List[Tuple[Dict[str, int], Dict[str, int]]]:
    """All ``(offsets, extents)`` slabs the blocked interpreter would visit,
    in traversal order — computed once per structure."""
    plan: List[Tuple[Dict[str, int], Dict[str, int]]] = []
    _run_section(levels, c,
                 lambda off, ext: plan.append((dict(off), dict(ext))),
                 vec_cap)
    return plan


def _window(off: Dict[str, int], ext: Dict[str, int], iterators) -> Tuple:
    return tuple(slice(off[it], off[it] + ext[it]) for it in iterators)


def _build_slab_fn(nest: LoopNest, vec_cap: int) -> Callable:
    """Lower the schedule's compute + write-back sections to
    ``fn(*operands) -> out`` of plain torch ops (f32 accumulator)."""
    c = nest.contraction
    expr = _einsum_expr(c)
    compute = [([_window(off, ext, t.iterators) for t in c.inputs()],
                _window(off, ext, c.out.iterators))
               for off, ext in _slab_plan(nest.compute_loops, c, vec_cap)]
    writeback = [_window(off, ext, c.out.iterators)
                 for off, ext in _slab_plan(nest.writeback_loops, c, vec_cap)]

    def fn(*operands):
        acc = torch.zeros(c.out.dims, dtype=torch.float32,
                          device=operands[0].device)
        for in_win, out_win in compute:
            # bf16 operands (a bf16-labelled contraction) widen slab by slab
            acc[out_win] += torch.einsum(
                expr, *(op[w].float() for op, w in zip(operands, in_win)))
        # write-back nest: copy the accumulator into the output buffer in
        # the scheduled traversal order (slabs partition the output exactly)
        out = torch.zeros_like(acc)
        for win in writeback:
            out[win] = acc[win]
        return out

    return fn


# ---------------------------------------------------------------------------
# Kernel-shape routes (hand-written kernels)
# ---------------------------------------------------------------------------

_KERNEL_ROUTES: Dict[str, Tuple[Callable[[Contraction], bool],
                                Callable[[LoopNest], Callable]]] = {}


def register_kernel_route(name: str,
                          match: Callable[[Contraction], bool],
                          lower: Callable[[LoopNest], Callable]) -> None:
    """Register a hand-written kernel route: nests whose contraction
    satisfies ``match`` run ``lower(nest) -> fn(*operands)`` instead of the
    generic slab path."""
    _KERNEL_ROUTES[name] = (match, lower)


def match_kernel_route(c: Contraction) -> Optional[str]:
    for name, (match, _) in _KERNEL_ROUTES.items():
        if match(c):
            return name
    return None


def _is_matmul(c: Contraction) -> bool:
    return (c.rhs is not None
            and len(c.iter_sizes) == 3
            and len(c.out.iterators) == 2
            and len(c.lhs.iterators) == 2
            and len(c.rhs.iterators) == 2
            and c.lhs.iterators[0] == c.out.iterators[0]
            and c.rhs.iterators[1] == c.out.iterators[1]
            and c.lhs.iterators[1] == c.rhs.iterators[0])


def matmul_launch_args(nest: LoopNest) -> Dict[str, Any]:
    """Schedule -> the tiled-matmul kernel's block and grid order: the
    suffix resident in one thread block's shared memory becomes the block,
    the outer levels the grid order."""
    from .registry import card_boundary, schedule_to_blockspec

    c = nest.contraction
    m_it, n_it = c.out.iterators
    k_it = c.lhs.iterators[1]
    block, grid_order = schedule_to_blockspec(nest, card_boundary(nest))
    order = "nm" if grid_order.index(n_it) < grid_order.index(m_it) else "mn"
    return {"bm": int(block[m_it]), "bk": int(block[k_it]),
            "bn": int(block[n_it]), "grid_order": order}


def _lower_matmul(nest: LoopNest) -> Callable:
    from ..kernels.matmul import matmul

    kw = matmul_launch_args(nest)

    def fn(a, b):
        return matmul(a, b, out_dtype=torch.float32, **kw)

    return fn


register_kernel_route("matmul", _is_matmul, _lower_matmul)


# ---------------------------------------------------------------------------
# Lowered-function cache
# ---------------------------------------------------------------------------


class CompiledKernelCache(LRUCache):
    """LRU map from ``(structure_key, vec_cap, route)`` to a lowered
    function — the eviction discipline of :class:`ScheduleCache` (bounded,
    evict-coldest, never clear-all).  ``misses`` counts lookups that had to
    lower the schedule."""

    def __init__(self, capacity: int = COMPILED_CACHE_CAPACITY):
        super().__init__(capacity)


# ---------------------------------------------------------------------------
# Reference-parity execution surface (used by the tests)
# ---------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """``device`` (``None`` means ``"cuda"``) as a ``torch.device``; a CUDA
    device raises where there is no card — the executor and the networks
    never drop to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device is needed and none is available; pass device='cpu' "
            "to run on the CPU (the kernels' plain versions)")
    return dev


def execute_torch(nest: LoopNest, arrays: Dict[str, np.ndarray],
                  vec_cap: int = VEC_CAP_DEFAULT, route: Optional[str] = None,
                  device=None) -> np.ndarray:
    """Execute the schedule through a freshly lowered function; returns the
    output as NumPy.  ``route`` forces a registered kernel route (e.g.
    ``"matmul"``); None uses the slab path."""
    dev = resolve_device(device)
    c = nest.contraction
    if route is not None:
        if not _KERNEL_ROUTES[route][0](c):
            raise ValueError(f"nest {c.name!r} does not match route {route!r}")
        fn = _KERNEL_ROUTES[route][1](nest)
    else:
        fn = _build_slab_fn(nest, vec_cap)
    ops = [torch.from_numpy(np.asarray(arrays[t.name], np.float32)).to(dev)
           for t in c.inputs()]
    return fn(*ops).cpu().numpy()


# ---------------------------------------------------------------------------
# Timing backend
# ---------------------------------------------------------------------------


# the operand type of a contraction's label
_OPERAND_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# peak GFLOPS is constant within a process: memoized per device so backend
# construction never re-times it
_PEAK_CACHE: Dict[str, float] = {}


class TorchBackend(MeasuredBackend):
    """Measured-GFLOPS reward backend on the card — a *pure executor*.

    ``device=None`` means ``"cuda"``, and building the executor raises
    ``RuntimeError`` where there is no card; tests pass ``device="cpu"``.

    ``kernel`` controls the kernel-route fast path (the JAX package's
    ``pallas=`` knob, renamed): ``"auto"`` routes matching nests through the
    hand-written kernel on a CUDA device, ``"on"`` forces the route (on the
    CPU it runs the kernel's plain version), ``"off"`` always uses the slab
    path.

    ``measure="pool"`` measures in spawned workers, one a card unless
    ``pool_workers`` says otherwise (one on the CPU); ``cache_dir`` opens
    the kernel store the kernel libraries build through.
    """

    name = "torch"

    def __init__(
        self,
        device=None,
        vec_cap: int = VEC_CAP_DEFAULT,
        repeats: Optional[int] = None,
        seed: int = 0,
        kernel: str = "auto",
        policy: Optional[MeasurementPolicy] = None,
        measure: str = "inproc",
        pool_workers: Optional[int] = None,
        isolated: bool = False,
        cache_dir: Optional[str] = None,
        pool_timeout_s: Optional[float] = None,
    ):
        if kernel not in ("auto", "on", "off"):
            raise ValueError(f"kernel must be auto|on|off, got {kernel!r}")
        self.device = resolve_device(device)
        super().__init__(policy=policy, repeats=repeats, measure=measure,
                         pool_workers=pool_workers, isolated=isolated,
                         pool_timeout_s=pool_timeout_s)
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cache_dir = (cache_dir if cache_dir is not None
                          else os.environ.get(CACHE_DIR_ENV) or None)
        # the store the kernel libraries build through (None: build/kernels/
        # only); opened here, it serves every later build of this process
        from ..kernels import _build

        self.store = _build.open_library_store(self.cache_dir)
        self.vec_cap = vec_cap
        self.seed = seed
        self.kernel = kernel
        self.kernels = CompiledKernelCache()
        self._inputs_cache = LRUCache(INPUTS_CACHE_CAPACITY)
        self.compiles = 0      # schedules lowered by this executor
        self.compile_s = 0.0   # seconds spent lowering them

    # -- lowering -------------------------------------------------------------

    def _route(self, c: Contraction) -> Optional[str]:
        if self.kernel == "off":
            return None
        if self.kernel == "auto" and self.device.type != "cuda":
            return None
        return match_kernel_route(c)

    def _compile_key(self, nest: LoopNest) -> Tuple:
        return (nest.structure_key(), self.vec_cap,
                self._route(nest.contraction), nest.contraction.dtype)

    def executable(self, nest: LoopNest) -> Callable:
        """The lowered function for this structure (cached)."""
        key = self._compile_key(nest)
        fn = self.kernels.get(key)
        if fn is not None:
            self.kernels.hits += 1
            return fn
        self.kernels.misses += 1
        t0 = time.perf_counter()
        route = key[2]
        with span("backend.lower", route=route or "slab"):
            fn = (_KERNEL_ROUTES[route][1](nest) if route is not None
                  else _build_slab_fn(nest, self.vec_cap))
        self.compiles += 1
        self.compile_s += time.perf_counter() - t0
        self.kernels.put(key, fn)
        return fn

    def _inputs(self, c: Contraction) -> Tuple[torch.Tensor, ...]:
        """The seeded f32 operands, rounded once to the contraction's dtype
        (a bf16-labelled record's rewards time the kernel on bf16)."""
        def build():
            arrays = make_inputs(c, self.seed)
            dt = _OPERAND_DTYPES[c.dtype]
            return tuple(torch.from_numpy(arrays[t.name]).to(self.device).to(dt)
                         for t in c.inputs())

        return self._inputs_cache.get_or_create((c.name, c.dtype), build)

    def execute(self, nest: LoopNest) -> np.ndarray:
        """Run the (cached) lowered function on the executor's operands."""
        out = self.executable(nest)(*self._inputs(nest.contraction))
        return out.cpu().numpy()

    # -- executor surface (timing lives in MeasuredBackend) ------------------

    def run_once(self, nest: LoopNest) -> None:
        self.executable(nest)(*self._inputs(nest.contraction))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def pool_spec(self) -> Tuple[str, Dict[str, Any], Optional[str]]:
        # spawn, not fork: a forked child cannot use its parent's CUDA
        # context.  Worker wid runs on card wid % device_count, and shares
        # the parent's kernel store
        device: Any = str(self.device)
        if self.device.type == "cuda":
            device = PerWorker([f"cuda:{i}" for i in range(torch.cuda.device_count())])
        return ("torch", {"device": device, "vec_cap": self.vec_cap,
                          "seed": self.seed, "kernel": self.kernel,
                          "cache_dir": self.cache_dir}, "spawn")

    def default_pool_workers(self) -> Optional[int]:
        """One worker a card (one on the CPU), not one a core."""
        return torch.cuda.device_count() if self.device.type == "cuda" else 1

    def worker_ready(self) -> Dict[str, Any]:
        """A pool worker's start-up, paid before it reports ready: the CUDA
        context on its card, and the kernel libraries of the routes it will
        launch (from ``build/kernels/``, the store, or ``nvcc``)."""
        from ..kernels import _build

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            torch.empty(1, device=self.device)
            if self.kernel != "off":
                # (the package's ``matmul`` names the wrapper, not the module)
                from ..kernels.matmul import _lib as matmul_library

                matmul_library()
            torch.cuda.synchronize(self.device)
        return {"device": str(self.device),
                "builds": {stem: {"source": info.get("source"),
                                  "seconds": round(float(info["seconds"]), 3)}
                           for stem, info in _build.BUILD_INFO.items()}}

    def peak(self) -> float:
        """Empirical peak GFLOPS of the device: best-of-5 timing of a 512^3
        f32 ``torch.matmul``.  Memoized per device.  It stays the f32
        normaliser when rewards are timed on bf16 operands: the searches
        compare raw GFLOPS, so a bf16 reward above it is fine."""
        key = str(self.device)
        peak = _PEAK_CACHE.get(key)
        if peak is None:
            n = 512
            a = torch.from_numpy(np.random.default_rng(0).standard_normal(
                (n, n), dtype=np.float32)).to(self.device)
            b = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (n, n), dtype=np.float32)).to(self.device)
            sync = (lambda: torch.cuda.synchronize(self.device)
                    if self.device.type == "cuda" else None)
            torch.matmul(a, b)  # warm-up
            sync()
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                torch.matmul(a, b)
                sync()
                best = min(best, time.perf_counter() - t0)
            peak = 2 * n**3 / best / 1e9
            _PEAK_CACHE[key] = peak
        return peak

    def compile_stats(self) -> Dict[str, Any]:
        """Lowering ledger in the shape the searches read:
        ``compile_misses`` = schedules lowered, ``compile_hits`` = lowered
        functions served from the cache."""
        out = {"compile_misses": self.compiles,
               "compile_hits": self.kernels.hits,
               "compile_s": round(self.compile_s, 4)}
        if self.store is not None:
            out["store"] = self.store.stats()
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "compiles": self.compiles,
            "kernel_cache": self.kernels.stats(),
            "inputs_cache": self._inputs_cache.stats(),
            "compile": self.compile_stats(),
            "measure": self.measure_stats(),
        }
