"""Analytical TPU-v5e cost model — the hardware-adapted "LoopNest" backend.

The paper's reward is measured GFLOPS from LoopNest-generated AVX code; the
schedule properties LoopNest rewards are *register tiling*, *innermost-loop
vectorization* and *cache locality*.  The TPU analogue is a three-level
hierarchy (DESIGN §2):

    HBM --(dma)--> VMEM --(loads)--> VREG --(issue)--> MXU/VPU

* **VMEM residency** — the largest innermost suffix of the compute nest
  whose operand-tile footprint fits the VMEM budget is the Pallas *block*;
  loops outside it form the grid.  Each grid trip that does not index a
  tensor re-fetches that tensor's tile from HBM (classic reuse analysis).
* **Register residency** — the same analysis one level further in: the
  suffix fitting the VREG budget is the *register tile* (LoopNest's register
  tiling: "keeping a portion of the output tensor in registers at all
  times").  Loops between the two boundaries drive VMEM->VREG traffic.
* **Vector-lane alignment** — the *innermost* loop is vectorized onto the
  128-wide lanes (LoopNest: "automatically vectorizes the innermost loop");
  the level above feeds the 8 sublanes.  Efficiency is the padding waste of
  the register-tile extents against (8, 128), and operands whose innermost
  access stride is non-unit pay a relayout multiplier on VMEM traffic.
* **MXU depth** — contraction (reduce) extents inside the register tile pad
  to the systolic depth.
* **Overheads** — per-grid-step DMA issue and per-loop-trip scalar-core
  cost make over-deep nests and tiny tiles visibly bad.

``estimate(nest)`` returns modelled GFLOPS; the RL reward uses it exactly
like the measured backend (normalized delta, paper §III-B).

Hardware constants (TPU v5e, per core): 197 TFLOP/s bf16, 819 GB/s HBM,
~128 MiB VMEM (half budgeted for double buffering), ~4x HBM bandwidth
VMEM->VREG, (8, 128) VREGs with a ~32 KiB accumulator/register budget.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from .loop_ir import Contraction, LoopLevel, LoopNest
from .measure import PoolHostBackend

PEAK_FLOPS = 197e12  # bf16 per chip
HBM_BW = 819e9  # bytes/s
VMEM_BW = 4 * HBM_BW  # VMEM -> VREG sustained
VMEM_BYTES = 128 * 1024 * 1024
VMEM_BUDGET = VMEM_BYTES // 2  # double buffering reserve
REG_BUDGET = 32 * 1024  # register-tile budget (VREG file slice)
LANES = 128
SUBLANES = 8
MXU_DEPTH = 8
GRID_STEP_OVERHEAD_S = 1e-7  # DMA issue + sequencer per VMEM-grid step
LOOP_TRIP_OVERHEAD_S = 2e-9  # scalar-core loop management per trip


def _block_extents(
    levels: List[LoopLevel], b: int, sizes: Dict[str, int]
) -> Dict[str, int]:
    """Static tile extent per iterator for suffix ``levels[b:]``: the step of
    the innermost outside-level of that iterator, or the full dim."""
    ext = dict(sizes)
    for i in range(b):
        ext[levels[i].iterator] = min(levels[i].step, sizes[levels[i].iterator])
    return ext


def _tile_bytes(c: Contraction, ext: Dict[str, int], dtype_bytes: int) -> int:
    total = 0
    for t in c.inputs():
        vol = 1
        for it in t.iterators:
            vol *= ext[it]
        total += vol * dtype_bytes
    # accumulator tile held in f32
    vol = 1
    for it in c.out.iterators:
        vol *= ext[it]
    total += vol * 4
    return total


def _grid_trips(levels: List[LoopLevel], b: int, sizes: Dict[str, int]) -> List[int]:
    trips = []
    for i in range(b):
        it = levels[i].iterator
        parent = sizes[it]
        for j in range(i - 1, -1, -1):
            if levels[j].iterator == it:
                parent = levels[j].step
                break
        trips.append(max(1, math.ceil(min(parent, sizes[it]) / levels[i].step)))
    return trips


def _util(e: int, t: int) -> float:
    return e / (math.ceil(e / t) * t) if e > 0 else 1.0


class TPUAnalyticalBackend(PoolHostBackend):
    """Schedule -> modelled GFLOPS for a single TPU v5e core.

    Deterministic (no wall clock).  Kept exactly as the JAX package has it:
    it is the training/parity backend, and its ``_boundary`` also gives the
    card executor its shared-memory residency boundary
    (:func:`~repro_torch.core.registry.card_boundary`).  ``measure="pool"``
    routes batches through the worker pool — the reference configuration
    for pool-vs-in-process reward parity (identical code and inputs in the
    workers means bit-equal GFLOPS).
    """

    name = "tpu"

    def __init__(self, dtype_bytes: int = 2, vmem_budget: int = VMEM_BUDGET,
                 reg_budget: int = REG_BUDGET,
                 measure: str = "inproc", pool_workers=None, policy=None,
                 pool_timeout_s=None):
        self._init_pool_host(measure, pool_workers, policy, pool_timeout_s)
        self.dtype_bytes = dtype_bytes
        self.vmem_budget = vmem_budget
        self.reg_budget = reg_budget

    def pool_spec(self):
        return ("tpu", {"dtype_bytes": self.dtype_bytes,
                        "vmem_budget": self.vmem_budget,
                        "reg_budget": self.reg_budget}, None)

    def evaluate_batch(self, nests) -> "np.ndarray":
        import numpy as np

        if self.measure_mode == "pool" and nests:
            ms = self._ensure_pool().measure_batch(list(nests))
            return np.array([m.gflops for m in ms], dtype=np.float64)
        return super().evaluate_batch(nests)

    def _boundary(self, nest: LoopNest, budget: int, lo: int = 0) -> int:
        """Smallest b >= lo whose suffix tile footprint fits ``budget``."""
        levels = nest.compute_loops
        sizes = nest.contraction.iter_sizes
        for b in range(lo, len(levels) + 1):
            ext = _block_extents(levels, b, sizes)
            if _tile_bytes(nest.contraction, ext, self.dtype_bytes) <= budget:
                return b
        return len(levels)

    def residency_boundary(self, nest: LoopNest) -> int:
        return self._boundary(nest, self.vmem_budget)

    # ------------------------------------------------------------------

    def _traffic(self, c: Contraction, levels, lo: int, hi: int,
                 ext_inner: Dict[str, int], sizes, dtype_bytes: int,
                 lane_stride_penalty: Dict[str, float]) -> float:
        """Bytes moved across a memory level whose resident suffix starts at
        ``hi``, driven by loops [lo, hi)."""
        trips = _grid_trips(levels, hi, sizes)[lo:hi]
        drive = levels[lo:hi]
        traffic = 0.0
        for t in c.inputs():
            tile = dtype_bytes * lane_stride_penalty.get(t.name, 1.0)
            for it in t.iterators:
                tile *= ext_inner[it]
            n_tiles = 1
            for it in t.iterators:
                n_tiles *= math.ceil(sizes[it] / ext_inner[it])
            reuse = 1
            for lv, tr in zip(drive, trips):
                if lv.iterator not in t.iterators:
                    reuse *= tr
            traffic += tile * n_tiles * reuse
        # accumulator spill/refill per reduction revisit outside the tile
        out_tile = 4.0
        for it in c.out.iterators:
            out_tile *= ext_inner[it]
        n_out = 1
        for it in c.out.iterators:
            n_out *= math.ceil(sizes[it] / ext_inner[it])
        red_revisits = 1
        for lv, tr in zip(drive, trips):
            if lv.iterator in c.reduce_iters:
                red_revisits *= tr
        traffic += out_tile * n_out * (2 * red_revisits - 1)
        return traffic

    def analyze(self, nest: LoopNest) -> Dict[str, float]:
        c = nest.contraction
        sizes = c.iter_sizes
        levels = nest.compute_loops
        b_vmem = self._boundary(nest, self.vmem_budget)
        b_reg = self._boundary(nest, self.reg_budget, lo=b_vmem)
        ext_vmem = _block_extents(levels, b_vmem, sizes)
        ext_reg = _block_extents(levels, b_reg, sizes)

        # ---- vector-lane structure of the register tile -------------------
        # innermost level -> lanes; next level out -> sublanes
        lane_it = levels[-1].iterator if levels else None
        sub_it = levels[-2].iterator if len(levels) >= 2 else None
        lane_ext = ext_reg.get(lane_it, 1) if lane_it else 1
        sub_ext = ext_reg.get(sub_it, 1) if sub_it else 1
        eff = _util(lane_ext, LANES) * _util(sub_ext, SUBLANES)
        if c.rhs is not None:
            depth = 1
            for it in c.reduce_iters:
                depth *= ext_reg[it]
            eff *= _util(depth, MXU_DEPTH)

        # non-unit innermost stride => relayout multiplier on VMEM loads
        lane_penalty: Dict[str, float] = {}
        if levels:
            lane_step = levels[-1].step
            for t in c.inputs():
                base = t.base_stride(lane_it)
                if base == 0:
                    continue  # loop doesn't drive this tensor
                s = base * lane_step
                if s > 1:
                    lane_penalty[t.name] = min(float(s), float(SUBLANES))

        # ---- traffic at both levels ---------------------------------------
        hbm_traffic = self._traffic(
            c, levels, 0, b_vmem, ext_vmem, sizes, self.dtype_bytes, {})
        vmem_traffic = self._traffic(
            c, levels, b_vmem, b_reg, ext_reg, sizes, self.dtype_bytes,
            lane_penalty)

        # write-back nest: acc -> out through VMEM (contiguity sensitive)
        wb_bytes = 2.0 * self.dtype_bytes
        for it in c.out.iterators:
            wb_bytes *= sizes[it]
        wb = nest.writeback_loops
        if wb:
            s = c.out.base_stride(wb[-1].iterator) * wb[-1].step
            if s > 1:
                wb_bytes *= min(float(s), float(SUBLANES))
        hbm_traffic += wb_bytes

        # ---- compute / overheads -------------------------------------------
        flops = c.flops()
        t_compute = flops / (PEAK_FLOPS * max(eff, 1e-3))
        t_hbm = hbm_traffic / HBM_BW
        t_vmem = vmem_traffic / VMEM_BW
        n_grid = 1
        for tr in _grid_trips(levels, b_vmem, sizes):
            n_grid *= tr
        # dynamic trip count of every loop outside the register tile
        trips_all = _grid_trips(levels, b_reg, sizes)
        total_trips, vol = 0, 1
        for tr in trips_all:
            vol *= tr
            total_trips += vol
        for i, lv in enumerate(wb):
            pass  # write-back loop overhead folded into wb_bytes
        t_over = (n_grid * GRID_STEP_OVERHEAD_S
                  + total_trips * LOOP_TRIP_OVERHEAD_S)
        t_total = max(t_compute, t_hbm, t_vmem) + t_over
        return {
            "gflops": flops / t_total / 1e9,
            "t_compute": t_compute,
            "t_hbm": t_hbm,
            "t_vmem": t_vmem,
            "t_overhead": t_over,
            "hbm_bytes": hbm_traffic,
            "vmem_bytes": vmem_traffic,
            "mxu_eff": eff,
            "n_grid": n_grid,
            "b_vmem": b_vmem,
            "b_reg": b_reg,
        }

    def evaluate(self, nest: LoopNest) -> float:
        return self.analyze(nest)["gflops"]

    def peak(self) -> float:
        return PEAK_FLOPS / 1e9
