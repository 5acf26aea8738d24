"""Tuned-schedule registry — the serving side of the tuner.

The AutoTVM "TopHub log" pattern: tuning happens once, off the request
path, and its output is persisted in a table the compile step consults.
Records are keyed by ``(structure_key, backend, hardware)``:

* ``structure_key`` — the workload's structural signature, e.g.
  ``mm:512x512x512:float32`` (one tuned entry covers every recurrence of
  that contraction shape, the TPU learned-cost-model keying);
* ``backend`` — which reward executor produced the schedule ("tpu"
  analytical / "torch" card executor / "numpy" / "any"; files written by
  the JAX package also hold "jax");
* ``hardware`` — the host it was measured on (the card's name, or the
  platform triple on a CPU host), so fleets can union tables without
  cross-host timings clobbering each other.

The schema is the JAX package's, byte for byte, so a file written by
either package loads and merges in the other.

Each record carries the tuned ``gflops``, the action trace, the lowered
``block``/``grid_order`` (via :func:`schedule_to_blockspec`),
the measurement spread (from ``core.measure``'s variance guardrails) and
tuner-checkpoint provenance.  Persistence is versioned JSON with atomic
save; v1 files (ad-hoc ``kernel:dims:dtype`` keys) migrate on load.
``merge`` unions tables best-gflops-wins so a tuning fleet's shards can
be folded into one serving table.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from .loop_ir import LoopNest

SCHEMA_VERSION = 2

#: wildcard for backend/hardware key fields (matches anything on lookup)
ANY = "any"

_HARDWARE: Optional[str] = None


def current_hardware() -> str:
    """Stable host descriptor for registry keys (memoized per process).

    With a CUDA card this is its name (``torch.cuda.get_device_name``); on
    CPU hosts it falls back to the platform triple, the same string the JAX
    package writes there, so tables tuned on one CPU host by either package
    key alike.
    """
    global _HARDWARE
    if _HARDWARE is None:
        import torch

        if torch.cuda.is_available():
            kind = torch.cuda.get_device_name(0)
        else:
            import platform

            kind = f"cpu-{platform.machine() or 'unknown'}"
        # raw descriptor: record keys escape reserved characters themselves,
        # so a device kind containing ``|`` survives round-trips verbatim
        _HARDWARE = str(kind)
    return _HARDWARE


#: shared memory one thread block can use on the card (H100: 227 KB)
SMEM_PER_BLOCK = 232_448


def card_boundary(nest: LoopNest) -> int:
    """The card's residency boundary: the first compute level whose suffix
    tile (f32 operand slabs + f32 accumulator, as ``make_inputs`` builds
    them) fits one thread block's shared memory.  The same ``_boundary``
    rule as the analytical model, against the card's budget instead of
    VMEM's, so a schedule's block never exceeds what one block can stage."""
    from .cost_model import TPUAnalyticalBackend

    return TPUAnalyticalBackend(dtype_bytes=4)._boundary(nest, SMEM_PER_BLOCK)


def schedule_to_blockspec(nest: LoopNest, vmem_boundary: Optional[int] = None):
    """Lower the tuned nest onto a block shape + grid order.

    The resident suffix (innermost levels fitting fast memory — computed by
    the analytical TPU backend unless ``vmem_boundary`` is given; the card
    passes :func:`card_boundary`) becomes the block; the grid iterates the
    outer levels in schedule order.  Returns
    ``(block_sizes: {iter: extent}, grid_order: [iter, ...])``.
    """
    from .cost_model import TPUAnalyticalBackend, _block_extents

    levels = nest.compute_loops
    sizes = nest.contraction.iter_sizes
    b = (
        vmem_boundary
        if vmem_boundary is not None
        else TPUAnalyticalBackend().residency_boundary(nest)
    )
    block = _block_extents(levels, b, sizes)
    grid_order = [levels[i].iterator for i in range(b)]
    # iterators with no grid level iterate once (whole dim resident)
    for it in sizes:
        if it not in grid_order:
            grid_order.append(it)
    return block, grid_order


def _measurement_dict(measurement: Any) -> Optional[Dict[str, Any]]:
    """Normalize a ``core.measure.Measurement`` (or plain dict) for JSON."""
    if measurement is None:
        return None
    if dataclasses.is_dataclass(measurement):
        measurement = dataclasses.asdict(measurement)
    keep = ("gflops", "best_s", "spread", "repeats", "escalations",
            "noisy", "worker")
    return {k: measurement[k] for k in keep if k in measurement}


class ScheduleRegistry:
    """Persistent best-schedule table keyed by (structure_key, backend,
    hardware)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._table: Dict[str, dict] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self._load(json.load(f))

    # -- keys ---------------------------------------------------------------

    @staticmethod
    def key(kernel: str, dims: Sequence[int], dtype: str = "float32") -> str:
        """Structural workload signature (the v1 key, kept as the first
        component of the v2 record key)."""
        return f"{kernel}:{'x'.join(map(str, dims))}:{dtype}"

    # ``|`` joins the three key components, so a component containing a
    # literal ``|`` (real device-kind strings do: "TPU v5 lite|pod") must be
    # escaped on write or the fields shift on reload.  %-style escaping keeps
    # legacy keys (no reserved characters) byte-identical.
    @staticmethod
    def _escape(component: str) -> str:
        return component.replace("%", "%25").replace("|", "%7C")

    @staticmethod
    def _unescape(component: str) -> str:
        return component.replace("%7C", "|").replace("%25", "%")

    @classmethod
    def record_key(cls, structure_key: str, backend: str, hardware: str) -> str:
        return "|".join(cls._escape(str(c))
                        for c in (structure_key, backend, hardware))

    @classmethod
    def split_key(cls, record_key: str) -> Tuple[str, str, str]:
        parts = record_key.split("|")
        if len(parts) != 3:
            raise ValueError(
                f"un-parseable registry record key {record_key!r}: expected "
                f"3 |-separated components, got {len(parts)}")
        sk, backend, hardware = (cls._unescape(p) for p in parts)
        return sk, backend, hardware

    # -- schema / persistence -----------------------------------------------

    def _load(self, doc: Any) -> None:
        if isinstance(doc, dict) and doc.get("version") == SCHEMA_VERSION:
            table: Dict[str, dict] = {}
            dropped = 0
            for k, entry in dict(doc.get("entries", {})).items():
                try:
                    self.split_key(k)
                except ValueError:
                    dropped += 1
                    continue
                table[k] = entry
            if dropped:
                warnings.warn(
                    f"registry: dropped {dropped} record(s) with "
                    "un-parseable keys (written before |-escaping, or "
                    "corrupted); re-tune to regenerate them", stacklevel=2)
            self._table = table
            return
        # v1 migration shim: a flat {kernel:dims:dtype -> entry} table from
        # before backend/hardware keying.  Entries become wildcard records
        # so lookups from any executor still find them.
        migrated: Dict[str, dict] = {}
        for k, entry in (doc or {}).items():
            if not isinstance(entry, dict) or "gflops" not in entry:
                continue
            entry = dict(entry)
            entry.setdefault("backend", ANY)
            entry.setdefault("hardware", ANY)
            entry.setdefault("structure_key", k)
            migrated[self.record_key(k, ANY, ANY)] = entry
        self._table = migrated

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if not path:
            raise ValueError("no registry path")
        # abspath first: a bare filename has no dirname, and mkstemp(dir=".")
        # in a deleted/unwritable CWD raises FileNotFoundError
        path = os.path.abspath(path)
        parent = os.path.dirname(path)
        os.makedirs(parent, exist_ok=True)
        doc = {"version": SCHEMA_VERSION, "entries": self._table}
        fd, tmp = tempfile.mkstemp(dir=parent)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)  # atomic
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # -- writes ---------------------------------------------------------------

    def put(
        self,
        kernel: str,
        dims: Sequence[int],
        gflops: float,
        actions: List[str],
        nest: Optional[LoopNest] = None,
        dtype: str = "float32",
        *,
        backend: str = ANY,
        hardware: Optional[str] = None,
        measurement: Any = None,
        provenance: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Record a tuned schedule; returns True if it entered the table
        (best-gflops-wins per record key)."""
        hardware = hardware if hardware is not None else current_hardware()
        sk = self.key(kernel, dims, dtype)
        entry: Dict[str, Any] = {
            "gflops": float(gflops),
            "actions": list(actions),
            "structure_key": sk,
            "backend": backend,
            "hardware": hardware,
        }
        if nest is not None:
            try:
                # schedules measured on the card keep blocks that fit its
                # shared memory; every other backend keeps the JAX
                # package's VMEM block exactly
                block, grid = schedule_to_blockspec(
                    nest, card_boundary(nest) if backend == "torch" else None)
                entry["block"] = block
                entry["grid_order"] = grid
                entry["levels"] = [
                    (l.iterator, l.count, l.step) for l in nest.loops
                ]
            except Exception as e:  # noqa: BLE001 — degrade, don't drop
                warnings.warn(
                    f"registry: BlockSpec lowering failed for {sk} "
                    f"({type(e).__name__}: {e}); recording actions-only "
                    "entry (consumers will use default blocks)",
                    stacklevel=2)
        m = _measurement_dict(measurement)
        if m is not None:
            entry["measurement"] = m
        if provenance is not None:
            entry["provenance"] = dict(provenance)
        k = self.record_key(sk, backend, hardware)
        if k not in self._table or self._table[k]["gflops"] < entry["gflops"]:
            self._table[k] = entry
            return True
        return False

    def merge(self, other: "ScheduleRegistry") -> int:
        """Union another table into this one, best-gflops-wins per record
        key; returns the number of records adopted.  This is how a tuning
        fleet's per-shard tables fold into one serving table."""
        adopted = 0
        for k, entry in other._table.items():
            if k not in self._table or self._table[k]["gflops"] < entry["gflops"]:
                self._table[k] = dict(entry)
                adopted += 1
        return adopted

    def flush(self, path: Optional[str] = None) -> int:
        """Concurrent-writer-safe save: merge the on-disk table into ours,
        then save, under an exclusive ``<path>.lock`` advisory lock.

        ``save()`` alone is atomic (no torn files) but last-writer-wins:
        two fleet shards flushing the same path would each clobber the
        other's records.  The lock serializes the read-merge-write cycle,
        so every writer's records survive (best-gflops-wins per key, as
        :meth:`merge`).  Returns the number of on-disk records adopted.
        """
        path = os.path.abspath(path or self.path or "")
        if not path:
            raise ValueError("no registry path")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            import fcntl
        except ImportError:  # pragma: no cover - non-POSIX host
            fcntl = None
        lock_f = None
        if fcntl is not None:
            lock_f = open(path + ".lock", "a")
            fcntl.flock(lock_f.fileno(), fcntl.LOCK_EX)
        try:
            adopted = 0
            if os.path.exists(path):
                try:
                    disk = ScheduleRegistry(path)
                except (ValueError, OSError) as e:
                    warnings.warn(
                        f"registry: could not reload {path} during flush "
                        f"({type(e).__name__}: {e}); writing our table "
                        "as-is", stacklevel=2)
                else:
                    adopted = self.merge(disk)
            self.save(path)
            return adopted
        finally:
            if lock_f is not None:
                lock_f.close()  # releases the flock

    # -- lookups --------------------------------------------------------------

    def get(
        self,
        kernel: str,
        dims: Sequence[int],
        dtype: str = "float32",
        *,
        backend: Optional[str] = None,
        hardware: Optional[str] = None,
        exact: bool = False,
    ) -> Optional[dict]:
        """Best record for this workload.

        Candidates match on structure key; among them the most specific
        match wins — (backend, hardware) both matching beats backend-only,
        beats any — and gflops breaks ties.  ``exact=True`` requires the
        (backend, hardware) pair (wildcard records still match).  With no
        backend/hardware given, the best record for the workload is
        returned regardless of where it was tuned (structural-signature
        transfer: the block shape is still the best prior available).
        """
        sk = self.key(kernel, dims, dtype)
        best: Optional[dict] = None
        best_rank: Tuple[int, float] = (-1, float("-inf"))
        for k, entry in self._table.items():
            esk, ebackend, ehardware = self.split_key(k)
            if esk != sk:
                continue
            b_ok = backend is None or ebackend in (backend, ANY)
            h_ok = hardware is None or ehardware in (hardware, ANY)
            if exact and not (b_ok and h_ok):
                continue
            specificity = ((2 if backend is not None and ebackend == backend
                            else 0)
                           + (1 if hardware is not None
                              and ehardware == hardware else 0)
                           + (1 if b_ok else 0) + (1 if h_ok else 0))
            rank = (specificity, entry["gflops"])
            if rank > best_rank:
                best_rank, best = rank, entry
        return best

    def block_for(
        self,
        kernel: str,
        dims: Sequence[int],
        default: Dict[str, int],
        dtype: str = "float32",
        *,
        backend: Optional[str] = None,
        hardware: Optional[str] = None,
    ) -> Dict[str, int]:
        entry = self.get(kernel, dims, dtype, backend=backend,
                         hardware=hardware)
        if entry and "block" in entry:
            return dict(entry["block"])
        return default

    def entries(self) -> Iterator[Tuple[str, dict]]:
        return iter(self._table.items())

    def __len__(self) -> int:
        return len(self._table)
