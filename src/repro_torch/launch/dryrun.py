"""Multi-pod dry-run of the port: trace every (arch x shape x mesh) cell on
fake tensors over a fake process group.

For each cell this builds the REAL step function (the train step with AdamW
for ``train_*``, prefill for ``prefill_*``, the decode step with its cache
for ``decode_*``/``long_*``), with parameters, optimizer state, inputs and
caches as DTensors whose local shards are fake tensors (shape and dtype,
no storage), over a ``"fake"`` process group of 256 ranks (one pod, 16 x
16) or 512 (two pods, 2 x 16 x 16); it runs the step once as rank 0 and
records, per device:

  * ``memory_analysis`` — the local bytes of the arguments (parameters,
    AdamW state, batch, cache; ``argument_bytes_by_group`` splits them), the
    peak of the bytes the step allocates while it runs (``temp``) and the
    bytes of what it returns (``output``),
  * ``cost_analysis`` — the FLOPs of the local ops the rank runs (forward,
    remat recompute and backward; ``torch.utils.flop_counter``'s formulas)
    and the operand + result bytes of those ops (``bytes accessed``),
  * collective bytes and counts by kind (all-gather / all-reduce /
    reduce-scatter / all-to-all), the operand bytes of the functional
    collectives DTensor issues,

into ``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` (resumable:
existing files are kept unless --force), with the JAX package's
``launch/dryrun.py`` record keys, so ``analysis/roofline.load_all`` reads
them.  It runs on the CPU, needs no card, and allocates no tensor of the
model's size: everything the step computes is a fake tensor, and every
kernel's place is taken by its plain version (the wrappers' CPU path).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch musicgen-large \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim.schedules import constant
from repro_torch.runtime import sharding as SH

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
WORLD = {"single": 256, "multi": 512}

# functional collectives (``torch.ops._c10d_functional``) -> the reference's
# HLO kind names
_COLL_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
               ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"))
# ops that allocate without reading or writing memory
_NO_ACCESS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A ``"fake"`` default process group of ``world_size`` ranks (this
    process is rank 0; collectives return at once), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the dry-run "
                           "starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors in a tree of dicts, lists, tuples (NamedTuples too) and
    modules (a module's parameters)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, (dict, list, tuple)):
        for x in (tree.values() if isinstance(tree, dict) else tree):
            yield from _tensors(x)


def _storage(t: torch.Tensor):
    """The storage of ``t``'s local shard (a DTensor's) or of ``t``."""
    return (t.to_local() if SH.is_dtensor(t) else t).untyped_storage()


def local_bytes(tree) -> int:
    """Bytes of the local shards of the tensors in ``tree``, each storage
    once."""
    seen = {}  # id -> storage, held so that no id is reused meanwhile
    for t in _tensors(tree):
        st = _storage(t)
        seen.setdefault(id(st), st)
    return sum(st.nbytes() for st in seen.values())


class StepTrace(TorchDispatchMode):
    """What rank 0 runs while the mode is on: FLOPs, bytes accessed,
    collectives, and the live bytes the step allocates and their peak.

    The arguments' local shards are fake tensors of ``fake_mode`` (with
    ``allow_non_fake_inputs``), which is not entered while the step runs, so
    that DTensor's own index bookkeeping stays on real tensors.  An op on
    DTensors is passed on to DTensor (``NotImplemented``), which runs it on
    the local shards; those local ops come back here and are counted, so
    every count is per device.  A factory op (no tensor input: ``zeros``,
    ``arange``) runs in ``fake_mode``, except where DTensor's placement code
    calls it.  Not counted: DTensor's shape propagation (each op once at the
    global shape, in a fake mode of its own) and ops on real tensors only."""

    def __init__(self, fake_mode, arguments=()):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes_accessed = 0
        self.collective_bytes: Dict[str, int] = {}
        self.collective_counts: Dict[str, int] = {}
        self.live = self.peak = 0
        self._args = [_storage(t) for t in _tensors(arguments)]  # held: ids stay theirs
        self._owned = {id(st) for st in self._args}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)  # DTensor's shape propagation
        ins = list(_tensors((args, kwargs)))
        if ins and not any(isinstance(t, FakeTensor) for t in ins):
            return func(*args, **kwargs)  # real tensors only: not the step's data
        if not ins and _dtensor_bookkeeping():
            return func(*args, **kwargs)  # DTensor's index tensors stay real
        if ins:
            out = func(*args, **kwargs)  # the fake tensors' own mode runs it
        else:
            with self.fake_mode:
                out = func(*args, **kwargs)
        self._count(func, args, kwargs, ins, out)
        return out

    def _count(self, func, args, kwargs, ins, out):
        from torch.utils.flop_counter import flop_registry

        outs = list(_tensors(out))
        name = func._overloadpacket.__name__
        if func.namespace.startswith("_c10d_functional"):
            for key, kind in _COLL_KINDS:
                if key in name:
                    nbytes = sum(t.numel() * t.element_size() for t in ins[:1])
                    self.collective_bytes[kind] = self.collective_bytes.get(kind, 0) + nbytes
                    self.collective_counts[kind] = self.collective_counts.get(kind, 0) + 1
        else:
            flop_fn = flop_registry.get(func._overloadpacket)
            if flop_fn is not None:
                self.flops += int(flop_fn(*args, **kwargs, out_val=out))
            if not _is_view(func) and name not in _NO_ACCESS:
                self.bytes_accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            if id(st) in self._owned:
                continue
            self._owned.add(id(st))
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, id(st), st.nbytes())

    def _free(self, key, nbytes):
        self._owned.discard(key)
        self.live -= nbytes


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


_BOOKKEEPING = ("placement_types.py", "_utils.py", "_redistribute.py", "_collective_utils.py")


def _dtensor_bookkeeping() -> bool:
    """Whether the factory op being dispatched was called by DTensor's
    placement code (index tensors of uneven and strided shards), not by the
    model or a DTensor factory (``_api.py``)."""
    frame = sys._getframe(2)  # the op's caller, past this and the mode
    while frame is not None:
        path = frame.f_code.co_filename.replace("\\", "/")
        if "/torch/_dynamo/" in path or path.endswith("/torch/_compile.py"):
            frame = frame.f_back  # the dispatch path's own decorators
            continue
        return "/torch/distributed/tensor/" in path and path.endswith(_BOOKKEEPING)
    return False


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _place_batch(specs: Dict[str, torch.Tensor], mesh) -> Dict[str, Any]:
    return {k: SH.distribute(torch.empty(v.shape, dtype=v.dtype), mesh,
                             SH.batch_pspec(mesh, v.shape[0], v.ndim))
            for k, v in specs.items()}


def build_step(cfg: ModelConfig, cell: ShapeCell, mesh):
    """(step_fn, args, argument groups) for the cell's kind, built under the
    caller's fake mode on the CPU.  Train: parameters by FSDP specs, AdamW's
    moments and master by ZeRO specs, a constant lr.  Prefill: parameters by
    the serving (TP) specs, as the reference places them (FSDP is for
    training only).  Decode: the same parameters and the cache placed by
    ``cache_pspecs``, at ``cache_len = seq_len - 1`` (the last slot)."""
    specs = input_specs(cfg, cell)
    gen = torch.Generator().manual_seed(0)  # fake tensors: the draws shape, not fill
    batch = _place_batch(specs["batch"], mesh)
    if cell.kind == "train":
        params, opt = S.init_train_state(cfg, gen, device="cpu", mesh=mesh)
        fn = S.make_train_step(cfg, constant(3e-4))
        return fn, (params, opt, batch), {"params": params, "optimizer": opt, "batch": batch}
    params = S.place_params(T.init_params(cfg, gen, "cpu"), cfg, mesh, "tp")
    if cell.kind == "prefill":
        fn = S.make_prefill_step(cfg, max_len=cell.seq_len)
        return fn, (params, batch), {"params": params, "batch": batch}
    caches = T.init_cache(cfg, cell.global_batch, cell.seq_len, device="cpu", mesh=mesh)
    fn = S.make_decode_step(cfg)
    return (fn, (params, batch, caches, cell.seq_len - 1),
            {"params": params, "batch": batch, "cache": caches})


def trace_cell(cfg: ModelConfig, cell: ShapeCell, mesh) -> Dict[str, Any]:
    """Build the cell's step on ``mesh`` (over the current process group)
    and run it once on fake tensors; returns the record's measured fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    SH.FALLBACKS.clear()  # per-cell record (the sweep reuses the process)
    t0 = time.time()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake, SH.use_mesh(mesh):
        fn, args, groups = build_step(cfg, cell, mesh)
    t_build = time.time() - t0
    by_group = {k: local_bytes(v) for k, v in groups.items()}
    arg_bytes = sum(by_group.values())
    with SH.use_mesh(mesh), StepTrace(fake, args) as trace:
        out = fn(*args)
    out_bytes = local_bytes(out)
    del out
    coll_total = float(sum(trace.collective_bytes.values()))
    return {
        "build_s": round(t_build, 2),
        "trace_s": round(time.time() - t0 - t_build, 2),
        "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                            "output_size_in_bytes": out_bytes,
                            "temp_size_in_bytes": trace.peak},
        "argument_bytes_by_group": by_group,
        "cost_analysis": {"flops": float(trace.flops),
                          "bytes accessed": float(trace.bytes_accessed)},
        "collective_bytes": dict(trace.collective_bytes),
        "collective_counts": dict(trace.collective_counts),
        "corrected": {"flops": float(trace.flops),
                      "mem_bytes": float(trace.bytes_accessed),
                      "coll_bytes": {k: float(v) for k, v in trace.collective_bytes.items()},
                      "coll_bytes_total": coll_total, "while_trips": []},
        "n_params": T.count_params(cfg),
        "n_params_active": T.count_params(cfg, active_only=True),
        "sharding_fallbacks": list(SH.FALLBACKS),
    }


def run_cell(arch: str, shape: str, mesh_kind: str, force: bool = False,
             out_dir: Path = RESULTS_DIR) -> dict:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape}__{mesh_kind}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    cell = SHAPES[shape]
    if cell not in shapes_for(cfg):
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "skipped",
               "reason": "full-attention arch: long_500k inapplicable"}
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "kind": cell.kind,
           "seq_len": cell.seq_len, "global_batch": cell.global_batch}
    try:
        with fake_world(WORLD[mesh_kind]):
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
            rec["mesh_shape"] = SH.mesh_sizes(mesh)
            rec.update(trace_cell(cfg, cell, mesh))
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, cell.name, m) for arch, cfg in ARCHS.items()
                 for cell in shapes_for(cfg) for m in meshes]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for arch, shape, m in cells:
        rec = run_cell(arch, shape, m, force=args.force, out_dir=Path(args.out))
        status = rec["status"]
        extra = ""
        if status == "ok":
            ma = rec["memory_analysis"]
            extra = (f" trace={rec['trace_s']}s"
                     f" temp={ma['temp_size_in_bytes'] / 2 ** 30:.2f}GiB"
                     f" args={ma['argument_size_in_bytes'] / 2 ** 30:.2f}GiB"
                     f" flops={rec['cost_analysis']['flops']:.3e}")
        elif status == "error":
            failures += 1
            extra = " " + rec["error"][:200]
        print(f"[dryrun] {arch} x {shape} x {m}: {status}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
