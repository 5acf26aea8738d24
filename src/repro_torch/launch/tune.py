"""Offline tuning pre-pass of the port: harvest a model's contractions, tune,
persist.

This is the "tune once, off the request path" half of schedule serving: run
the model config's serving steps (one prefill, one decode) at the serving
shapes under an empty schedule registry, read back the workload keys every
dense site looked up (``kernels.ops.serving_stats``: exactly the keys the
server will look up, with their counts), and spend the tuning budget
proportionally to each contraction's executed-FLOP share so the dominant
shapes get tuned hardest.  Best schedules land in a
:class:`~repro_torch.core.registry.ScheduleRegistry` table that
``launch/serve --registry`` consumes.

    PYTHONPATH=src python -m repro_torch.launch.tune --arch musicgen-large \\
        --full --registry /path/to/musicgen.json --batch 4 --prompt-len 256 \\
        --max-len 512 --budget-s 60

The harvest holds the dense sites only (those that go through
``tuned_einsum``): attention's products run in the flash-attention kernel
and are never served from the registry.  Rewards are timed on the card
(``--backend torch``) by default; ``--device cpu`` with ``--backend tpu``
or ``numpy`` runs without one.

Tuning is **crash-resumable**: per-contraction results append to a JSONL
journal (default ``<registry>.journal.jsonl``, the JAX package's format)
the moment each contraction finishes, and the registry flushes
(lock-merge-save) at the same granularity — so a kill loses at most the
contraction in flight.  ``--resume`` reloads the journal and re-tunes only
the unfinished contractions.

``--farm HOST:PORT`` times on a measurement farm
(``repro_torch.launch.measure_farm``, or the JAX package's: the wire is
the same); ``--backend`` then names the local fallback a client degrades
to when the farm is unreachable, which for ``torch`` raises where there is
no card.  ``--fleet N`` runs N tuner clients against that one farm.
``--kernel-cache`` (default ``<registry>.kernels``, ``off`` disables)
is the persistent kernel store the card executor's libraries build
through: a second run, or a second process, runs no ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.backend import make_backend
from repro_torch.core.loop_ir import matmul_benchmark
from repro_torch.core.registry import ScheduleRegistry
from repro_torch.core.rl_common import epsilon_ladder
from repro_torch.core.torch_backend import resolve_device
from repro_torch.core.tuner import LoopTuner


class TuneJournal:
    """Append-only JSONL ledger of per-contraction tune results.

    One line per finished contraction: ``{"key": ..., "entry": {...}}``,
    flushed + fsynced on append so a SIGKILL after contraction *i* leaves
    lines 0..i durable.  :meth:`load` tolerates a torn trailing line (the
    one write a crash can interrupt) by ignoring it; torn lines *elsewhere*
    are warned about and skipped — progress is best-effort recovered, never
    corrupted.  Keys are workload signatures (:meth:`key_of`), so a resume
    matches by what was tuned, not by position.  The format is the JAX
    package's: a journal written by either package resumes in the other.
    """

    def __init__(self, path: str):
        self.path = path

    @staticmethod
    def key_of(m: int, k: int, n: int, dtype: str = "float32") -> str:
        return f"mm:{m}x{k}x{n}:{dtype}"

    def load(self) -> Dict[str, Dict[str, Any]]:
        done: Dict[str, Dict[str, Any]] = {}
        if not os.path.exists(self.path):
            return done
        with open(self.path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                done[str(rec["key"])] = dict(rec["entry"])
            except (ValueError, KeyError, TypeError):
                if i == len(lines) - 1:
                    continue  # torn tail: the interrupted final append
                warnings.warn(
                    f"tune journal {self.path}: skipping corrupt line "
                    f"{i + 1} (not the tail — was the file edited?)",
                    stacklevel=2)
        return done

    def append(self, key: str, entry: Dict[str, Any]) -> None:
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        line = json.dumps({"key": key, "entry": entry}, default=str)
        # one write() call per line on a fresh O_APPEND handle, so writers
        # appending concurrently never interleave mid-line
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def reset(self) -> None:
        """Start a fresh session (non-resume runs must not inherit a stale
        journal, or a later --resume would skip work it never did)."""
        if os.path.exists(self.path):
            os.unlink(self.path)


def harvest_model(
    cfg,
    *,
    batch: int = 4,
    prompt_len: int = 24,
    max_len: int = 64,
    kinds: Sequence[str] = ("decode", "prefill"),
    device="cuda",
) -> List[Dict[str, Any]]:
    """Executed dense contractions of a model's serving steps.

    Builds the model on ``device`` (random weights from seed 0; ``"cuda"``
    raises without a card) and runs one step of each kind at the serving
    shapes — the prefill of ``batch`` prompts of ``prompt_len`` (with seeded
    encoder states where the config has cross layers, as the reference's
    input specs give them), a decode step against a cache of ``max_len`` —
    under an empty registry, so every
    dense site records its workload key as a miss
    (``kernels.ops.serving_stats``, whose counters this resets).  Batch
    dims fold into m, as ``tuned_einsum`` folds them.  Returns records
    ``{m, k, n, dtype, count, flops, flop_share}`` aggregated across step
    kinds, sorted by executed FLOPs (2·m·k·n·count); the model is freed
    before returning.
    """
    from repro_torch.kernels import ops as K
    from repro_torch.launch.serve import init_model, input_fn
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T

    for kind in kinds:
        if kind not in ("decode", "prefill"):
            raise ValueError(f"unknown step kind {kind!r}")
    dev = resolve_device(device)
    params = init_model(cfg, 0, dev)
    make_inputs = input_fn(cfg, dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (batch, prompt_len))
    empty = ScheduleRegistry()
    agg: Dict[Tuple[int, int, int, str], Dict[str, float]] = {}
    K.reset_serving_stats()
    for kind in kinds:
        if kind == "decode":
            caches = T.init_cache(cfg, batch, max_len, device=dev)
            S.make_decode_step(cfg, registry=empty)(
                params, make_inputs(prompts[:, -1:]), caches, prompt_len)
            del caches
        else:
            inputs = make_inputs(prompts)
            if cfg.n_cross_tokens:
                inputs["encoder"] = torch.as_tensor(np.random.default_rng(0).standard_normal(
                    (batch, cfg.n_cross_tokens, cfg.d_cross), dtype=np.float32), device=dev)
            S.make_prefill_step(cfg, max_len=max_len, registry=empty)(params, inputs)
        for key, c in K.serving_stats(reset=True)["per_key"].items():
            _, dims, dtype = key.split(":")
            m, k, n = map(int, dims.split("x"))
            count = c["hits"] + c["misses"]
            slot = agg.setdefault((m, k, n, dtype), {"count": 0.0, "flops": 0.0})
            slot["count"] += count
            slot["flops"] += 2.0 * m * k * n * count
    del params
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    total = sum(s["flops"] for s in agg.values()) or 1.0
    out = [
        {"m": m, "k": k, "n": n, "dtype": dt, "count": s["count"],
         "flops": s["flops"], "flop_share": s["flops"] / total}
        for (m, k, n, dt), s in agg.items()
    ]
    out.sort(key=lambda r: -r["flops"])
    return out


def tune_records(
    kept: Sequence[Dict[str, Any]],
    *,
    tuner: LoopTuner,
    registry: ScheduleRegistry,
    registry_path: Optional[str] = None,
    budget_s: float = 4.0,
    eval_budget: Optional[int] = None,
    journal: Optional[TuneJournal] = None,
    resume: bool = False,
) -> Tuple[List[Dict[str, Any]], int]:
    """Tune harvested contraction records with journaled checkpoints.

    Each record needs ``m/k/n/dtype`` and ``flop_share`` (budget weight).
    As each contraction finishes, its entry appends to ``journal`` and the
    registry flushes (lock-merge-save) — crash granularity is one
    contraction.  With ``resume``, records whose journal key is already
    present are skipped (their journaled entries returned in place) and
    the remaining budget is scaled to the remaining FLOP share.  Returns
    ``(entries aligned with kept, n_skipped)``.
    """
    kept = list(kept)
    keys = [TuneJournal.key_of(r["m"], r["k"], r["n"], r["dtype"])
            for r in kept]
    done: Dict[str, Dict[str, Any]] = {}
    if journal is not None:
        if resume:
            done = journal.load()
        else:
            journal.reset()
    todo = [i for i, k in enumerate(keys) if k not in done]
    entries: List[Optional[Dict[str, Any]]] = [
        None if k not in done else dict(done[k], resumed=True)
        for k in keys]
    if not todo:
        return [e for e in entries if e is not None], len(kept)

    total_share = sum(r["flop_share"] for r in kept) or 1.0
    todo_share = sum(kept[i]["flop_share"] for i in todo) or 1.0
    flush_path = registry_path or registry.path

    def on_entry(j: int, entry: Dict[str, Any]) -> None:
        i = todo[j]
        entries[i] = entry
        if journal is not None:
            journal.append(keys[i], entry)
        # flush, not save: concurrent writers must not lose each other's
        # records
        if flush_path:
            registry.flush(flush_path)

    tuner.tune_many(
        [matmul_benchmark(kept[i]["m"], kept[i]["k"], kept[i]["n"])
         for i in todo],
        kernel="mm",
        weights=[kept[i]["flop_share"] / todo_share for i in todo],
        dtypes=[kept[i]["dtype"] for i in todo],
        budget_s=budget_s * (todo_share / total_share),
        eval_budget=(max(len(todo),
                         int(round(eval_budget * todo_share / total_share)))
                     if eval_budget is not None else None),
        on_entry=on_entry)
    return [e for e in entries if e is not None], len(kept) - len(todo)


def _device_kwargs(backend: Any, device) -> Dict[str, Any]:
    """The card executor's device: it times on the harvest's device."""
    return {"device": device} if backend in ("torch", "auto") else {}


def tune_records_fleet(
    kept: Sequence[Dict[str, Any]],
    *,
    n_clients: int,
    farm: str,
    backend: str = "torch",
    policy: str = "search",
    checkpoint: Optional[str] = None,
    registry_path: Optional[str] = None,
    budget_s: float = 4.0,
    eval_budget: Optional[int] = None,
    journal: Optional[TuneJournal] = None,
    resume: bool = False,
    kernel_cache: Optional[str] = None,
    device="cuda",
) -> Tuple[List[Dict[str, Any]], int, List[Dict[str, Any]]]:
    """``--fleet N``: N concurrent tuner clients against one farm.

    The Ape-X scale-out shape applied to tuning: the fleet runs N tuner
    clients (each its own :class:`LoopTuner` + pipelined farm connection,
    ranked on the ε ladder for identity/telemetry) against one measurement
    farm.  Contractions shard round-robin across clients, so every client
    keeps its own pipeline full — frontier generation on the client
    overlapping ticketed measurement on the farm — and the farm's fair
    queue interleaves their batches.  ``backend`` is each client's local
    fallback (with ``device`` for the card executor).

    Crash safety is the single-client story shared: all clients append to
    one :class:`TuneJournal` (line-atomic, lock-serialized) and flush
    per-client :class:`ScheduleRegistry` instances to the same path
    (flock-merged), so a kill loses at most one contraction per client.
    ``budget_s`` is the same *total* a single client would spend, so the
    fleet finishes ~N× sooner rather than spending N× more.

    Returns ``(entries aligned with kept, n_skipped, per-client reports)``.
    """
    kept = list(kept)
    keys = [TuneJournal.key_of(r["m"], r["k"], r["n"], r["dtype"])
            for r in kept]
    done: Dict[str, Dict[str, Any]] = {}
    if journal is not None:
        if resume:
            done = journal.load()
        else:
            journal.reset()
    todo = [i for i, k in enumerate(keys) if k not in done]
    entries: List[Optional[Dict[str, Any]]] = [
        None if k not in done else dict(done[k], resumed=True)
        for k in keys]
    if not todo:
        return [e for e in entries if e is not None], len(kept), []

    total_share = sum(r["flop_share"] for r in kept) or 1.0
    shards = [todo[c::n_clients] for c in range(n_clients)]
    shards = [s for s in shards if s]
    eps = epsilon_ladder(max(len(shards), 1))
    lock = threading.Lock()
    client_reports: List[Optional[Dict[str, Any]]] = [None] * len(shards)
    errors: List[BaseException] = []

    def run_client(c: int, shard: List[int]) -> None:
        t0 = time.perf_counter()
        # per-client farm connection: its own fair-queue identity, its own
        # pipelined submit/collect window, its own degradation state
        be = make_backend("remote", addr=farm, fallback=backend,
                          fallback_kwargs=_device_kwargs(backend, device),
                          client_id=f"tune-{c}")
        registry = ScheduleRegistry(registry_path)
        try:
            if checkpoint is not None:
                tuner = LoopTuner.from_checkpoint(checkpoint, backend=be,
                                                  registry=registry,
                                                  cache_dir=kernel_cache,
                                                  device=device)
            else:
                tuner = LoopTuner(policy=policy, backend=be, registry=registry,
                                  cache_dir=kernel_cache, device=device)
            shard_share = sum(kept[i]["flop_share"] for i in shard) or 1.0

            def on_entry(j: int, entry: Dict[str, Any]) -> None:
                i = shard[j]
                with lock:
                    entries[i] = entry
                    if journal is not None:
                        journal.append(keys[i], entry)
                if registry_path:
                    registry.flush(registry_path)

            tuner.tune_many(
                [matmul_benchmark(kept[i]["m"], kept[i]["k"], kept[i]["n"])
                 for i in shard],
                kernel="mm",
                weights=[kept[i]["flop_share"] / shard_share for i in shard],
                dtypes=[kept[i]["dtype"] for i in shard],
                budget_s=budget_s * (shard_share / total_share),
                eval_budget=(max(len(shard),
                                 int(round(eval_budget * shard_share
                                           / total_share)))
                             if eval_budget is not None else None),
                on_entry=on_entry)
            client_reports[c] = {
                "client": be.client_id,
                "eps": round(float(eps[c]), 4),
                "n_tuned": len(shard),
                "wall_s": round(time.perf_counter() - t0, 3),
                "farm": be.farm_stats(),
            }
        except BaseException as e:  # surfaced to the caller, not swallowed
            with lock:
                errors.append(e)
        finally:
            be.close()

    threads = [threading.Thread(target=run_client, args=(c, shard),
                                name=f"tune-fleet-{c}", daemon=True)
               for c, shard in enumerate(shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return ([e for e in entries if e is not None], len(kept) - len(todo),
            [r for r in client_reports if r is not None])


def tune_model(
    cfg_or_arch,
    *,
    registry: Optional[ScheduleRegistry] = None,
    registry_path: Optional[str] = None,
    tuner: Optional[LoopTuner] = None,
    checkpoint: Optional[str] = None,
    backend: Any = "torch",
    policy: str = "search",
    budget_s: float = 4.0,
    eval_budget: Optional[int] = None,
    max_contractions: int = 12,
    smoke: bool = True,
    batch: int = 4,
    prompt_len: int = 24,
    max_len: int = 64,
    kinds: Sequence[str] = ("decode", "prefill"),
    kernel_cache: Optional[str] = None,
    farm: Optional[str] = None,
    fleet: int = 1,
    journal_path: Optional[str] = None,
    resume: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """Tune every dense contraction a model config serves; persist the table.

    ``budget_s`` (and ``eval_budget``, when given) are *totals* for the
    whole model, split across the deduped contractions by executed-FLOP
    share — the contraction that dominates gets the budget.  The harvest,
    the card executor (``backend="torch"``) and the policy network of a
    ``checkpoint`` run on ``device`` (``"cuda"`` raises without a card).
    ``kernel_cache`` names the persistent kernel store dir the card
    executor's libraries build through.  ``farm`` times on a measurement
    farm (``backend`` becomes the local fallback), ``fleet > 1`` with
    N clients against it.  Returns a report dict (harvested/tuned counts,
    per-entry summaries, coverage of the executed FLOPs, the farm and fleet
    counters).
    """
    if fleet > 1 and (farm is None or tuner is not None):
        raise ValueError("--fleet N needs --farm (N clients share one "
                         "measurement farm) and builds its own per-client "
                         "tuners")
    t0 = time.perf_counter()
    cfg = get_config(cfg_or_arch) if isinstance(cfg_or_arch, str) else cfg_or_arch
    if smoke and not cfg.name.endswith("-smoke"):
        cfg = cfg.smoke()
    if registry is None:
        registry = ScheduleRegistry(registry_path)
    if tuner is None and fleet <= 1:
        if farm is not None:
            # timings come from a remote measurement farm; ``backend``
            # becomes the local fallback the client degrades to if the farm
            # is unreachable (a tune is never failed by the farm)
            tune_backend = make_backend("remote", addr=farm, fallback=backend,
                                        fallback_kwargs=_device_kwargs(backend, device))
        elif backend in ("torch", "auto"):
            # the card executor times on the harvest's device, its
            # libraries built through the kernel store
            tune_backend = make_backend(backend, device=device, cache_dir=kernel_cache)
        else:
            tune_backend = backend
        if checkpoint is not None:
            tuner = LoopTuner.from_checkpoint(checkpoint, backend=tune_backend,
                                              registry=registry, device=device,
                                              cache_dir=kernel_cache)
        else:
            tuner = LoopTuner(policy=policy, backend=tune_backend,
                              registry=registry, device=device,
                              cache_dir=kernel_cache)

    records = harvest_model(cfg, batch=batch, prompt_len=prompt_len,
                            max_len=max_len, kinds=kinds, device=device)
    kept = records[:max_contractions]
    share_kept = sum(r["flop_share"] for r in kept)

    journal = TuneJournal(journal_path) if journal_path else None
    fleet_report: Optional[Dict[str, Any]] = None
    if fleet > 1:
        entries, n_skipped, clients = tune_records_fleet(
            kept, n_clients=fleet, farm=farm, backend=backend,
            policy=policy, checkpoint=checkpoint,
            registry_path=registry_path, budget_s=budget_s,
            eval_budget=eval_budget, journal=journal, resume=resume,
            kernel_cache=kernel_cache, device=device)
        # fleet-mode flushes land per client; re-read so report counts and
        # a final save reflect the merged table
        if registry_path and os.path.exists(registry_path):
            registry = ScheduleRegistry(registry_path)
        fleet_report = {
            "n_clients": fleet,
            "clients": clients,
            # farm totals across the fleet: the aggregate pipelining view
            "tickets_submitted": sum(
                c["farm"].get("tickets_submitted", 0) for c in clients),
            "tickets_collected": sum(
                c["farm"].get("tickets_collected", 0) for c in clients),
            "tickets_resubmitted": sum(
                c["farm"].get("tickets_resubmitted", 0) for c in clients),
        }
    else:
        entries, n_skipped = tune_records(
            kept, tuner=tuner, registry=registry, registry_path=registry_path,
            budget_s=budget_s, eval_budget=eval_budget,
            journal=journal, resume=resume)

    path = registry_path or registry.path
    if path:
        registry.flush(path)
    tb = tuner.backend if tuner is not None else None
    compile_stats = getattr(tb, "compile_stats", None)
    farm_stats = getattr(tb, "farm_stats", None)
    return {
        "arch": cfg.name,
        "kinds": list(kinds),
        "shapes": {"batch": batch, "prompt_len": prompt_len,
                   "max_len": max_len},
        "n_harvested": len(records),
        "n_tuned": len(entries),
        "n_skipped": n_skipped,
        "resumed": bool(resume),
        "journal": journal_path,
        "flop_share_covered": share_kept,
        "registry_size": len(registry),
        "registry_path": registry_path or registry.path,
        "kernel_cache": kernel_cache,
        "compile": compile_stats() if compile_stats is not None else None,
        "farm": farm_stats() if farm_stats is not None else None,
        "fleet": fleet_report,
        "tune_time_s": round(time.perf_counter() - t0, 2),
        "contractions": [
            {"m": r["m"], "k": r["k"], "n": r["n"], "dtype": r["dtype"],
             "count": r["count"], "flop_share": round(r["flop_share"], 4),
             "gflops": e.get("gflops"),
             "base_gflops": e.get("base_gflops"),
             "resumed": bool(e.get("resumed", False))}
            for r, e in zip(kept, entries)
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--registry", required=True, help="registry JSON path")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the smoke config)")
    ap.add_argument("--checkpoint", default=None,
                    help="trained policy checkpoint (default: search)")
    ap.add_argument("--backend", default="torch",
                    help="reward source: torch (the card), tpu or numpy")
    ap.add_argument("--device", default="cuda",
                    help="where the harvest, the card executor and a policy "
                         "network run: cuda, or cpu")
    ap.add_argument("--budget-s", type=float, default=4.0)
    ap.add_argument("--eval-budget", type=int, default=None)
    ap.add_argument("--max-contractions", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--kernel-cache", default=None,
                    help="persistent kernel store dir for the card "
                         "executor's libraries (default: <registry>.kernels; "
                         "'off' disables)")
    ap.add_argument("--farm", default=None, metavar="HOST:PORT",
                    help="measure on a remote farm (repro_torch.launch."
                         "measure_farm); --backend becomes the local "
                         "fallback if the farm is unreachable")
    ap.add_argument("--fleet", type=int, default=1, metavar="N",
                    help="run N concurrent tuner clients against the one "
                         "--farm (contractions shard round-robin; each "
                         "client pipelines ticketed measurements on its "
                         "own connection; requires --farm)")
    ap.add_argument("--journal", default=None,
                    help="per-contraction JSONL progress ledger (default: "
                         "<registry>.journal.jsonl; 'off' disables)")
    ap.add_argument("--resume", action="store_true",
                    help="skip contractions already in the journal (after "
                         "a crash/kill: re-tunes only unfinished work)")
    args = ap.parse_args(argv)

    # the kernel store lives beside the registry by default: the libraries
    # and the schedules they serve travel (and get wiped) together
    kernel_cache: Optional[str]
    if args.kernel_cache == "off":
        kernel_cache = None
    elif args.kernel_cache is None:
        kernel_cache = args.registry + ".kernels"
    else:
        kernel_cache = args.kernel_cache

    # the journal lives beside the registry by default, same reasoning as
    # the kernel store: session state and its output travel together
    journal_path: Optional[str]
    if args.journal == "off":
        journal_path = None
    elif args.journal is None:
        journal_path = args.registry + ".journal.jsonl"
    else:
        journal_path = args.journal

    report = tune_model(
        args.arch, registry_path=args.registry, checkpoint=args.checkpoint,
        backend=args.backend, budget_s=args.budget_s,
        eval_budget=args.eval_budget, max_contractions=args.max_contractions,
        smoke=not args.full, batch=args.batch, prompt_len=args.prompt_len,
        max_len=args.max_len, kernel_cache=kernel_cache, farm=args.farm, fleet=args.fleet, journal_path=journal_path,
        resume=args.resume, device=args.device)
    print("[tune]", json.dumps(report, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
