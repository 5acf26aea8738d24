"""One run of one cell: the kind's runner, then the result line."""
from __future__ import annotations

import importlib
import time
from typing import Dict, List

import torch

from . import compare as C
from . import spec


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> Dict:
    """The result object of one run, its checks last.  ``setup_s`` runs
    from ``t_start`` to the window's start, which the kind's runner marks."""
    kind = importlib.import_module(f"yardstick.kinds.{cell.traffic['kind']}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)   # the context, before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    marks: Dict[str, float] = {}
    out = kind.run(cell, seed, seconds, trace, device,
                   lambda: marks.setdefault("window", time.perf_counter()))
    checks = {name: {"value": out["numbers"].get(name, float("nan")), "limit": limit}
              for name, limit in cell.limits.items()}
    correct = C.judge(out["numbers"], cell.limits)
    e2e = dict(out["e2e"], setup_s=marks["window"] - t_start)
    if trace:
        metrics = spec.read_metrics(cell, out["run"])
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise SystemExit(f"{cell.name} reports {m['name']}, which its runner "
                                 f"did not measure")
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    tr = out["run"].trace
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops, "idle_gaps": tr.idle_gaps}
    result["checks"] = checks
    return result


def check_lines(checks: Dict) -> List[str]:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
