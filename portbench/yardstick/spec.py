"""What a cell is, found by name: ``BENCHMARK.json`` names each cell's
configuration and traffic, and each lives in a file of its own under
``portbench/``.

- ``configs/<config>.json``: the model as it is run (``model``), where it
  comes from, the precision and optimizer it states, the reference module
  under ``reference/`` and, for served schedules, ``schedules``;
- ``traffic/<traffic>.json``: the traffic's ``kind`` (the runner under
  ``yardstick/kinds/``) and its parameters;
- ``limits/<cell>.json``: the limit of each number ``correct`` compares;
- ``metrics/<metric>.py``: one reader a per-layer metric, ``read(run)``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def model(self) -> Dict:
        return self.config["model"]

    def reference(self):
        """The configuration's reference module (``reference/<module>.py``)."""
        return importlib.import_module(f"reference.{self.config['reference']}")


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())["limits"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in e2e_names and _reports(m, name)]
    return Cell(name, int(w["chips"]), config, traffic,
                {k: float(v) for k, v in limits.items()}, e2e, per_layer)


def metric_reader(name: str) -> Callable:
    """``read(run) -> Optional[float]`` of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(cell: Cell, run) -> Dict[str, Optional[float]]:
    """Each per-layer metric of the cell that its reader found."""
    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
