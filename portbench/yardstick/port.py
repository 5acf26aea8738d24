"""The system under test, as the benchmark reaches it: the PyTorch and CUDA
package ``repro_torch`` and nothing else of the repository.  The
configuration's model becomes the program's ``ModelConfig``; the tuned
schedules of the configuration's file become the program's
``ScheduleRegistry``, stamped for the card at hand."""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Tuple


def model_config(model: Dict):
    from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig

    return ModelConfig(
        name=model["name"], n_layers=model["n_layers"], d_model=model["d_model"],
        n_heads=model["n_heads"], n_kv_heads=model["n_kv_heads"], d_ff=model["d_ff"],
        vocab=model["vocab"], period=(LayerSpec(ATTN, DENSE),),
        rope_theta=float(model["rope_theta"]), act=model["act"],
        frontend=model["frontend"], tie_embeddings=False, dtype=model["dtype"],
        remat_policy=model.get("remat_policy", "block"))


def schedule_registry(schedules: Dict, needed: Iterable[Tuple[int, int, int, str]],
                      name: str):
    """A ``ScheduleRegistry`` holding the committed schedules, stamped for
    this card and the card executor, written under ``TMPDIR`` and loaded
    through the registry's own constructor.  Raises when a key the cell
    needs has no schedule."""
    from repro_torch.core.registry import ScheduleRegistry, current_hardware

    have = {(e["m"], e["k"], e["n"], e["dtype"]): e for e in schedules["entries"]}
    missing = [k for k in needed if k not in have]
    if missing:
        raise SystemExit(f"the configuration's schedules miss keys the cell serves: {missing}")
    hw = current_hardware()
    entries = {}
    for (m, k, n, dt), e in have.items():
        sk = ScheduleRegistry.key("mm", (m, k, n), dt)
        entries[ScheduleRegistry.record_key(sk, "torch", hw)] = {
            "gflops": float(e["gflops"]), "actions": list(e.get("actions", [])),
            "structure_key": sk, "backend": "torch", "hardware": hw,
            "block": {kk: int(v) for kk, v in e["block"].items()},
            "grid_order": list(e["grid_order"])}
    folder = Path(tempfile.gettempdir()) / "portbench"
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / f"{name}.registry.json"
    path.write_text(json.dumps({"version": 2, "entries": entries}, indent=1))
    reg = ScheduleRegistry(str(path))
    os.unlink(path)
    return reg
