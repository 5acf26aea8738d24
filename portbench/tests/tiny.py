"""A cell of the benchmark at a tiny size, for the CPU: the same runners,
references and comparisons, on a two-layer model in f32."""
from __future__ import annotations

import copy

from yardstick import counting as N
from yardstick import spec

TINY_MODEL = {"name": "tiny", "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
              "d_ff": 96, "vocab": 128, "rope_theta": 10000.0, "act": "gelu",
              "frontend": "embeds", "dtype": "float32", "remat_policy": "block"}

TRAFFIC = {
    "prefill": {"kind": "prefill", "clients": 2, "prompt_len": 16, "max_len": 20,
                "warmup_waves": 1, "sample_from": 1, "sampled_waves": 1, "traced_waves": 1},
    "tune": {"kind": "tune", "dtype": "float32", "m": [16], "kn": [[16, 24], [24, 16]],
             "max_evals": 3, "budget_s": 30, "traced_contractions": 1},
    "train": {"kind": "train", "batch": 2, "seq_len": 16, "checked_steps": 3,
              "traced_steps": 1},
}

CELLS = {"prefill": "musicgen-large.prefill-8x1024", "tune": "musicgen-large.tune-prefill",
         "train": "musicgen-large.train-8x1024"}


def cell(kind: str, frontend: str = "embeds", act: str = "gelu") -> spec.Cell:
    """The committed cell of this kind, at the tiny size: its config's
    other settings, its limits and metrics."""
    real = spec.load_cell(CELLS[kind])
    model = dict(TINY_MODEL, frontend=frontend, act=act)
    config = copy.deepcopy(real.config)
    config["model"] = model
    config["reference"] = "musicgen_large" if act == "gelu" else "phi3_mini"
    traffic = TRAFFIC[kind]
    if kind == "prefill":
        keys = N.dense_keys(model, traffic["clients"] * traffic["prompt_len"])
        config["schedules"] = {"entries": [
            {"m": m, "k": k, "n": n, "dtype": dt, "gflops": 1.0,
             "block": {"m": 16, "k": 16, "n": 16}, "grid_order": ["m", "n", "k"]}
            for m, k, n, dt in keys]}
    return spec.Cell(real.name, 1, config, traffic, dict(real.limits), real.end_to_end,
                     real.per_layer)
