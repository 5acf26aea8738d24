"""Roofline terms per (arch x shape x mesh), with the H100's constants.

The JAX package's ``analysis/roofline.py`` with NVIDIA H100 SXM numbers in
place of its TPU v5e ones: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, 450 GB/s
per NVLink direction, and the card's memory for ``fits_hbm``.  All
quantities are **per device**:

    compute    = flops / PEAK
    memory     = mem_bytes / HBM_BW
    collective = coll_bytes / LINK_BW

The step-time estimate is ``max`` of the three (each engine overlaps the
others at steady state); the reported roofline fraction is

    MODEL_FLOPS_per_device / (PEAK * t_step)

with MODEL_FLOPS the *useful* analytic flops: 6·N·D for training (2·N·D
forward, 4·N·D backward — remat recompute intentionally excluded so the
ratio exposes it), 2·N·D for prefill, 2·N·B per decode step, N = active
matmul params (embedding lookups excluded, logits matmul counted
explicitly), plus the exact per-layer attention term.  A record has the
reference's schema (``status``, ``arch``, ``shape``, ``mesh``,
``mesh_shape``, ``cost_analysis``, ``corrected``, ``collective_bytes``,
``memory_analysis``); the port has no HLO, so its records come from
measurements or from the caller, and ``analysis/hlo_parse.py`` has no
counterpart.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ATTN, ATTN_LOCAL, CROSS_ATTN, MAMBA, RWKV6

# NVIDIA H100 SXM, per card: the dense bf16 tensor-core peak, HBM3's rate
# and one direction of NVLink 4 (18 links of 25 GB/s)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
# the card's device memory: torch.cuda.get_device_properties(0).total_memory
# is 85,017,493,504 bytes on an NVIDIA H100 80GB HBM3 at 700.00 W
# (chip_smoke.py phase dist_roofline reads it and holds this constant to it)
HBM_GIB = 85_017_493_504 / 2 ** 30


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def _matmul_params(cfg) -> int:
    """Active params that participate in matmuls (per token), excluding the
    embedding table lookup and the logits head (counted separately)."""
    n = cfg.active_param_count()
    n -= cfg.vocab * cfg.d_model  # embed lookup is a gather, not a matmul
    if not cfg.tie_embeddings:
        n -= cfg.vocab * cfg.d_model  # lm_head counted via the logits term
    return max(n, 0)


def _attn_flops_per_layer(cfg, spec, seq: int, kv_len: Optional[int] = None
                          ) -> float:
    """QK^T + PV flops per sequence for one layer (per forward)."""
    if spec.mixer in (ATTN, ATTN_LOCAL, CROSS_ATTN):
        t = kv_len if kv_len is not None else seq
        if spec.mixer == ATTN_LOCAL and spec.window:
            # each query sees at most `window` keys
            eff = min(spec.window, t)
            pairs = seq * eff - (0 if kv_len else eff * (eff - 1) / 2)
        else:
            pairs = seq * t / (1.0 if kv_len else 2.0)  # causal halves it
        f = 4.0 * pairs * cfg.n_heads * cfg.head_dim_
        if spec.mixer == CROSS_ATTN:
            f += 4.0 * seq * cfg.n_cross_tokens * cfg.n_heads * cfg.head_dim_
        return f
    if spec.mixer == MAMBA:
        d_inner = cfg.ssm_expand * cfg.d_model
        return 6.0 * seq * d_inner * cfg.ssm_d_state
    if spec.mixer == RWKV6:
        h = cfg.d_model // cfg.rwkv_head_dim
        return 4.0 * seq * h * cfg.rwkv_head_dim ** 2
    return 0.0


def model_flops(cfg, cell) -> float:
    """Useful flops of ONE global step of the cell's kind."""
    n_mat = _matmul_params(cfg)
    b = cell.global_batch
    if cell.kind in ("train", "prefill"):
        s = cell.seq_len
        tokens = b * s
        fwd = 2.0 * n_mat * tokens
        fwd += 2.0 * cfg.d_model * cfg.vocab * tokens  # logits
        fwd += b * sum(_attn_flops_per_layer(cfg, sp, s)
                       for sp in cfg.period) * cfg.n_periods
        return 3.0 * fwd if cell.kind == "train" else fwd
    # decode: one token per sequence against a cell.seq_len cache
    s = cell.seq_len
    fwd = 2.0 * n_mat * b
    fwd += 2.0 * cfg.d_model * cfg.vocab * b
    fwd += b * sum(_attn_flops_per_layer(cfg, sp, 1, kv_len=s)
                   for sp in cfg.period) * cfg.n_periods
    return fwd


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device, loop-corrected
    flops: float
    mem_bytes: float
    coll_bytes: float
    # seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    t_step: float = 0.0
    model_flops_global: float = 0.0
    useful_ratio: float = 0.0       # model flops / executed HLO flops
    roofline_fraction: float = 0.0  # model-flops MFU at the binding roof
    hbm_gib: float = 0.0            # per-device residency (args + temp)
    fits_hbm: bool = True
    note: str = ""

    def finalize(self):
        self.t_compute = self.flops / PEAK_FLOPS
        self.t_memory = self.mem_bytes / HBM_BW
        self.t_collective = self.coll_bytes / LINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.dominant = max(terms, key=terms.get)
        self.t_step = max(terms.values())
        per_dev_model = self.model_flops_global / self.chips
        self.useful_ratio = per_dev_model / self.flops if self.flops else 0.0
        self.roofline_fraction = (
            per_dev_model / (PEAK_FLOPS * self.t_step) if self.t_step else 0.0)
        return self


def roofline_from_record(rec: dict, card_gib: float = HBM_GIB) -> Optional[RooflineTerms]:
    if rec.get("status") != "ok":
        return None
    cfg = get_config(rec["arch"])
    cell = SHAPES[rec["shape"]]
    chips = 1
    for v in rec["mesh_shape"].values():
        chips *= v
    corr = rec.get("corrected") or {}
    ma = rec.get("memory_analysis", {})
    hbm = (ma.get("argument_size_in_bytes", 0)
           + ma.get("temp_size_in_bytes", 0)) / 2 ** 30
    t = RooflineTerms(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
        flops=float(corr.get("flops") or rec["cost_analysis"].get("flops", 0)),
        mem_bytes=float(corr.get("mem_bytes")
                        or rec["cost_analysis"].get("bytes accessed", 0)),
        coll_bytes=float(corr.get("coll_bytes_total")
                         or sum(rec.get("collective_bytes", {}).values())),
        model_flops_global=model_flops(cfg, cell),
        hbm_gib=hbm,
        fits_hbm=hbm <= card_gib,
    )
    return t.finalize()


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


def load_all(results_dir: str, mesh: str = "single") -> List[RooflineTerms]:
    out = []
    for p in sorted(Path(results_dir).glob(f"*__{mesh}.json")):
        rec = json.loads(p.read_text())
        t = roofline_from_record(rec)
        if t is not None:
            out.append(t)
    return out


def roofline_table(results_dir: str, mesh: str = "single") -> str:
    rows = load_all(results_dir, mesh)
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| t_step s | useful | roofline | HBM GiB |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    body = ""
    for t in rows:
        body += (
            f"| {t.arch} | {t.shape} | {t.t_compute:.3e} | {t.t_memory:.3e} "
            f"| {t.t_collective:.3e} | **{t.dominant}** | {t.t_step:.3e} "
            f"| {t.useful_ratio:.2f} | {t.roofline_fraction:.1%} "
            f"| {t.hbm_gib:.1f}{'' if t.fits_hbm else ' ⚠'} |\n")
    return hdr + body
