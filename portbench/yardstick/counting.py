"""Operations, bytes and model FLOPs, counted by the benchmark from shapes.

Nothing here is imported from the program: the dense sites, the model
FLOPs (a copy of the arithmetic of ``analysis/roofline.model_flops``:
causal pairs halved, the logits counted) and the kernels' useful work are
worked out again from the configuration, so a later change to the program
cannot change the yardstick.  A kernel's bound is the larger of its
operations over the card's peak and its bytes over the card's bandwidth,
each input byte read once and each output byte written once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

#: NVIDIA H100 SXM (data sheet, dense, at 700 W): bf16 tensor-core FLOP/s,
#: HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass(frozen=True)
class DenseSite:
    """One kind of dense contraction of a prefill or training step:
    ``(m, k) @ (k, n)`` with its operand and output types, ``count`` times
    a step."""

    name: str
    m: int
    k: int
    n: int
    dtype: str
    out_dtype: str
    count: int

    @property
    def key(self) -> Tuple[int, int, int, str]:
        return (self.m, self.k, self.n, self.dtype)


def dense_sites(model: Dict, tokens: int) -> List[DenseSite]:
    """The dense sites of a decoder of attention + gated-MLP layers over
    ``tokens`` rows (batch and sequence folded into m): the q, k, v and o
    projections, the gate, up and down projections a layer, and the head
    (f32 out) once."""
    d, hd = model["d_model"], model["d_model"] // model["n_heads"]
    hq, hkv = model["n_heads"] * hd, model["n_kv_heads"] * hd
    ff, vocab, layers, dt = model["d_ff"], model["vocab"], model["n_layers"], model["dtype"]
    per_layer = [("wq", d, hq), ("wk", d, hkv), ("wv", d, hkv), ("wo", hq, d),
                 ("w_gate", d, ff), ("w_up", d, ff), ("w_down", ff, d)]
    sites = [DenseSite(name, tokens, k, n, dt, dt, layers) for name, k, n in per_layer]
    sites.append(DenseSite("lm_head", tokens, d, vocab, dt, "float32", 1))
    return sites


def dense_keys(model: Dict, tokens: int) -> Dict[Tuple[int, int, int, str], int]:
    """Launches a step of each registry key (m, k, n, dtype)."""
    out: Dict[Tuple[int, int, int, str], int] = {}
    for s in dense_sites(model, tokens):
        out[s.key] = out.get(s.key, 0) + s.count
    return out


def matmul_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def matmul_bytes(m: int, k: int, n: int, dtype: str, out_dtype: str) -> float:
    return float((m * k + k * n) * DTYPE_BYTES[dtype] + m * n * DTYPE_BYTES[out_dtype])


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS,
            bandwidth: float = HBM_BYTES_PER_S) -> float:
    """The least time the card could take: max(operations / peak, bytes /
    bandwidth)."""
    return max(flops / peak, nbytes / bandwidth)


def dense_bound_s(sites: List[DenseSite], steps: int) -> float:
    """Sum over ``steps`` steps of each dense launch's bound."""
    return steps * sum(s.count * bound_s(matmul_flops(s.m, s.k, s.n),
                                         matmul_bytes(s.m, s.k, s.n, s.dtype, s.out_dtype))
                       for s in sites)


def causal_pairs(s: int) -> float:
    """(query, key) pairs a causal mask keeps over ``s`` positions, the
    diagonal included."""
    return s * (s + 1) / 2.0


def flash_fwd_work(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int,
                   dtype: str = "bfloat16") -> Tuple[float, float]:
    """(operations, bytes) of one causal flash forward: QK^T and PV over the
    kept pairs; q, k and v read once, o written once."""
    flops = 4.0 * causal_pairs(seq) * head_dim * heads * batch
    nbytes = batch * seq * head_dim * (2 * heads + 2 * kv_heads) * DTYPE_BYTES[dtype]
    return flops, float(nbytes)


def flash_bwd_work(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int,
                   dtype: str = "bfloat16") -> Tuple[float, float]:
    """(operations, bytes) of one causal flash backward.  Useful operations:
    the four products of attention's gradient over the kept pairs (dP =
    dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q); recomputing S = QK^T is
    remat and not counted.  Bytes: q, k, v, o, dO and the f32 lse read once,
    dq, dk and dv written once."""
    flops = 8.0 * causal_pairs(seq) * head_dim * heads * batch
    elem = DTYPE_BYTES[dtype]
    q_like = batch * seq * heads * head_dim * elem        # q, o, dO, dq
    kv_like = batch * seq * kv_heads * head_dim * elem    # k, v, dk, dv
    lse = batch * heads * seq * 4
    return flops, float(4 * q_like + 4 * kv_like + lse)


def model_flops(model: Dict, batch: int, seq: int, kind: str) -> float:
    """Useful FLOPs of one step (the arithmetic of the program's
    ``analysis/roofline.model_flops`` for a decoder of full-attention,
    dense-MLP layers): 2 N per token over the matmul parameters N (no
    embedding gather, the head counted as the logits), the attention's
    4 D H per causal pair (halved: s^2 / 2), and 3x the forward for
    training (no remat recompute)."""
    d, hd = model["d_model"], model["d_model"] // model["n_heads"]
    hq, hkv = model["n_heads"] * hd, model["n_kv_heads"] * hd
    per_layer = d * hq + 2 * d * hkv + hq * d + 3 * d * model["d_ff"]
    n_mat = model["n_layers"] * per_layer
    tokens = batch * seq
    fwd = 2.0 * n_mat * tokens + 2.0 * d * model["vocab"] * tokens
    fwd += batch * model["n_layers"] * 4.0 * (seq * seq / 2.0) * model["n_heads"] * hd
    if kind == "train":
        return 3.0 * fwd
    if kind == "prefill":
        return fwd
    raise ValueError(f"model_flops: kind {kind!r} is train or prefill")
