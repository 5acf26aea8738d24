"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887.

32L d_model=4096 32H (GQA kv=8, head dim 128) d_ff=14336 vocab=65536;
Mamba:attention 7:1 interleave with MoE (16 experts top-2) on every second
layer.  Period of 8 = [M, M*, M, A*, M, M*, M, M*] (A = attention at index
3; * = MoE FFN), the paper's Fig. 2 block.  Every prefill Mamba mixer runs
the hand-written selective-scan kernel (kernels/mamba_scan.py) and every
prefill attention the flash-attention kernel at head dim 128; decode is
plain.  The published 32 layers hold 51,570,315,264 parameters (~103 GB in
bf16), more than one 80 GB card: a one-card run cuts the depth to whole
periods with ``dataclasses.replace(CONFIG, n_layers=16)``."""
from .base import ATTN, DENSE, MAMBA, MOE, LayerSpec, MoEConfig, ModelConfig

_MOE = MoEConfig(n_experts=16, top_k=2, d_ff_expert=14_336)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=65_536,
    period=(
        LayerSpec(MAMBA, DENSE),
        LayerSpec(MAMBA, MOE),
        LayerSpec(MAMBA, DENSE),
        LayerSpec(ATTN, MOE),
        LayerSpec(MAMBA, DENSE),
        LayerSpec(MAMBA, MOE),
        LayerSpec(MAMBA, DENSE),
        LayerSpec(MAMBA, MOE),
    ),
    moe=_MOE,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    tie_embeddings=False,
    act="silu",
    supports_long_context=True,
)
