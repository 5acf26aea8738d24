"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048; MoE 16 experts top-1
plus an always-on shared expert on every layer; 3:1 chunked-local(8192):global
attention.  Global full-attention layers -> long_500k skipped.  The 48
layers need 215.5 GB of bf16 weights: one card serves a depth cut of whole
4-layer periods."""
from .base import ATTN, ATTN_LOCAL, MOE, LayerSpec, MoEConfig, ModelConfig

_L = LayerSpec(ATTN_LOCAL, MOE, window=8192)

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    period=(_L, _L, _L, LayerSpec(ATTN, MOE)),
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, shared_expert=True),
    rope_theta=500_000.0,
    tie_embeddings=False,
    act="silu",
)
