"""olmoe-1b-7b [moe] — arXiv:2409.02060.

16L d_model=2048 16H (GQA kv=16 == MHA) d_ff(expert)=1024 vocab=50304; 64
experts top-8 on every layer, qk-norm.  Full attention -> long_500k skipped."""
from .base import ATTN, MOE, LayerSpec, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50_304,
    period=(LayerSpec(ATTN, MOE),),
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    qk_norm=True,
    rope_theta=10_000.0,
    tie_embeddings=False,
    act="silu",
)
