"""gemma3-12b [dense] — hf:google/gemma-3 family.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144; 5:1 local:global
(window 1024), qk-norm, post-norms, GeGLU, head_dim=256, 128k context
(we keep one rope_theta=1e6; the per-layer local/global theta split is a
documented deviation).  long_500k RUN."""
from .base import ATTN, ATTN_LOCAL, DENSE, LayerSpec, ModelConfig

_LOCAL = LayerSpec(ATTN_LOCAL, DENSE, window=1024)

CONFIG = ModelConfig(
    name="gemma3-12b",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab=262_144,
    period=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, LayerSpec(ATTN, DENSE)),
    rope_theta=1_000_000.0,
    qk_norm=True,
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    act="gelu",
    supports_long_context=True,
)
