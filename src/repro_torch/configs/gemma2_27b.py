"""gemma2-27b [dense] — arXiv:2408.00118.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; local(4096):global
alternating, attn softcap 50, final-logit softcap 30, post-norms, GeGLU,
embeddings scaled by sqrt(d), head_dim=128.  Sliding-window layers bound the
decode working set -> long_500k RUN."""
from .base import ATTN, ATTN_LOCAL, DENSE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab=256_000,
    period=(
        LayerSpec(ATTN_LOCAL, DENSE, window=4096),
        LayerSpec(ATTN, DENSE),
    ),
    rope_theta=10_000.0,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    act="gelu",
    supports_long_context=True,
)
