"""phi3-mini-3.8b [dense] — arXiv:2404.14219.

32L d_model=3072 32H (GQA kv=32 == MHA) d_ff=8192 vocab=32064; RoPE SwiGLU.
Full attention -> long_500k skipped."""
from .base import DENSE, ATTN, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    period=(LayerSpec(ATTN, DENSE),),
    rope_theta=10_000.0,
    tie_embeddings=False,
    act="silu",
)
