"""command-r-35b [dense] — hf:CohereForAI/c4ai-command-r-v01.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000; no-bias, parallel
attention+FFN block, tied embeddings.  Full attention -> long_500k skipped."""
from .base import DENSE, ATTN, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256_000,
    period=(LayerSpec(ATTN, DENSE),),
    rope_theta=8_000_000.0,
    parallel_block=True,
    tie_embeddings=True,
    act="silu",
)
