"""llama-3.2-vision-11b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer adds
cross-attention to vision embeddings (8 cross layers over the 32-layer llama3
backbone = 40 total).  The vision frontend is a STUB: the caller passes
precomputed patch embeddings (B, 1600, 4096) as ``batch["encoder"]``.  Full attention ->
long_500k skipped."""
from .base import ATTN, CROSS_ATTN, DENSE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=128_256,
    period=(
        LayerSpec(ATTN, DENSE),
        LayerSpec(ATTN, DENSE),
        LayerSpec(ATTN, DENSE),
        LayerSpec(ATTN, DENSE),
        LayerSpec(CROSS_ATTN, DENSE),
    ),
    rope_theta=500_000.0,
    tie_embeddings=False,
    n_cross_tokens=1600,
    d_cross=4096,
    act="silu",
)
