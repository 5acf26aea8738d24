"""musicgen-large [audio] — arXiv:2306.05284.

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048; decoder-only over
EnCodec tokens.  The EnCodec frontend (4 codebooks, delay pattern) is a STUB:
the serve loop feeds frame embeddings (B, S, 2048); the LM head predicts the
next frame's code in the 2048-way codebook.  (RMSNorm/GELU-gated MLP/RoPE
family instead of MusicGen's LayerNorm/GELU/sinusoidal, as in the JAX
package.)  Full attention -> long_500k skipped."""
from .base import ATTN, DENSE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    period=(LayerSpec(ATTN, DENSE),),
    frontend="embeds",
    tie_embeddings=False,
    act="gelu",
)
