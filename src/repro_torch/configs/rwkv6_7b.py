"""rwkv6-7b "Finch" [ssm] — arXiv:2404.05892.

32L d_model=4096 (attention-free, 64 heads of dim 64) d_ff=14336 vocab=65536;
data-dependent decay time-mix + squared-relu channel-mix.  Every prefill
time-mix runs the hand-written RWKV-6 chunked-scan kernel (kernels/
rwkv6_scan.py); decode is the plain single-token recurrence."""
from .base import DENSE, RWKV6, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # d_model / rwkv_head_dim (bookkeeping only)
    n_kv_heads=64,
    d_ff=14_336,
    vocab=65_536,
    period=(LayerSpec(RWKV6, DENSE),),
    rwkv_head_dim=64,
    tie_embeddings=False,
    supports_long_context=True,
)
