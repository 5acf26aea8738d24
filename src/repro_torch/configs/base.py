"""Model/config schema of the port (a copy of the JAX package's schema).

A model is a stack of ``n_layers`` transformer-ish blocks described by a
repeating **period** of :class:`LayerSpec` entries.  Every published config
in ``configs/<arch>.py`` is an instance of :class:`ModelConfig`; reduced
smoke-test variants are derived via :meth:`ModelConfig.smoke`.  The fields
are the JAX package's, so a config and its converted weights mean the same
thing in both packages; the port runs only the kinds its models support
(``models/transformer.py`` raises for the others).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Mixer kinds -----------------------------------------------------------------
ATTN = "attn"            # global causal self-attention
ATTN_LOCAL = "attn_local"  # sliding-window causal self-attention
MAMBA = "mamba"          # selective SSM (Jamba)
RWKV6 = "rwkv6"          # Finch time-mix (attention-free)
CROSS_ATTN = "cross_attn"  # self-attn + cross-attn to encoder states (VLM)

# FFN kinds --------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position within the repeating period."""

    mixer: str = ATTN
    ffn: str = DENSE
    window: Optional[int] = None  # sliding window for ATTN_LOCAL


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False  # llama4: always-on shared expert
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    dispatch_chunk: int = 65_536  # tokens per dispatch chunk (0 = no chunking)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    period: Tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: Optional[int] = None  # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    # attention details
    rope_theta: float = 10_000.0
    attn_softcap: Optional[float] = None    # gemma2
    logit_softcap: Optional[float] = None   # gemma2 final logits
    qk_norm: bool = False                   # gemma3
    attn_bias: bool = False
    # block structure
    parallel_block: bool = False            # command-r: x + attn(n(x)) + mlp(n(x))
    post_norm: bool = False                 # gemma2/3: norm after attn/mlp too
    act: str = "silu"                       # swiglu gate activation
    # embedding / head
    tie_embeddings: bool = True
    embed_scale: bool = False               # gemma: scale embeddings by sqrt(d)
    # modality frontend stubs
    frontend: str = "tokens"                # tokens | embeds (audio/vlm stub)
    n_cross_tokens: int = 0                 # encoder length for CROSS_ATTN
    d_cross: int = 0                        # encoder width for CROSS_ATTN
    # ssm details (mamba)
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    # rwkv details
    rwkv_head_dim: int = 64
    # numerics
    dtype: str = "bfloat16"
    # activation-checkpoint granularity (read by training, a later slice)
    remat_policy: str = "block"
    # long_500k only for sub-quadratic archs
    supports_long_context: bool = False

    # -- derived -------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.period) != 0:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not divisible "
                             f"by period={len(self.period)}")
        return self.n_layers // len(self.period)

    def param_count(self) -> int:
        """Total parameters of the port's own model (exact: counts the
        tensors ``init_params`` makes, built on the meta device)."""
        from repro_torch.models.transformer import count_params

        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters one token runs through: each routed MoE expert tensor
        counts ``top_k / n_experts`` of its size (the router and a shared
        expert count whole), as the JAX package counts them."""
        from repro_torch.models.transformer import count_params

        return count_params(self, active_only=True)

    # -- smoke-test reduction --------------------------------------------------

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests: keeps one full
        period, shrinks widths/vocab/experts."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=32,
                capacity_factor=8.0,
            )
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=len(self.period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=96,
            vocab=256,
            moe=moe,
            n_cross_tokens=8 if self.n_cross_tokens else 0,
            d_cross=32 if self.d_cross else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCell("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeCell, ...]:
    """The assigned shape set for an arch (long_500k only if sub-quadratic)."""
    if cfg.supports_long_context:
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)
