"""Model configuration: one frozen dataclass per architecture.

The port's own copy of the reference package's ``ModelConfig`` (field for
field, so a config built on either side describes the same model).  Served
architectures live in their own modules under ``repro_torch.configs``;
``repro_torch.configs.registry`` maps ``--arch`` ids to them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  Families:

    - ``dense``   decoder-only transformer (llama-style)
    - ``moe``     decoder-only with MoE FFN layers (mixtral / deepseek style)
    - ``ssm``     attention-free Mamba2 (SSD) stack
    - ``hybrid``  Mamba2 blocks with a shared attention block every
                  ``attn_every`` layers (zamba2-style, simplified)
    - ``encdec``  encoder-decoder (whisper); frontend stubbed
    - ``vlm``     dense decoder with prepended patch embeddings (llava stub)
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // num_heads
    ffn_activation: str = "swiglu"         # swiglu | relu2 | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # SWA window (mixtral: 4096)
    tie_embeddings: bool = False
    attn_logit_softcap: Optional[float] = None

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                      # per-expert ffn dim (0 -> d_ff)
    first_dense_layers: int = 0            # leading dense-FFN layers (deepseek)
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001

    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0                    # 0 -> head_dim

    # --- SSM (mamba2 / zamba2) ---
    ssm_state_dim: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # --- hybrid ---
    attn_every: int = 6                    # zamba2: shared attn block cadence

    # --- encdec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500                # stub frontend frames

    # --- vlm (llava) ---
    num_patches: int = 0                   # stub frontend patches

    # --- numerics / distribution defaults (overridable per run) ---
    dtype: str = "bfloat16"
    attn_impl: str = "xla"            # xla: plain attention | kernel: the
                                      # flash-attention kernel for prefill
    remat: bool = True
    remat_policy: str = "full"        # full | selective (save matmul outputs)
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)
        if self.moe_d_ff == 0 and self.num_experts:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # ---- derived quantities -------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode: SSM/hybrid state or SWA rolling cache."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def num_moe_layers(self) -> int:
        if not self.is_moe:
            return 0
        return self.num_layers - self.first_dense_layers

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, in order."""
        if self.family == "ssm":
            return ("mamba",) * self.num_layers
        if self.family == "hybrid":
            return tuple(
                "attn" if (i % self.attn_every) == (self.attn_every - 1) else "mamba"
                for i in range(self.num_layers)
            )
        if self.family == "moe":
            return tuple(
                "dense" if i < self.first_dense_layers else "moe"
                for i in range(self.num_layers)
            )
        return ("dense",) * self.num_layers

    def reduced(self, **over) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=max(2, min(4, self.num_layers)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.family == "hybrid":
            small["num_layers"] = 4
            small["attn_every"] = 2
        if self.is_moe:
            small.update(
                num_experts=min(self.num_experts, 8),
                num_experts_per_tok=min(self.num_experts_per_tok, 2),
                moe_d_ff=64,
                first_dense_layers=min(self.first_dense_layers, 1),
                num_shared_experts=min(self.num_shared_experts, 1),
            )
        if self.use_mla:
            small.update(kv_lora_rank=32, q_lora_rank=0, rope_head_dim=16,
                         num_kv_heads=4, v_head_dim=16)
        if self.ssm_state_dim:
            small.update(ssm_state_dim=16, ssm_head_dim=16, ssm_chunk=16)
        if self.encoder_layers:
            small.update(encoder_layers=2, encoder_seq=8)
        if self.num_patches:
            small.update(num_patches=4)
        if self.sliding_window:
            small.update(sliding_window=16)
        small.update(over)
        small["name"] = self.name + "-reduced"
        return replace(self, **small)

