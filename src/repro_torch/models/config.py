"""Model configuration of the port's language models.

A copy of ``repro.models.config.ModelConfig`` with torch dtypes: the
original imports ``jax.numpy``, so the port keeps its own.  Every field of
the original is kept, so that a configuration reads the same in both
packages, although the port runs only the dense GQA decoders, Mamba-2,
RecurrentGemma, their hybrids, MoE and the encoder-decoder so far
(``repro_torch.models.transformer.check_supported`` says which fields it
refuses).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"          # dense|moe|ssm|hybrid|vlm|audio|mlp
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: Optional[int] = None

    # cycled over layers; kinds: attn | swa | local | rglru | ssd
    block_pattern: Tuple[str, ...] = ("attn",)
    ffn_kind: str = "swiglu"          # swiglu | geglu | gelu | none

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_shared_experts: int = 0
    moe_d_ff: Optional[int] = None
    moe_first_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None      # sliding/local attention window
    rope_theta: float = 10000.0
    attn_kind: str = "gqa"            # gqa | mla

    # MLA (DeepSeek-V3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # SSM (Mamba-2)
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128

    # RG-LRU (RecurrentGemma)
    lru_width: Optional[int] = None

    # encoder-decoder (> 0 => enc-dec)
    encoder_layers: int = 0

    # tokens: ids -> embedding table; frames: continuous embeddings
    input_mode: str = "tokens"

    # multi-token prediction (DeepSeek-V3)
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    vocab_pad_to: int = 256
    logit_softcap: Optional[float] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff else self.d_ff

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def block_kinds(self, n_layers: Optional[int] = None) -> Tuple[str, ...]:
        """Per-layer mixer kinds, cycling block_pattern."""
        n = n_layers if n_layers is not None else self.n_layers
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(n))

    def layer_is_moe(self, idx: int) -> bool:
        return self.moe_num_experts > 0 and idx >= self.moe_first_dense

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self, **kw) -> "ModelConfig":
        """Reduced variant of the same family: 2 layers, d_model <= 256,
        float32 -- the reference's ``smoke()``, for CPU tests."""
        small = dict(
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.resolved_head_dim >= 64
            else self.resolved_head_dim,
            window=min(self.window, 64) if self.window else None,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
        )
        if self.moe_num_experts:
            small.update(moe_num_experts=4, moe_top_k=min(self.moe_top_k, 2),
                         moe_shared_experts=min(self.moe_shared_experts, 1),
                         moe_d_ff=128,
                         moe_first_dense=min(self.moe_first_dense, 1))
        if self.attn_kind == "mla":
            small.update(q_lora_rank=64 if self.q_lora_rank else 0,
                         kv_lora_rank=64, qk_rope_head_dim=16,
                         qk_nope_head_dim=32, v_head_dim=32)
        if self.arch_type in ("ssm", "hybrid"):
            small.update(ssm_state=32, ssm_headdim=32, ssm_chunk=32,
                         lru_width=min(self.lru_width or 256, 256))
        if self.encoder_layers:
            small.update(encoder_layers=2)
        if self.mtp_depth:
            small.update(mtp_depth=1)
        small.update(kw)
        return self.replace(**small)
