"""mixtral-8x22b — sparse MoE, 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA.
"""
from repro_torch.models.config import ModelConfig

SWA_WINDOW = 4096

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    block_pattern=("swa",),
    window=SWA_WINDOW,
    ffn_kind="swiglu",
    moe_num_experts=8,
    moe_top_k=2,
    rope_theta=1e6,
)

LONG_CONTEXT_OK = True          # native SWA => bounded KV ring cache
