"""qwen2.5-14b — dense GQA with QKV bias [hf:Qwen/Qwen2.5 family].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.

40 query heads over 8 KV heads: K3 runs at G = 5.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    block_pattern=("attn",),
    ffn_kind="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
)

LONG_CONTEXT_OK = False
