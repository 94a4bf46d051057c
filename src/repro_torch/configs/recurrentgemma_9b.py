"""recurrentgemma-9b — hybrid RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, lru_width=4096,
local attention window 2048.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=4096,
    ffn_kind="geglu",
    logit_softcap=30.0,
)

LONG_CONTEXT_OK = True          # recurrent state + bounded local window
