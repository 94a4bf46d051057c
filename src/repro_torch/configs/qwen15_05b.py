"""qwen1.5-0.5b — dense with QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    block_pattern=("attn",),
    ffn_kind="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
)

# Dense full attention, but this arch carries the beyond-paper sub-quadratic
# variant: long_500k runs with a sliding-window (4096) attention config.
LONG_CONTEXT_OK = True
LONG_CONTEXT_VARIANT = dict(block_pattern=("swa",), window=4096)
