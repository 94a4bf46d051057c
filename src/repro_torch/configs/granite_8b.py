"""granite-8b — dense llama-arch code model [arXiv:2405.04324].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    block_pattern=("attn",),
    ffn_kind="swiglu",
    rope_theta=10000.0,
)

# full attention, no sliding-window variant in the model card => long_500k skipped
LONG_CONTEXT_OK = False
