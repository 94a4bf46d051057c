"""mamba2-1.3b — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060].

48L d_model=2048 vocab=50280, ssm_state=128, headdim=64, expand=2 — no
attention, no MLP (the Mamba-2 block IS the layer).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,                  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssd",),
    ffn_kind="none",
    ssm_state=128,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
)

LONG_CONTEXT_OK = True          # O(1)-state decode
