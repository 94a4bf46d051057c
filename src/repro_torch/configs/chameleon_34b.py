"""chameleon-34b — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.

Early fusion: images are VQ-quantized into tokens drawn from the SAME 65536
vocabulary as text, so the backbone is token-in/token-out; the VQ-VAE image
tokenizer is a stub in the reference too, and the port runs the backbone
alone.  Uses qk-norm for training stability (paper §2.2).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    block_pattern=("attn",),
    ffn_kind="swiglu",
    qk_norm=True,
)

LONG_CONTEXT_OK = False
