"""seamless-m4t-medium — enc-dec multimodal (audio) backbone [arXiv:2308.11596].

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.

The audio frontend (mel-spectrogram + conv feature extractor) is a stub,
as in the reference: the encoder consumes precomputed frame embeddings
[B, S_frames, d_model]; this config is the transformer backbone that
consumes them (12 encoder + 12 decoder layers).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12,                # decoder layers
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    block_pattern=("attn",),
    ffn_kind="gelu",
    input_mode="frames",        # encoder consumes stub frame embeddings
)

LONG_CONTEXT_OK = False         # full attention
