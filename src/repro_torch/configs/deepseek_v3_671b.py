"""deepseek-v3-671b — MoE 256 routed + 1 shared (top-8), MLA, MTP
[arXiv:2412.19437].

61L d_model=7168 128H (MLA) moe_d_ff=2048 vocab=129280; first 3 layers dense
(d_ff=18432); q_lora=1536, kv_lora=512, rope=64, nope=128, v=128; 1 MTP module.
The router is the reference's softmax top-8 (not DeepSeek-V3's sigmoid,
group-limited one, which the reference does not have).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                 # dense layers (first 3)
    vocab_size=129280,
    block_pattern=("attn",),
    ffn_kind="swiglu",
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    moe_num_experts=256,
    moe_top_k=8,
    moe_shared_experts=1,
    moe_d_ff=2048,
    moe_first_dense=3,
    mtp_depth=1,
)

LONG_CONTEXT_OK = False         # MLA compresses KV but attention stays O(seq)
