"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434].

MLA attention (kv_lora_rank=512) + fine-grained MoE: 64 routed experts
top-6 with 2 shared experts (assignment header values; the full V2 model
uses 160 routed — we follow the assigned header: 64e top-6), expert hidden
1408, first layer dense FFN.
"""
from repro_torch.config import MLAConfig, MoEConfig, ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,             # MLA: heads share the latent; kept for bookkeeping
    d_ff=1408,                   # routed-expert hidden size
    vocab_size=102400,
    pos_embedding="rope",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,           # V2-Lite uses full-rank Q
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_expert=1408,
        num_shared_experts=2,
        d_shared=1408,
        first_dense_layers=1,
        d_ff_dense=10944,
    ),
    source="arXiv:2405.04434",
))
