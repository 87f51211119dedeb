"""Mixtral-8x7B [arXiv:2401.04088]. 8 experts top-2 MoE, GQA, SWA."""
from repro_torch.config import MoEConfig, ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        d_expert=14336,
        expert_sharding="tp",   # 8 big experts: split d_expert over TP
    ),
    source="arXiv:2401.04088",
))
