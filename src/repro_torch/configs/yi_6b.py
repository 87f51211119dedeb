"""Yi-6B [arXiv:2403.04652]. Llama-architecture dense LM with GQA (4 KV heads)."""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
))
