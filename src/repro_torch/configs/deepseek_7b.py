"""DeepSeek-7B (base) [arXiv:2401.02954]. Llama-architecture dense LM (MHA)."""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10_000.0,
    source="arXiv:2401.02954",
))
