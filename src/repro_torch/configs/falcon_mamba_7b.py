"""Falcon-Mamba-7B [arXiv:2410.05355]. Pure Mamba-1 SSM, attention-free."""
from repro_torch.config import ModelConfig, SSMConfig, register_config

CONFIG = register_config(ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    pos_embedding="none",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2410.05355",
))
