"""Granite-3.0-8B [hf:ibm-granite/granite-3.0-2b-base family]. Dense GQA LM."""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
))
