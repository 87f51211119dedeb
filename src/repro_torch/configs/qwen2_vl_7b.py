"""Qwen2-VL-7B language backbone [arXiv:2409.12191].

VLM: M-RoPE positional encoding, dynamic-resolution vision encoder.
The vision encoder (ViT + merger) is a STUB per the brief — input_specs
provides precomputed patch embeddings; we implement the 28-layer decoder.
"""
from repro_torch.config import FrontendStub, ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    pos_embedding="mrope",
    frontend=FrontendStub(kind="vision", embed_dim=3584, num_tokens=256),
    source="arXiv:2409.12191",
))
