"""Whisper-small [arXiv:2212.04356]. Encoder-decoder; conv/mel frontend is a
STUB per the brief — input_specs provides precomputed frame embeddings."""
from repro_torch.config import EncDecConfig, FrontendStub, ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,               # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    pos_embedding="sinusoid",   # computed on the fly (no learned table)
    act="gelu",                  # plain GELU MLP (not gated)
    encdec=EncDecConfig(num_encoder_layers=12, encoder_seq_len=1500),
    frontend=FrontendStub(kind="audio", embed_dim=768, num_tokens=1500),
    tie_embeddings=True,
    source="arXiv:2212.04356",
))
