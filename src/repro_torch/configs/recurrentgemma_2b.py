"""RecurrentGemma-2B [arXiv:2402.19427] (Griffin architecture).

Hybrid: RG-LRU recurrent blocks and local (sliding-window) attention in a
2:1 pattern. MQA (1 KV head), head_dim 256, GeGLU FFN.
"""
from repro_torch.config import ModelConfig, RGLRUConfig, register_config

CONFIG = register_config(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,               # 26 blocks in the 2:1 pattern
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pos_embedding="rope",
    act="gelu_glu",              # GeGLU
    rglru=RGLRUConfig(
        lru_width=2560,
        conv1d_width=4,
        block_pattern=("rglru", "rglru", "attn"),
        local_window=2048,
    ),
    tie_embeddings=True,
    source="arXiv:2402.19427",
))
