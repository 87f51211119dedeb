"""The paper's own benchmark models: ViT-1B and ViT-3B (Sec. V-A).

ViT-1B: hs=2048, depth=24 (paper, Sec. II-B) ~= 1.2B params.
ViT-3B: hs=2560, depth=32 ~= 2.7B params (paper customizes layer count and
hidden size; exact values are not printed — chosen to hit the stated 2.7B).
Classification over 10 classes (CIFAR-10-like), patch-embedding frontend
is implemented as a linear patchifier inside the model (images are small).
"""
from repro_torch.config import FrontendStub, ModelConfig, register_config

VIT_1B = register_config(ModelConfig(
    name="vit-1b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=0,
    pos_embedding="learned",
    act="gelu",
    num_classes=10,
    frontend=FrontendStub(kind="vision", embed_dim=2048, num_tokens=65),
    source="paper Sec. V-A (ViT-1B, hs=2048, depth=24)",
))

VIT_3B = register_config(ModelConfig(
    name="vit-3b",
    family="vlm",
    num_layers=32,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=10240,
    vocab_size=0,
    pos_embedding="learned",
    act="gelu",
    num_classes=10,
    frontend=FrontendStub(kind="vision", embed_dim=2560, num_tokens=65),
    source="paper Sec. V-A (ViT-3B)",
))
