"""The paper's benchmark model: ViT for image classification (port of
``repro.models.vit``; paper Sec. V-A).

Encoder-only transformer over patch embeddings + [CLS], learned
positions, GELU MLP, classification head — ViT-1B is d_model 2048,
depth 24, 65 tokens for 32x32 images with patch 4. The FFN and the
attention projections run through the controlled TP path
(``layers/tp_linear.py``), so this model is the vehicle of the
training slice.

``init`` builds a :class:`ViT` module from a ``torch.Generator`` (or
zeros for :mod:`repro_torch.bridge` to fill); ``forward`` and
``loss_fn`` keep the reference's signatures.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.layers import blocks
from repro_torch.layers.blocks import _weight, _zeros, rms_norm

PATCH_DIM = 4 * 4 * 3   # 32x32x3 images, patch 4
KIND = "attn_bidir"


class ViT(nn.Module):
    """patch_proj [PATCH_DIM, d], cls [1, 1, d], pos [S, d], layers
    (per-layer :class:`blocks.Block` of kind "attn_bidir"), norm_f [d]
    f32, head [d, num_classes]."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen=None):
        super().__init__()
        d, S = cfg.d_model, cfg.frontend.num_tokens       # patches + CLS
        self.layers = blocks.init_stack(gen, cfg, dtype, device,
                                        kind_override=KIND)
        self.patch_proj = _weight(gen, (PATCH_DIM, d), 0.02, dtype, device)
        self.cls = _weight(gen, (1, 1, d), 0.02, dtype, device)
        self.pos = _weight(gen, (S, d), 0.01, dtype, device)
        self.norm_f = _zeros((d,), torch.float32, device)
        self.head = _weight(gen, (d, cfg.num_classes), 0.02, dtype, device)


def init(gen: Optional[torch.Generator], cfg: ModelConfig,
         dtype=torch.float32, device="cuda") -> ViT:
    """Random weights from ``gen`` (which must live on ``device``), or
    zeros when ``gen`` is None."""
    if not cfg.num_classes or cfg.frontend is None:
        raise ValueError(f"{cfg.name} is not a classifier (num_classes and "
                         "a frontend are required)")
    blocks.split_layers(cfg)                 # raises on unported families
    return ViT(cfg, dtype, device, gen)


def forward(p: ViT, cfg: ModelConfig, patches: torch.Tensor, *,
            ctx=None) -> torch.Tensor:
    """patches [B, P, PATCH_DIM] -> logits [B, num_classes]."""
    B = patches.shape[0]
    x = patches.to(p.patch_proj.dtype) @ p.patch_proj
    cls = p.cls.expand(B, 1, cfg.d_model).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + p.pos[None].to(x.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = blocks.apply_stack(p.layers, x, cfg, ctx=ctx, positions=positions,
                              causal=False, kind_override=KIND)
    x = rms_norm(x, p.norm_f, cfg.norm_eps)
    return x[:, 0] @ p.head


def loss_fn(p: ViT, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            ctx=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy of log-softmax in f32; returns (loss, metrics)."""
    logits = forward(p, cfg, batch["patches"], ctx=ctx)
    labels = batch["labels"].long()
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"xent": loss, "acc": acc}
