"""Decoder-only language model, dense GQA decode path (port of
``repro.models.lm``).

``init`` builds an :class:`LM` module from a ``torch.Generator``;
``decode_step`` runs one token per slot against the fixed slot cache.
The cache keeps the reference's tree and layout
(``{"scan": ({"attn": {"k", "v"}},)}`` with ``[L, B, KV, S, hd]``
leaves) but is updated IN PLACE: each step writes only the new K/V rows
instead of returning a fresh copy of the whole cache.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.layers import blocks
from repro_torch.layers.blocks import _weight, _zeros, rms_norm

Params = Dict[str, Any]


class LM(nn.Module):
    """embed [V, d], layers (per-layer :class:`blocks.Block`), norm_f [d]
    f32, head [d, V] unless the embedding is tied. Random from ``gen``,
    or zeros when ``gen`` is None (for the bridge to fill)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen=None):
        super().__init__()
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = _weight(gen, (V, d), 0.02, dtype, device)
        self.layers = blocks.init_stack(gen, cfg, dtype, device)
        self.norm_f = _zeros((d,), torch.float32, device)
        self.head = (None if cfg.tie_embeddings
                     else _weight(gen, (d, V), 0.02, dtype, device))


def init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
         device="cuda") -> LM:
    """Random weights from ``gen`` (which must live on ``device``)."""
    blocks.split_layers(cfg)                 # raises on unported families
    return LM(cfg, dtype, device, gen)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _embed(p: LM, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = p.embed[tokens.long()]
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def _logits(p: LM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p.embed.t()
    return x @ p.head


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, S: int, dtype=torch.float32,
               device="cuda") -> Params:
    """The fixed slot cache: zeros [L, B, KV, S, hd] for K and V."""
    blocks.split_layers(cfg)
    shape = (cfg.num_layers, B, cfg.num_kv_heads, S, cfg.resolved_head_dim)
    return {"scan": ({"attn": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device)}},)}


def cache_axes(cfg: ModelConfig) -> Params:
    """Logical axes of each cache leaf (the reference's names)."""
    ax = (None, "batch", "kv_heads", "decode_seq", None)
    return {"scan": ({"attn": {"k": ax, "v": ax}},)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_step(p: LM, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, cur_pos: torch.Tensor, *,
                ctx=None):
    """One-token decode. tokens [B]; cur_pos [B] int32, one position per
    slot (2**30 marks a lane that writes nothing). Returns
    (logits [B, V], cache) — the same cache object, updated in place."""
    x = _embed(p, tokens[:, None], cfg)
    positions = cur_pos[:, None]
    x, cache = blocks.apply_stack(p.layers, x, cfg, ctx=ctx,
                                  positions=positions, caches=cache,
                                  cur_pos=cur_pos)
    x = rms_norm(x, p.norm_f, cfg.norm_eps)
    return _logits(p, x[:, 0], cfg), cache
