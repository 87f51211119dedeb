"""Decoder-only language model, the decode path (port of
``repro.models.lm``).

``init`` builds an :class:`LM` module from a ``torch.Generator``;
``decode_step`` runs one token per slot against the fixed slot cache or,
with ``pages``, the block-paged pool. The cache keeps the reference's
tree and layout (``{"prefix": [...], "scan": ({"attn": {...}},)}``, scan
leaves with a leading [repeat] layer axis; GQA ``k`` / ``v`` (+ int8
``k_scale`` / ``v_scale``), MLA ``latent`` / ``k_rope``) but is updated
IN PLACE: each step writes only the new rows instead of returning a
fresh copy of the whole cache.
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
    """embed [V, d], layers (per-layer :class:`blocks.Block`, the first
    ``num_prefix_layers`` of them the dense prefix), norm_f [d] f32, head
    [d, V] unless the embedding is tied. Random from ``gen``, or zeros
    when ``gen`` is None (for the bridge to fill)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen=None):
        super().__init__()
        d, V = cfg.d_model, cfg.vocab_size
        self.num_prefix_layers = len(blocks.split_layers(cfg)[0])
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


def _layer_cache(cfg: ModelConfig, B: int, S: int, dtype, device,
                 paging=None, lead=()) -> Params:
    """One attention layer's cache leaves (with ``lead`` layer axes).
    ``paging`` (core.paging.PagedLayout): the per-slot ``[B, ..., S,
    ...]`` seq axis becomes the shared ``[num_pages, page_size, ...]``
    pool."""
    def z(*shape, dt=dtype):
        return torch.zeros(tuple(lead) + shape, dtype=dt, device=device)
    if cfg.mla is not None:
        m = cfg.mla
        if paging is not None:
            if paging.kv_int8:
                raise ValueError(
                    "kv_int8 paging covers the GQA K/V pools only — the "
                    "MLA latent is already compressed")
            return {"attn": {
                "latent": z(paging.num_pages, paging.page_size,
                            m.kv_lora_rank),
                "k_rope": z(paging.num_pages, paging.page_size,
                            m.qk_rope_head_dim)}}
        return {"attn": {"latent": z(B, S, m.kv_lora_rank),
                         "k_rope": z(B, S, m.qk_rope_head_dim)}}
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if paging is not None:
        shape = (paging.num_pages, KV, paging.page_size, hd)
        if paging.kv_int8:
            return {"attn": {"k": z(*shape, dt=torch.int8),
                             "v": z(*shape, dt=torch.int8),
                             "k_scale": z(*shape[:3], dt=torch.float32),
                             "v_scale": z(*shape[:3], dt=torch.float32)}}
        return {"attn": {"k": z(*shape), "v": z(*shape)}}
    return {"attn": {"k": z(B, KV, S, hd), "v": z(B, KV, S, hd)}}


def _layer_axes(cfg: ModelConfig, paging=None) -> Params:
    if cfg.mla is not None:
        if paging is not None:
            # the pool axis is NOT the slot batch: pages from different
            # slots interleave freely
            return {"attn": {"latent": (None, None, None),
                             "k_rope": (None, None, None)}}
        return {"attn": {"latent": ("batch", "decode_seq", None),
                         "k_rope": ("batch", "decode_seq", None)}}
    if paging is not None:
        ax = {"k": (None, "kv_heads", None, None),
              "v": (None, "kv_heads", None, None)}
        if paging.kv_int8:
            ax["k_scale"] = (None, "kv_heads", None)
            ax["v_scale"] = (None, "kv_heads", None)
        return {"attn": ax}
    return {"attn": {"k": ("batch", "kv_heads", "decode_seq", None),
                     "v": ("batch", "kv_heads", "decode_seq", None)}}


def init_cache(cfg: ModelConfig, B: int, S: int, dtype=torch.float32,
               device="cuda", paging=None) -> Params:
    """Zeros in the reference's tree: the dense prefix layers' caches as a
    list, the repeated pattern's leaves stacked on a leading axis. Fixed
    slot cache, or with ``paging`` the page pools."""
    prefix, pattern, repeat, _ = blocks.split_layers(cfg)
    out: Params = {}
    if prefix:
        out["prefix"] = [_layer_cache(cfg, B, S, dtype, device, paging)
                         for _ in prefix]
    out["scan"] = tuple(_layer_cache(cfg, B, S, dtype, device, paging,
                                     lead=(repeat,)) for _ in pattern)
    return out


def cache_axes(cfg: ModelConfig, paging=None) -> Params:
    """Logical axes of each cache leaf (the reference's names; a scan
    leaf has a leading None for the layer axis)."""
    prefix, pattern, _, _ = blocks.split_layers(cfg)
    out: Params = {}
    if prefix:
        out["prefix"] = [_layer_axes(cfg, paging) for _ in prefix]
    out["scan"] = tuple(
        {"attn": {k: (None,) + tuple(v)
                  for k, v in _layer_axes(cfg, paging)["attn"].items()}}
        for _ in pattern)
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_step(p: LM, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, cur_pos: torch.Tensor, *,
                ctx=None, pages=None):
    """One-token decode. tokens [B]; cur_pos [B] int32, one position per
    slot (2**30 marks a lane that writes nothing). ``pages`` [B,
    pages_per_slot] int32 routes cache reads / writes through the
    block-paged pool (the cache leaves must be paged-shape). Returns
    (logits [B, V], cache) — the same cache object, updated in place."""
    x = _embed(p, tokens[:, None], cfg)
    positions = cur_pos[:, None]
    x, cache = blocks.apply_stack(p.layers, x, cfg, ctx=ctx,
                                  positions=positions, caches=cache,
                                  cur_pos=cur_pos, pages=pages)
    x = rms_norm(x, p.norm_f, cfg.norm_eps)
    return _logits(p, x[:, 0], cfg), cache
