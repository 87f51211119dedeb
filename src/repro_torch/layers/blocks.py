"""Transformer blocks, the dense GQA subset (port of
``repro.layers.blocks``).

Parameters are ``nn.Module`` containers whose tensors keep the reference's
names and layouts (weights ``[in, out]``); the functions ``apply_*`` run
them, as the reference's pure functions run its parameter dicts. The
reference stacks its layers under one ``lax.scan``; here the stack is an
``nn.ModuleList`` of per-layer :class:`Block` modules and a Python loop.

Every parameter is trainable (``requires_grad``); the serve engine runs
its steps under ``torch.inference_mode()`` and pays nothing for autograd.

What this slice covers: dense layers with GQA — decoder layers ("attn",
RoPE) decoding one token per slot against the fixed slot cache, and
full-sequence attention without a cache, causal or bidirectional
("attn_bidir", the ViT encoder, whose learned positions the model adds
before the stack). Prefill into a cache, MLA, MoE, SSM and RG-LRU layers
and the paged cache come with later slices and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.tp_linear import (ControlContext, controlled_ffn,
                                          controlled_proj)

LATER_SLICE = "a later slice of the port (ROADMAP.md, queue A)"

# ---------------------------------------------------------------------------
# Small pieces
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale)
    return y.to(x.dtype)


def _zeros(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


def _weight(gen: Optional[torch.Generator], shape, std: float, dtype,
            device) -> nn.Parameter:
    """N(0, std²) from ``gen`` (drawn in f32, then cast), or zeros when
    ``gen`` is None (a shape-only module the bridge fills in)."""
    if gen is None:
        return _zeros(shape, dtype, device)
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device) * std
    return nn.Parameter(t.to(dtype))


def act_of(name: str) -> Tuple[Callable, bool]:
    """Returns (activation, gated). The activations are the ones the
    pruned-FFN kernel knows (``kernels.ops.silu`` / ``gelu``)."""
    if name == "silu":
        return kernel_ops.silu, True
    if name == "gelu_glu":
        return kernel_ops.gelu, True
    if name == "gelu":
        return kernel_ops.gelu, False
    raise ValueError(name)


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.mla is not None or cfg.moe is not None or cfg.ssm is not None
            or cfg.rglru is not None or cfg.encdec is not None):
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA decoder layers are ported; MLA, "
            f"MoE, SSM, RG-LRU and encoder-decoder layers come with "
            f"{LATER_SLICE}")
    if cfg.pos_embedding not in ("rope", "none", "learned"):
        raise NotImplementedError(
            f"{cfg.name}: position embedding {cfg.pos_embedding!r} comes "
            f"with {LATER_SLICE}")


# ---------------------------------------------------------------------------
# Attention layer (GQA)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """wq [d, H*hd], wk/wv [d, KV*hd], wo [H*hd, d] (+ optional biases)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        H, KV = cfg.num_heads, cfg.num_kv_heads
        out_std = 0.02 / (2 * cfg.num_layers) ** 0.5
        self.wq = _weight(gen, (d, H * hd), 0.02, dtype, device)
        self.wk = _weight(gen, (d, KV * hd), 0.02, dtype, device)
        self.wv = _weight(gen, (d, KV * hd), 0.02, dtype, device)
        self.wo = _weight(gen, (H * hd, d), out_std, dtype, device)
        if cfg.qkv_bias:
            self.bq = _zeros((H * hd,), dtype, device)
            self.bk = _zeros((KV * hd,), dtype, device)
            self.bv = _zeros((KV * hd,), dtype, device)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device="cuda") -> Attention:
    return Attention(cfg, dtype, device, gen)


def slot_write_index(cur_pos: torch.Tensor, S: int):
    """(slot ids, row ids, valid) of a decode step's K/V cache writes:
    slot b writes row cur_pos[b] when it lies in [0, S). An invalid lane
    (the engine's INVALID_POS = 2**30, or any position outside the cache)
    is pointed at a row it writes back unchanged, which keeps the write
    free of a host sync (no data-dependent shapes)."""
    b_idx = torch.arange(cur_pos.shape[0], device=cur_pos.device)
    valid = (cur_pos >= 0) & (cur_pos < S)
    return b_idx, torch.clamp(cur_pos, 0, S - 1).long(), valid[:, None, None]


def _write_slot_rows(cache: torch.Tensor, new: torch.Tensor, index) -> None:
    """cache[b, :, row[b], :] = new[b] in place, on the valid lanes of
    ``index`` (from :func:`slot_write_index`) only."""
    b_idx, rows, valid = index
    old = cache[b_idx, :, rows, :]                        # [B, KV, hd]
    cache[b_idx, :, rows, :] = torch.where(valid, new.to(cache.dtype), old)


def apply_attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                    ctx: Optional[ControlContext], positions: torch.Tensor,
                    causal: bool = True, window: int = 0, cache=None,
                    cur_pos: Optional[torch.Tensor] = None,
                    rope=None, write_index=None):
    """Self-attention. Returns (y, cache).

    cache None => the full sequence (training): x [B, S, d], positions
    [S], causal or bidirectional. cache given => decode: x [B, 1, d];
    the cache's K/V rows at each slot's OWN cur_pos are written in place
    (continuous batching runs slots at ragged positions), then the cache
    is attended. ``rope`` (:func:`attention.rope_tables`) and
    ``write_index`` (:func:`slot_write_index`) are computed here unless
    the caller shares them across layers."""
    B, S, d = x.shape
    if cache is not None and S != 1:
        raise NotImplementedError(
            f"prefill into a decode cache comes with {LATER_SLICE}")
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads

    q = controlled_proj(x, p.wq, ctx, "qkv", split="col")
    k = controlled_proj(x, p.wk, ctx, "qkv", split="col")
    v = controlled_proj(x, p.wv, ctx, "qkv", split="col")
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.pos_embedding == "rope":
        if rope is None:
            rope = attn_lib.rope_tables(positions, hd, cfg.rope_theta)
        q = attn_lib.apply_rope(q, positions, cfg.rope_theta, rope)
        k = attn_lib.apply_rope(k, positions, cfg.rope_theta, rope)
    q = q.transpose(1, 2)                                 # [B, H, S, hd]
    if cache is None:
        o = attn_lib.flash_attention(
            q, k.transpose(1, 2), v.transpose(1, 2), q_positions=positions,
            kv_positions=positions, causal=causal, window=window)
        o = o.transpose(1, 2).reshape(B, S, H * hd)
        return controlled_proj(o, p.wo, ctx, "attn_out", split="row"), None

    kc, vc = cache["k"], cache["v"]
    if write_index is None:
        write_index = slot_write_index(cur_pos, kc.shape[2])
    _write_slot_rows(kc, k[:, 0], write_index)
    _write_slot_rows(vc, v[:, 0], write_index)
    if cfg.fused_decode_attn:
        o = kernel_ops.fused_decode_attention(q, kc, vc, cur_pos=cur_pos,
                                              window=window)
    else:
        o = attn_lib.decode_attention(q, kc, vc, cur_pos=cur_pos,
                                      window=window)
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    y = controlled_proj(o, p.wo, ctx, "attn_out", split="row")
    return y, cache


# ---------------------------------------------------------------------------
# FFN (dense, controlled)
# ---------------------------------------------------------------------------


class FFN(nn.Module):
    """w_up [d, d_ff], w_down [d_ff, d] (+ w_gate [d, d_ff] when gated)."""

    def __init__(self, d: int, d_ff: int, gated: bool, num_layers: int,
                 dtype, device, gen=None):
        super().__init__()
        down_std = 0.02 / (2 * num_layers) ** 0.5
        self.w_up = _weight(gen, (d, d_ff), 0.02, dtype, device)
        self.w_down = _weight(gen, (d_ff, d), down_std, dtype, device)
        self.w_gate = (_weight(gen, (d, d_ff), 0.02, dtype, device)
                       if gated else None)


def init_ffn(gen: torch.Generator, d: int, d_ff: int, gated: bool,
             num_layers: int, dtype, device="cuda") -> FFN:
    return FFN(d, d_ff, gated, num_layers, dtype, device, gen)


def apply_ffn(p: FFN, x: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[ControlContext]) -> torch.Tensor:
    act, _ = act_of(cfg.act)
    return controlled_ffn(x, p.w_up, p.w_down, ctx, "ffn", act,
                          w_gate=p.w_gate)


# ---------------------------------------------------------------------------
# One block (pre-norm residual)
# ---------------------------------------------------------------------------


ATTN_KINDS = ("attn", "attn_bidir")


def _check_kind(kind: str) -> None:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} comes with {LATER_SLICE}")


class Block(nn.Module):
    """norm1 / norm2 [d] f32 (applied as ``1 + scale``), attn, ffn."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device, gen=None):
        super().__init__()
        _check_kind(kind)
        d = cfg.d_model
        _, gated = act_of(cfg.act)
        self.norm1 = _zeros((d,), torch.float32, device)
        self.attn = Attention(cfg, dtype, device, gen)
        self.norm2 = _zeros((d,), torch.float32, device)
        self.ffn = FFN(d, cfg.d_ff, gated, cfg.num_layers, dtype, device, gen)


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype,
               device="cuda") -> Block:
    return Block(cfg, kind, dtype, device, gen)


def apply_block(p: Block, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                ctx: Optional[ControlContext], positions: torch.Tensor,
                cache=None, cur_pos: Optional[torch.Tensor] = None,
                causal: bool = True, rope=None, write_index=None):
    """Returns (x_out, cache). An "attn_bidir" layer is never causal.
    ``rope`` / ``write_index``: see :func:`apply_attention`."""
    _check_kind(kind)
    eps = cfg.norm_eps
    window = cfg.sliding_window
    attn_cache = None if cache is None else cache.get("attn", cache)
    h, ac = apply_attention(p.attn, rms_norm(x, p.norm1, eps), cfg, ctx=ctx,
                            positions=positions,
                            causal=causal and kind != "attn_bidir",
                            window=window, cache=attn_cache, cur_pos=cur_pos,
                            rope=rope, write_index=write_index)
    x = x + h
    x = x + apply_ffn(p.ffn, rms_norm(x, p.norm2, eps), cfg, ctx)
    return x, (None if ac is None else {"attn": ac})


# ---------------------------------------------------------------------------
# Layer schedule + stacked init/apply (a Python loop over layers)
# ---------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    _check_supported(cfg)
    return ("attn",) * cfg.num_layers


def split_layers(cfg: ModelConfig):
    """(prefix_kinds, pattern, repeat, suffix_kinds), as the reference: a
    dense model is one repeated "attn" pattern."""
    kinds = layer_kinds(cfg)
    return (), (kinds[0],), len(kinds), ()


def init_stack(gen: Optional[torch.Generator], cfg: ModelConfig, dtype,
               device="cuda", kind_override: Optional[str] = None
               ) -> nn.ModuleList:
    """Per-layer blocks (the reference's stacked ``scan`` leaves,
    unstacked); zeros when ``gen`` is None. ``kind_override`` makes every
    layer that kind (ViT's "attn_bidir")."""
    _, pattern, repeat, _ = split_layers(cfg)
    kind = kind_override or pattern[0]
    return nn.ModuleList(init_block(gen, cfg, kind, dtype, device)
                         for _ in range(repeat))


def apply_stack(stack: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig, *,
                ctx=None, positions=None, caches=None, cur_pos=None,
                causal: bool = True, kind_override: Optional[str] = None):
    """Run all layers. ``caches`` (decode) has the reference's layout
    ``{"scan": ({"attn": {"k": [L, B, KV, S, hd], "v": ...}},)}``; layer
    i writes its K/V rows in place into slice i. Without caches every
    layer attends the full sequence. Returns (x, caches)."""
    _, pattern, repeat, _ = split_layers(cfg)
    kind = kind_override or pattern[0]
    layer_cache = None if caches is None else caches["scan"][0]["attn"]
    # every layer rotates and writes at the same positions: compute the
    # RoPE tables and the cache-write index once per step
    rope = (attn_lib.rope_tables(positions, cfg.resolved_head_dim,
                                 cfg.rope_theta)
            if cfg.pos_embedding == "rope" and positions is not None
            else None)
    write_index = (slot_write_index(cur_pos, layer_cache["k"].shape[3])
                   if layer_cache is not None else None)
    for i, blk in enumerate(stack):
        c = (None if layer_cache is None else
             {"attn": {"k": layer_cache["k"][i], "v": layer_cache["v"][i]}})
        x, _ = apply_block(blk, x, cfg, kind, ctx=ctx, positions=positions,
                           cache=c, cur_pos=cur_pos, causal=causal,
                           rope=rope, write_index=write_index)
    return x, caches
