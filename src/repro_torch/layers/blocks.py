"""Transformer blocks: dense GQA, MLA and MoE decoder layers (port of
``repro.layers.blocks``).

Parameters are ``nn.Module`` containers whose tensors keep the reference's
names and layouts (weights ``[in, out]``); the functions ``apply_*`` run
them, as the reference's pure functions run its parameter dicts. The
reference stacks its layers under one ``lax.scan``; here the stack is an
``nn.ModuleList`` of per-layer :class:`Block` modules and a Python loop.

Every parameter is trainable (``requires_grad``); the serve engine runs
its steps under ``torch.inference_mode()`` and pays nothing for autograd.

What is ported: decoder layers ("attn", RoPE) with GQA or absorbed MLA
attention (DeepSeek-V2) and a dense or MoE FFN ("moe"), decoding one
token per slot against the fixed slot cache or the block-paged pool
(``pages``), and full-sequence GQA attention without a cache, causal or
bidirectional ("attn_bidir", the ViT encoder, whose learned positions the
model adds before the stack). The K/V (or latent) rows of a decode step
are written in place; a lane that must not write (a chunked-prefill
``INVALID_POS`` lane, or a position past its slot's allocated pages)
changes no byte of the cache. Prefill into a cache, MLA's expanded
full-sequence form, SSM, RG-LRU, encoder-decoder and M-RoPE layers come
with a later slice and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers.tp_linear import (ControlContext, controlled_ffn,
                                          controlled_proj)

LATER_SLICE = "a later slice of the port (ROADMAP.md, queue A.7)"
LM_TRAIN_SLICE = ("the LM training and prefill slice of the port "
                  "(ROADMAP.md, queue A.5)")

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
    if cfg.ssm is not None or cfg.rglru is not None \
            or cfg.encdec is not None:
        raise NotImplementedError(
            f"{cfg.name}: GQA / MLA decoder layers with dense or MoE FFNs "
            f"are ported; SSM, RG-LRU and encoder-decoder layers come "
            f"with {LATER_SLICE}")
    if cfg.pos_embedding not in ("rope", "none", "learned"):
        raise NotImplementedError(
            f"{cfg.name}: position embedding {cfg.pos_embedding!r} comes "
            f"with {LATER_SLICE}")


# ---------------------------------------------------------------------------
# Attention layer (GQA / MLA)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA: wq [d, H*hd], wk/wv [d, KV*hd], wo [H*hd, d] (+ optional
    biases). MLA: wq [d, H*(dn+dr)], w_dkv [d, R], w_kr [d, dr], w_uk
    [R, H*dn], w_uv [R, H*dv], wo [H*dv, d]."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        H, KV = cfg.num_heads, cfg.num_kv_heads
        out_std = 0.02 / (2 * cfg.num_layers) ** 0.5
        if cfg.mla is not None:
            m = cfg.mla
            dn, dr, R = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
            self.wq = _weight(gen, (d, H * (dn + dr)), 0.02, dtype, device)
            self.w_dkv = _weight(gen, (d, R), 0.02, dtype, device)
            self.w_kr = _weight(gen, (d, dr), 0.02, dtype, device)
            self.w_uk = _weight(gen, (R, H * dn), 0.02, dtype, device)
            self.w_uv = _weight(gen, (R, H * m.v_head_dim), 0.02, dtype,
                                device)
            self.wo = _weight(gen, (H * m.v_head_dim, d), out_std, dtype,
                              device)
            return
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


# -- where a decode step writes its rows ------------------------------------
#
# A write index is (i0, i1, src, keep_old): lane b writes row
# cache[i0[b], (heads,) i1[b]] with the new row of lane src[b] (its own
# when src is None), or writes the old row back where keep_old[b]. Both
# functions below keep the write free of a host sync (no data-dependent
# shapes) and of collisions: no two lanes write one row with different
# values.


def slot_write_index(cur_pos: torch.Tensor, S: int):
    """The fixed slot cache: slot b writes row cur_pos[b] when it lies in
    [0, S). An invalid lane (the engine's INVALID_POS = 2**30, or any
    position outside the cache) writes its own clamped row back
    unchanged."""
    b_idx = torch.arange(cur_pos.shape[0], device=cur_pos.device)
    valid = (cur_pos >= 0) & (cur_pos < S)
    return b_idx, torch.clamp(cur_pos, 0, S - 1).long(), None, ~valid


def paged_write_index(pages: torch.Tensor, cur_pos: torch.Tensor,
                      page_size: int, num_pages: int):
    """The paged pool (the reference's ``_paged_write_ids``): slot b
    writes page ``pages[b, cur_pos // page_size]`` at offset ``cur_pos %
    page_size``. A lane is invalid — the reference drops its write — when
    its position lies outside the table or in an unallocated (-1) page.
    A clamped index would point an invalid lane at some pool row another
    lane may be writing, so invalid lanes repeat the first valid lane's
    write exactly (same row, same value) instead; with no valid lane at
    all, every lane writes its own clamped row back unchanged."""
    B, pps = pages.shape
    pi = torch.div(cur_pos.long(), page_size, rounding_mode="floor")
    p = torch.gather(pages.long(), 1, torch.clamp(pi, 0, pps - 1)[:, None])[:, 0]
    ok = (pi >= 0) & (pi < pps) & (p >= 0) & (p < num_pages)
    page = torch.where(ok, p, torch.zeros_like(p))
    off = torch.remainder(cur_pos.long(), page_size)
    lanes = torch.arange(B, device=pages.device)
    j = torch.argmax(ok.to(torch.int32))               # first valid lane
    any_ok = ok.any()
    dup = ~ok & any_ok
    return (torch.where(dup, page[j], page), torch.where(dup, off[j], off),
            torch.where(dup, j, lanes), ~ok & ~any_ok)


def _write_rows(leaf: torch.Tensor, new: torch.Tensor, index,
                heads: bool) -> None:
    """In place: leaf[i0, :, i1] (``heads``: a [*, KV, rows, ...] leaf) or
    leaf[i0, i1] (a [*, rows, ...] leaf) = the lanes' new rows, per the
    write index."""
    i0, i1, src, keep = index
    sel = (i0, slice(None), i1) if heads else (i0, i1)
    old = leaf[sel]
    val = (new if src is None else new[src]).to(leaf.dtype)
    keep = keep.reshape((-1,) + (1,) * (old.ndim - 1))
    leaf[sel] = torch.where(keep, old, val)


def write_index_for(layer_cache, cur_pos: torch.Tensor,
                    pages: Optional[torch.Tensor]):
    """The write index of a decode step, shared by every layer: from one
    layer's attention cache leaves (GQA ``k`` [B|num_pages, KV, S|ps, hd],
    MLA ``latent`` [B|num_pages, S|ps, R])."""
    attn = layer_cache["attn"]
    leaf = attn["k"] if "k" in attn else attn["latent"]
    rows = leaf.shape[2] if "k" in attn else leaf.shape[1]
    if pages is not None:
        return paged_write_index(pages, cur_pos, rows, leaf.shape[0])
    return slot_write_index(cur_pos, rows)


def apply_attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                    ctx: Optional[ControlContext], positions: torch.Tensor,
                    causal: bool = True, window: int = 0, cache=None,
                    cur_pos: Optional[torch.Tensor] = None,
                    pages: Optional[torch.Tensor] = None,
                    rope=None, write_index=None):
    """Self-attention. Returns (y, cache).

    cache None => the full sequence (training): x [B, S, d], positions
    [S], causal or bidirectional. cache given => decode: x [B, 1, d];
    each slot's K/V rows at its OWN cur_pos (continuous batching runs
    slots at ragged positions) are written in place — into the slot
    cache, or through the page table ``pages`` [B, pages_per_slot] into
    the shared pool — then the cache is attended. ``rope``
    (:func:`attention.rope_tables`) and ``write_index``
    (:func:`write_index_for`) are computed here unless the caller shares
    them across layers."""
    if cfg.mla is not None:
        return _apply_mla(p, x, cfg, ctx=ctx, positions=positions,
                          cache=cache, cur_pos=cur_pos, pages=pages,
                          rope=rope, write_index=write_index)
    B, S, d = x.shape
    if cache is not None and S != 1:
        raise NotImplementedError(
            f"prefill into a decode cache comes with {LM_TRAIN_SLICE}")
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

    if write_index is None:
        write_index = write_index_for({"attn": cache}, cur_pos, pages)
    kc, vc = cache["k"], cache["v"]
    k_new, v_new = k[:, 0], v[:, 0]                       # [B, KV, hd]
    int8 = "k_scale" in cache
    if int8:
        # int8 pool: per (slot, kv-head) row scale = max|.| / 127
        ksc = torch.clamp(k_new.abs().amax(dim=-1), min=1e-12) / 127.0
        vsc = torch.clamp(v_new.abs().amax(dim=-1), min=1e-12) / 127.0
        k_new = torch.clamp(torch.round(k_new / ksc[..., None]), -127, 127)
        v_new = torch.clamp(torch.round(v_new / vsc[..., None]), -127, 127)
        _write_rows(cache["k_scale"], ksc, write_index, heads=True)
        _write_rows(cache["v_scale"], vsc, write_index, heads=True)
    _write_rows(kc, k_new, write_index, heads=True)
    _write_rows(vc, v_new, write_index, heads=True)
    if pages is not None and cfg.fused_decode_attn:
        if int8:
            raise ValueError(
                "kv_int8 paging has no fused kernel path — run with "
                "fused_attention off (oracle dequant)")
        o = kernel_ops.fused_paged_decode_attention(
            q, kc, vc, pages=pages, cur_pos=cur_pos, window=window)
    elif pages is not None:
        o = attn_lib.paged_decode_attention(
            q, kc, vc, pages=pages, cur_pos=cur_pos, window=window,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    elif cfg.fused_decode_attn:
        o = kernel_ops.fused_decode_attention(q, kc, vc, cur_pos=cur_pos,
                                              window=window)
    else:
        o = attn_lib.decode_attention(q, kc, vc, cur_pos=cur_pos,
                                      window=window)
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    y = controlled_proj(o, p.wo, ctx, "attn_out", split="row")
    return y, cache


def _apply_mla(p: Attention, x, cfg, *, ctx, positions, cache, cur_pos,
               pages=None, rope=None, write_index=None):
    """Absorbed MLA decode: the latent and rope rows of the new token are
    written in place (slot cache [B, S, R] / [B, S, dr], or the paged
    pools [num_pages, ps, R] / [num_pages, ps, dr]), then the H heads
    attend the latent without expanding K/V."""
    m = cfg.mla
    B, S, d = x.shape
    if cache is None or S != 1:
        raise NotImplementedError(
            f"MLA's expanded full-sequence form (training, prefill) comes "
            f"with {LM_TRAIN_SLICE}")
    H = cfg.num_heads
    dn, dr, dv, R = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)

    q = controlled_proj(x, p.wq, ctx, "qkv", split="col")
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    latent = x @ p.w_dkv                                  # [B, 1, R]
    k_rope = x @ p.w_kr                                   # [B, 1, dr]
    if rope is None:
        rope = attn_lib.rope_tables(positions, dr, cfg.rope_theta)
    q_rope = attn_lib.apply_rope(q_rope, positions, cfg.rope_theta, rope)
    k_rope = attn_lib.apply_rope(k_rope[:, :, None, :], positions,
                                 cfg.rope_theta, rope)[:, :, 0]

    if write_index is None:
        write_index = write_index_for({"attn": cache}, cur_pos, pages)
    lc, rc = cache["latent"], cache["k_rope"]
    _write_rows(lc, latent[:, 0], write_index, heads=False)
    _write_rows(rc, k_rope[:, 0], write_index, heads=False)
    # absorbed decode: q_abs = W_uk^T q_nope per head
    w_uk = p.w_uk.reshape(R, H, dn)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
    qr = q_rope[:, 0]
    if pages is not None and cfg.fused_decode_attn:
        o_lat = kernel_ops.fused_paged_mla_decode_attention(
            q_abs, qr, lc, rc, pages=pages, cur_pos=cur_pos,
            head_dim_for_scale=dn + dr)
    elif pages is not None:
        o_lat = attn_lib.paged_mla_decode_attention(
            q_abs, qr, lc, rc, pages=pages, cur_pos=cur_pos,
            head_dim_for_scale=dn + dr)
    elif cfg.fused_decode_attn:
        o_lat = kernel_ops.fused_mla_decode_attention(
            q_abs, qr, lc, rc, cur_pos=cur_pos, head_dim_for_scale=dn + dr)
    else:
        o_lat = attn_lib.mla_decode_attention(
            q_abs, qr, lc, rc, cur_pos=cur_pos, head_dim_for_scale=dn + dr)
    w_uv = p.w_uv.reshape(R, H, dv)
    o = torch.einsum("bhr,rhd->bhd", o_lat.to(x.dtype), w_uv)
    o = o.reshape(B, 1, H * dv)
    y = controlled_proj(o, p.wo, ctx, "attn_out", split="row")
    return y, cache


# ---------------------------------------------------------------------------
# FFN (dense, controlled) + MoE
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


class MoE(nn.Module):
    """router [d, E] f32, w_up / w_gate [E, d, f], w_down [E, f, d], and
    the shared experts as one FFN of width num_shared * (d_shared or f)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen=None):
        super().__init__()
        mo, d = cfg.moe, cfg.d_model
        _, gated = act_of(cfg.act)
        E, f = mo.num_experts, mo.d_expert
        down_std = 0.02 / (2 * cfg.num_layers) ** 0.5
        self.router = _weight(gen, (d, E), 0.02, torch.float32, device)
        self.w_up = _weight(gen, (E, d, f), 0.02, dtype, device)
        self.w_down = _weight(gen, (E, f, d), down_std, dtype, device)
        self.w_gate = (_weight(gen, (E, d, f), 0.02, dtype, device)
                       if gated else None)
        self.shared = (FFN(d, mo.num_shared_experts * (mo.d_shared or f),
                           gated, cfg.num_layers, dtype, device, gen)
                       if mo.num_shared_experts else None)


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[ControlContext]):
    """Routed experts plus the shared experts (through the controlled
    FFN, so ZERO-resizing and the pruned-FFN kernel reach them). Under a
    plan for more than one rank, experts sharded ``"tp"`` run TP-local
    over the plan's group (``moe_lib.moe_ffn``'s ``group``). Returns (y,
    aux loss)."""
    act, _ = act_of(cfg.act)
    params = {"router": p.router, "w_up": p.w_up, "w_down": p.w_down}
    if p.w_gate is not None:
        params["w_gate"] = p.w_gate
    y, aux = moe_lib.moe_ffn(x, params, cfg.moe, act,
                             group=ctx.group if ctx is not None else None)
    if p.shared is not None:
        y = y + controlled_ffn(x, p.shared.w_up, p.shared.w_down, ctx, "ffn",
                               act, w_gate=p.shared.w_gate)
    return y, aux


# ---------------------------------------------------------------------------
# One block (pre-norm residual)
# ---------------------------------------------------------------------------


KINDS = ("attn", "attn_bidir", "moe")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} comes with {LATER_SLICE}")


class Block(nn.Module):
    """norm1 / norm2 [d] f32 (applied as ``1 + scale``), attn, and ffn (a
    dense layer; an MoE model's dense prefix has width ``d_ff_dense``) or
    moe."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device, gen=None):
        super().__init__()
        _check_kind(kind)
        d = cfg.d_model
        _, gated = act_of(cfg.act)
        self.norm1 = _zeros((d,), torch.float32, device)
        self.attn = Attention(cfg, dtype, device, gen)
        self.norm2 = _zeros((d,), torch.float32, device)
        if kind == "moe":
            self.moe = MoE(cfg, dtype, device, gen)
        else:
            dff = (cfg.d_ff if cfg.moe is None
                   else (cfg.moe.d_ff_dense or cfg.d_ff))
            self.ffn = FFN(d, dff, gated, cfg.num_layers, dtype, device, gen)


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype,
               device="cuda") -> Block:
    return Block(cfg, kind, dtype, device, gen)


def apply_block(p: Block, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                ctx: Optional[ControlContext], positions: torch.Tensor,
                cache=None, cur_pos: Optional[torch.Tensor] = None,
                causal: bool = True, pages=None, rope=None,
                write_index=None):
    """Returns (x_out, cache). An "attn_bidir" layer is never causal.
    ``pages`` / ``rope`` / ``write_index``: see :func:`apply_attention`."""
    _check_kind(kind)
    eps = cfg.norm_eps
    window = cfg.sliding_window
    attn_cache = None if cache is None else cache.get("attn", cache)
    h, ac = apply_attention(p.attn, rms_norm(x, p.norm1, eps), cfg, ctx=ctx,
                            positions=positions,
                            causal=causal and kind != "attn_bidir",
                            window=window, cache=attn_cache, cur_pos=cur_pos,
                            pages=pages, rope=rope, write_index=write_index)
    x = x + h
    if kind == "moe":
        h2, _ = apply_moe(p.moe, rms_norm(x, p.norm2, eps), cfg, ctx)
    else:
        h2 = apply_ffn(p.ffn, rms_norm(x, p.norm2, eps), cfg, ctx)
    return x + h2, (None if ac is None else {"attn": ac})


# ---------------------------------------------------------------------------
# Layer schedule + stacked init/apply (a Python loop over layers)
# ---------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    _check_supported(cfg)
    if cfg.pos_embedding not in ("rope", "none", "learned"):
        raise NotImplementedError(
            f"{cfg.name}: position embedding {cfg.pos_embedding!r} comes "
            f"with {LATER_SLICE}")
    if cfg.moe is not None:
        fd = cfg.moe.first_dense_layers
        return ("attn",) * fd + ("moe",) * (cfg.num_layers - fd)
    return ("attn",) * cfg.num_layers


def split_layers(cfg: ModelConfig):
    """(prefix_kinds, pattern, repeat, suffix_kinds), as the reference:
    an MoE model's dense first layers are the prefix; the rest is one
    repeated pattern."""
    kinds = layer_kinds(cfg)
    L = len(kinds)
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        fd = cfg.moe.first_dense_layers
        return kinds[:fd], ("moe",), L - fd, ()
    return (), (kinds[0],), L, ()


def init_stack(gen: Optional[torch.Generator], cfg: ModelConfig, dtype,
               device="cuda", kind_override: Optional[str] = None
               ) -> nn.ModuleList:
    """Per-layer blocks in layer order — the reference's ``prefix`` list,
    then its stacked ``scan`` leaves unstacked — so that layer i here is
    the reference's ``ctx_at(i)`` layer; zeros when ``gen`` is None.
    ``kind_override`` makes every layer that kind (ViT's
    "attn_bidir")."""
    prefix, pattern, repeat, _ = split_layers(cfg)
    if kind_override:
        prefix, pattern, repeat = (), (kind_override,), cfg.num_layers
    kinds = tuple(prefix) + tuple(pattern) * repeat
    return nn.ModuleList(init_block(gen, cfg, kind, dtype, device)
                         for kind in kinds)


def layer_caches(caches) -> list:
    """Per-layer ``{"attn": {leaf: tensor}}`` dicts of a cache tree in
    the reference's layout (``{"prefix": [...], "scan": (group,)}`` with
    a leading [repeat] axis on the scan leaves), in layer order. The scan
    entries are views: writing a layer's rows writes the stacked tree."""
    out = list(caches.get("prefix", []))
    group = caches["scan"][0]["attn"]
    n = next(iter(group.values())).shape[0]
    out += [{"attn": {k: v[i] for k, v in group.items()}} for i in range(n)]
    return out


def apply_stack(stack: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig, *,
                ctx=None, positions=None, caches=None, cur_pos=None,
                causal: bool = True, kind_override: Optional[str] = None,
                pages: Optional[torch.Tensor] = None):
    """Run all layers. ``caches`` (decode) has the reference's layout
    (:func:`layer_caches`); layer i writes its rows in place, through the
    page table ``pages`` when given. Without caches every layer attends
    the full sequence. Returns (x, caches)."""
    prefix, pattern, repeat, _ = split_layers(cfg)
    if kind_override:
        prefix, pattern, repeat = (), (kind_override,), cfg.num_layers
    kinds = tuple(prefix) + tuple(pattern) * repeat
    per_layer = None if caches is None else layer_caches(caches)
    # every layer rotates and writes at the same positions: compute the
    # RoPE tables and the cache-write index once per step
    rope_dim = (cfg.mla.qk_rope_head_dim if cfg.mla is not None
                else cfg.resolved_head_dim)
    rope = (attn_lib.rope_tables(positions, rope_dim, cfg.rope_theta)
            if cfg.pos_embedding == "rope" and positions is not None
            else None)
    write_index = (write_index_for(per_layer[0], cur_pos, pages)
                   if per_layer is not None else None)
    for i, (blk, kind) in enumerate(zip(stack, kinds)):
        x, _ = apply_block(blk, x, cfg, kind, ctx=ctx, positions=positions,
                           cache=None if per_layer is None else per_layer[i],
                           cur_pos=cur_pos, causal=causal, pages=pages,
                           rope=rope, write_index=write_index)
    return x, caches
