"""Attention pieces (port of ``repro.layers.attention``): rotary
embeddings, full-sequence attention and the plain one-token decode
attentions (GQA and absorbed MLA, over the fixed slot cache and over the
block-paged pool).

``flash_attention`` is the full-sequence attention of the training path
(bidirectional for ViT, causal for a decoder). The reference computes it
with an online softmax under ``lax.scan``, not in Pallas; here it is
plain PyTorch that materializes the [B, Hkv, G, Sq, Skv] scores in f32,
which at ViT's 65 tokens are small. ``decode_attention``,
``mla_decode_attention`` and their paged variants are the reference's
oracle paths, which the engine runs when the fused decode kernels are
switched off. M-RoPE comes with a later slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions [...,] -> angles [..., head_dim/2] (f32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    # a Python-float base keeps theta off the device (a host-to-device
    # copy here would stall the launch queue twice per layer)
    freqs = 1.0 / torch.pow(float(theta), exps)
    return positions.to(torch.float32)[..., None] * freqs


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each [B, S, 1, head_dim/2], for :func:`apply_rope`;
    positions [B, S] (or [S]). A decode step computes them once and
    shares them across its layers."""
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = rope_angles(positions, head_dim, theta)       # [B, S, D/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables=None) -> torch.Tensor:
    """x [B, S, H, D]; positions [B, S] (or [S]); ``tables`` =
    ``rope_tables(positions, D, theta)`` when already computed."""
    d = x.shape[-1]
    cos, sin = tables if tables is not None else rope_tables(positions, d,
                                                            theta)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, cur_pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """q [B, Hq, 1, D]; caches [B, Hkv, S, D]; cur_pos [B] (position of
    the new token). Attends to cache positions p <= cur_pos (and within
    the sliding window if set)."""
    B, Hq, _, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)[None, :]
    cur = cur_pos.to(torch.int64)[:, None]
    ok = pos <= cur
    if window > 0:
        ok = ok & (pos > cur - window)
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full-sequence attention, the reference's ``flash_attention``.

    q [B, Hq, Sq, D]; k, v [B, Hkv, Skv, D]; Hq % Hkv == 0 (GQA groups
    stay factored — K/V are never repeated to Hq). positions are int
    [Sq] / [Skv], used for the causal and sliding-window masks
    (window=0 => full). Scores and softmax in f32; returns q.dtype.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    pq = q_positions.to(torch.int64)[:, None]
    pk = kv_positions.to(torch.int64)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (pk <= pq)
    if window > 0:
        mask = mask & (pq - pk < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return out.reshape(B, Hq, Sq, Dv).to(q.dtype)


def mla_decode_attention(q_nope_abs: torch.Tensor, q_rope: torch.Tensor,
                         latent_cache: torch.Tensor, rope_cache: torch.Tensor,
                         *, cur_pos: torch.Tensor,
                         head_dim_for_scale: int) -> torch.Tensor:
    """Absorbed MLA decode (DeepSeek-V2): scores against the compressed
    latent — K/V are never expanded.

    q_nope_abs [B, H, R] (W_uk^T q_nope, R = kv_lora_rank); q_rope
    [B, H, Dr]; latent_cache [B, S, R]; rope_cache [B, S, Dr]. Returns
    f32 [B, H, R] (attention-weighted latents; the caller applies W_uv).
    The softmax scale uses the ORIGINAL qk head dim (nope + rope), not
    the latent rank."""
    scale = 1.0 / math.sqrt(head_dim_for_scale)
    s = (torch.einsum("bhr,bsr->bhs", q_nope_abs.float(),
                      latent_cache.float())
         + torch.einsum("bhd,bsd->bhs", q_rope.float(),
                        rope_cache.float())) * scale
    S = latent_cache.shape[1]
    ok = (torch.arange(S, device=s.device)[None, :]
          <= cur_pos.to(torch.int64)[:, None])
    s = torch.where(ok[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bsr->bhr", p, latent_cache.float())


# ---------------------------------------------------------------------------
# Paged decode (oracle): gather pool pages through the page table, then
# run the fixed-layout decode attention. The gather clamps the table
# (unallocated entries are -1), which is safe: every position <= cur_pos
# lies in an allocated page, and positions beyond cur_pos are masked.
# ---------------------------------------------------------------------------


def _clamped(pages: torch.Tensor, num_pages: int) -> torch.Tensor:
    return torch.clamp(pages.long(), 0, num_pages - 1)


def gather_paged_kv(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """pool [num_pages, KV, ps, d]; pages [B, pps] (-1 = unset). Returns
    the linearized per-slot cache [B, KV, pps*ps, d]."""
    B, pps = pages.shape
    k = pool[_clamped(pages, pool.shape[0])]          # [B, pps, KV, ps, d]
    KV, ps, d = k.shape[2], k.shape[3], k.shape[4]
    return k.transpose(1, 2).reshape(B, KV, pps * ps, d)


def gather_paged_rows(pool: torch.Tensor,
                      pages: torch.Tensor) -> torch.Tensor:
    """pool [num_pages, ps, d]; pages [B, pps] -> [B, pps*ps, d] (MLA)."""
    B, pps = pages.shape
    x = pool[_clamped(pages, pool.shape[0])]          # [B, pps, ps, d]
    return x.reshape(B, pps * x.shape[2], x.shape[3])


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, *, pages: torch.Tensor,
                           cur_pos: torch.Tensor, window: int = 0,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """GQA decode over the paged pool: q [B, Hq, 1, D]; pools
    [num_pages, Hkv, ps, D]; pages [B, pps]; cur_pos [B]. With
    ``k_scale`` / ``v_scale`` ([num_pages, Hkv, ps] f32) the pools are
    int8 and dequantized per row after the gather."""
    k = gather_paged_kv(k_pool, pages)
    v = gather_paged_kv(v_pool, pages)
    if k_scale is not None:
        ks = gather_paged_kv(k_scale[..., None], pages)
        vs = gather_paged_kv(v_scale[..., None], pages)
        k = (k.float() * ks).to(q.dtype)
        v = (v.float() * vs).to(q.dtype)
    return decode_attention(q, k, v, cur_pos=cur_pos, window=window)


def paged_mla_decode_attention(q_nope_abs: torch.Tensor,
                               q_rope: torch.Tensor,
                               latent_pool: torch.Tensor,
                               rope_pool: torch.Tensor, *,
                               pages: torch.Tensor, cur_pos: torch.Tensor,
                               head_dim_for_scale: int) -> torch.Tensor:
    """Absorbed-MLA decode over paged latent / rope pools
    ([num_pages, ps, R] / [num_pages, ps, Dr])."""
    lat = gather_paged_rows(latent_pool, pages)
    rope = gather_paged_rows(rope_pool, pages)
    return mla_decode_attention(q_nope_abs, q_rope, lat, rope,
                                cur_pos=cur_pos,
                                head_dim_for_scale=head_dim_for_scale)
