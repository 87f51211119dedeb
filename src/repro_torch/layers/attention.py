"""Attention pieces for decode (port of ``repro.layers.attention``):
rotary embeddings and the plain one-token decode attention.

``decode_attention`` is the plain version of the fused decode kernel
(``kernels/ops.fused_decode_attention``): it materializes the
[B, Hkv, G, S] scores. Prefill attention, M-RoPE, MLA and the paged
variants come with later slices.
"""
from __future__ import annotations

import math

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
