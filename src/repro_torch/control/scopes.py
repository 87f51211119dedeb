"""Prunable-scope discovery and plan-array assembly (port of
``repro.control.scopes``).

The controller reasons about abstract "blocks"; the model exposes concrete
prunable scopes (ffn / qkv / attn_out) whose block counts depend on the
architecture and the TP degree. This module is the single place that maps
between the two. Plan arrays are torch int32 tensors; the reference's
sharding specs (``plan_specs``) have no counterpart here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.workload import PlanStatic, adapt_block_size


# scope -> layout of its priority list:
#   "col": contraction replicated across TP -> global pri [nb]
#   "row": contraction TP-sharded          -> per-rank pri [tp, nb]
SCOPE_LAYOUT = {"qkv": "col", "attn_out": "row", "ffn": "row"}


def per_rank_pri(global_pri, e: int, nb_loc: int, geometry=None):
    """Split a GLOBAL keep-first block permutation into per-rank local
    keep-first lists.

    Equal split (geometry None): rank r owns global blocks
    [r·nb_loc, (r+1)·nb_loc) — the helper renumbering is a plain modulo.

    Ragged split (geometry = per-rank block counts): rank r owns canonical
    blocks [off_r, off_r + geometry[r]); canonical block off_r + j sits in
    local slot j of the padded layout. Each row lists the rank's real
    blocks in keep-first order first, then its padding slot ids
    [geometry[r], nb_loc) — padding can never be selected because every
    keep count is capped at geometry[r]."""
    global_pri = [int(g) for g in np.asarray(global_pri)]
    if geometry is None:
        out = np.zeros((e, nb_loc), np.int32)
        for r in range(e):
            lo, hi = r * nb_loc, (r + 1) * nb_loc
            mine = [g - lo for g in global_pri if lo <= g < hi]
            out[r] = np.asarray(mine, np.int32)
        return out
    sizes = tuple(int(s) for s in geometry)
    if len(sizes) != e:
        raise ValueError(f"geometry {sizes} has {len(sizes)} ranks, e={e}")
    if max(sizes) != nb_loc:
        raise ValueError(
            f"padded local block count {nb_loc} != max(geometry)={max(sizes)}")
    out = np.zeros((e, nb_loc), np.int32)
    off = 0
    for r, L in enumerate(sizes):
        mine = [g - off for g in global_pri if off <= g < off + L]
        if len(mine) != L:
            raise ValueError(
                f"global pri covers {len(mine)} of rank {r}'s {L} blocks")
        out[r] = np.asarray(mine + list(range(L, nb_loc)), np.int32)
        off += L
    return out


def plan_pri_arrays(scopes: Dict[str, int], pri_lists: Dict[str, Any],
                    tp: int, geometry=None,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Priority tensors for a plan on ``device``: the controller's
    keep-first permutations where available (split per rank for row
    scopes), identity order otherwise.

    ``geometry`` (per-rank block counts) applies to the "ffn" scope only:
    that is the scope the ragged shard geometry redistributes; attention
    scopes keep the equal split."""
    out = {}
    for name, nb in scopes.items():
        pri = pri_lists.get(name)
        if pri is not None:
            pri = np.asarray(pri)
        if SCOPE_LAYOUT.get(name, "row") == "col":
            if pri is None or pri.shape[0] != nb:
                pri = np.arange(nb, dtype=np.int32)
            arr = np.asarray(pri, np.int32)
        elif geometry is not None and name == "ffn":
            nb_total = int(sum(geometry))
            if pri is None or pri.shape[0] != nb_total:
                pri = np.arange(nb_total, dtype=np.int32)
            arr = per_rank_pri(pri, tp, nb, geometry)
        else:
            nb_total = nb * tp
            if pri is None or pri.shape[0] != nb_total:
                pri = np.arange(nb_total, dtype=np.int32)
            arr = per_rank_pri(pri, tp, nb)
        out[name] = torch.as_tensor(arr, dtype=torch.int32, device=device)
    return out


def control_scopes(cfg: ModelConfig, static: PlanStatic) -> Dict[str, int]:
    """Prunable scopes and their block counts for this arch at this TP.

    ffn      — intermediate (d_ff/e) blocks, resizing + migration.
    qkv      — d_model contraction blocks of the col-split projections
               (replicated across TP, so divisibility is vs d_model).
    attn_out — per-rank (H·hd/e) contraction blocks of the out projection.
    A scope with no >=32-lane divisor is exempt."""
    e = static.tp_size
    scopes: Dict[str, int] = {}
    b_ffn = control_block_size(cfg, static)
    if b_ffn:
        scopes["ffn"] = (_controlled_dff(cfg) // e) // b_ffn
    if cfg.num_heads and cfg.mla is None:
        b_qkv = adapt_block_size(cfg.d_model, static.block_size)
        if b_qkv and cfg.d_model // b_qkv >= 2:
            scopes["qkv"] = cfg.d_model // b_qkv
        attn_loc = (cfg.num_heads * cfg.resolved_head_dim) // e
        b_out = adapt_block_size(attn_loc, static.block_size)
        if b_out and attn_loc // b_out >= 2:
            scopes["attn_out"] = attn_loc // b_out
    return scopes


def scope_block_table(cfg: ModelConfig, static: PlanStatic):
    """Hashable (scope, block) pairs for PlanStatic.scope_blocks."""
    e = static.tp_size
    out = []
    b_ffn = control_block_size(cfg, static)
    if b_ffn:
        out.append(("ffn", b_ffn))
    if cfg.num_heads and cfg.mla is None:
        b_qkv = adapt_block_size(cfg.d_model, static.block_size)
        if b_qkv:
            out.append(("qkv", b_qkv))
        b_out = adapt_block_size((cfg.num_heads * cfg.resolved_head_dim) // e,
                                 static.block_size)
        if b_out:
            out.append(("attn_out", b_out))
    return tuple(out)


def _controlled_dff(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.moe is not None:
        return cfg.moe.num_shared_experts * (cfg.moe.d_shared or cfg.moe.d_expert)
    return cfg.d_ff


def control_block_size(cfg: ModelConfig, static: PlanStatic) -> int:
    """Largest block dividing the per-rank FFN width, capped by the
    configured preference; 0 => this arch's FFN is exempt at this TP
    degree (e.g. yi-6b's 11008/16 = 688 is 16·43, below the 32-lane
    floor)."""
    dff = _controlled_dff(cfg)
    if dff == 0:
        return 0
    loc = dff // static.tp_size
    b = adapt_block_size(loc, static.block_size)
    if b and loc // b >= 2:
        return b
    return 0
