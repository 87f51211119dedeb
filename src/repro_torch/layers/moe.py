"""Mixture-of-experts FFN (port of ``repro.layers.moe``).

Dispatch is sort-based and grouped (static shapes): tokens are sorted by
assigned expert, placed into a fixed [E, G, d] buffer (G = capacity), the
expert products run as batched products, and the results combine back
with the router weights. Over-capacity tokens drop (their residual path
still carries them). Which tokens fill an expert's capacity follows the
reference exactly: a stable sort of the (token, choice) pairs by expert,
so a lower token index (then a lower choice rank) wins.

The [E, G, d] expert products are plain batched products, which the
reference leaves to XLA outside any Pallas kernel; here they are
``torch.bmm``. Routed experts are excluded from ZERO-resizing; the caller
composes the shared experts through the controlled FFN.

The path follows ``MoEConfig.expert_sharding`` as the reference's does.
Under ``"tp"`` (Mixtral's few big experts) over a group of more than one
rank, the experts run TP-local (``_moe_tp_local``): each rank holds 1/tp
of every expert's hidden width and combines its second products per
token BEFORE one sum over the group (``TPGroup.psum``, in rank order), so
the collective is [T, d], not [E, G, d]. Under ``"expert"`` (DeepSeek-V2's
64 experts) each expert keeps its full hidden width on one rank; the
reference leaves that split to GSPMD, and its function is the
single-group one, which the port computes at every tp.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import MoEConfig
from repro_torch.parallel import TPGroup


def router_topk(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, d] -> (expert_idx [T, k] int64, weights [T, k] in x.dtype,
    Switch-style load-balance aux loss, a scalar)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    T, E = logits.shape
    density = torch.zeros((E,), dtype=torch.float32, device=x.device)
    density.index_add_(0, idx.reshape(-1),
                       torch.ones((idx.numel(),), dtype=torch.float32,
                                  device=x.device))
    density = density / (T * cfg.top_k)
    aux = cfg.router_aux_coef * E * torch.sum(density * probs.mean(dim=0))
    return idx, weights.to(x.dtype), aux


def expert_capacity(T: int, cfg: MoEConfig) -> int:
    """Slots per expert: max(8, T·k·capacity_factor / E) rounded up to 8."""
    cap = max(8, int(T * cfg.top_k * cfg.capacity_factor / cfg.num_experts))
    return -(-cap // 8) * 8


def grouped_dispatch(idx: torch.Tensor, weights: torch.Tensor, T: int,
                     num_experts: int, capacity: int):
    """Sort-based dispatch. idx / weights [T, k].

    Returns gather ids [E, G] (into the tokens; T for an empty slot),
    combine weights [E, G] (0 for an empty slot) and, for the combine,
    each token's slots [T, k] in ascending order (E*G for a dropped
    choice). A (token, choice) past its expert's capacity is written to
    one spill slot past the end, which is cut off — no host sync, no
    out-of-range index."""
    k = idx.shape[1]
    dev = idx.device
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_w = weights.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    t_sorted = flat_t[order]
    w_sorted = flat_w[order]
    # position within the expert's segment of the sorted list
    seg_start = torch.searchsorted(
        e_sorted, torch.arange(num_experts, device=dev, dtype=e_sorted.dtype))
    pos = torch.arange(T * k, device=dev) - seg_start[e_sorted]
    n = num_experts * capacity
    slot = torch.where(pos < capacity,
                       e_sorted * capacity + torch.clamp(pos, 0, capacity - 1),
                       torch.full_like(e_sorted, n))
    gather_t = torch.full((n + 1,), T, dtype=torch.int64, device=dev)
    gather_t[slot] = t_sorted
    comb_w = torch.zeros((n + 1,), dtype=w_sorted.dtype, device=dev)
    comb_w[slot] = w_sorted
    token_slots = torch.empty_like(slot)
    token_slots[order] = slot
    return (gather_t[:n].reshape(num_experts, capacity),
            comb_w[:n].reshape(num_experts, capacity),
            torch.sort(token_slots.reshape(T, k), dim=1).values)


def _expert_products(xe: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, w_gate: Optional[torch.Tensor],
                     act_fn: Callable) -> torch.Tensor:
    """[E, G, d] grouped tokens through every expert's pair."""
    h = torch.bmm(xe, w_up)
    h = act_fn(torch.bmm(xe, w_gate)) * h if w_gate is not None \
        else act_fn(h)
    return torch.bmm(h, w_down)                            # [E, G, d]


def _combine(ye: torch.Tensor, comb_w: torch.Tensor,
             token_slots: torch.Tensor) -> torch.Tensor:
    """[E, G, d] expert rows -> [T, d]: each token sums its k expert rows
    in ascending slot order (the reference's scatter-add order) by a
    gather and a reduction over k — deterministic on the card, where a
    scatter-add is not."""
    d = ye.shape[-1]
    ye = ye * comb_w[..., None].to(ye.dtype)
    ye = torch.cat([ye.reshape(-1, d), ye.new_zeros((1, d))], dim=0)
    return ye[token_slots].sum(dim=1)


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor],
            cfg: MoEConfig, act_fn: Callable,
            group: Optional[TPGroup] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux loss). Routed experts only; the
    shared experts and dense layers are composed by the caller.
    ``params``: router [d, E] f32, w_up / w_gate [E, d, f], w_down
    [E, f, d]. Under ``expert_sharding="tp"`` a ``group`` of more than
    one rank runs the experts TP-local (:func:`_moe_tp_local`)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    idx, weights, aux = router_topk(xt, params["router"], cfg)
    capacity = expert_capacity(T, cfg)
    gather_t, comb_w, token_slots = grouped_dispatch(
        idx, weights, T, cfg.num_experts, capacity)
    xpad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    xe = xpad[gather_t]                                    # [E, G, d]
    if cfg.expert_sharding == "tp" and group is not None and group.e > 1:
        y = _moe_tp_local(xe, params, comb_w, token_slots, act_fn, group)
    else:
        y = _combine(_expert_products(xe, params["w_up"], params["w_down"],
                                      params.get("w_gate"), act_fn),
                     comb_w, token_slots)
    return y.reshape(B, S, d), aux


def _moe_tp_local(xe: torch.Tensor, params: Dict[str, torch.Tensor],
                  comb_w: torch.Tensor, token_slots: torch.Tensor,
                  act_fn: Callable, group: TPGroup) -> torch.Tensor:
    """TP-sharded experts (reference ``layers/moe.py:_moe_tp_local``):
    rank r multiplies the grouped tokens by its 1/e of every expert's
    hidden width (columns of w_up / w_gate, rows of w_down), combines
    its partial [E, G, d] rows per token, and the ranks' [T, d] partials
    meet in one ``psum`` (reduce-merging, the same trick as the paper's
    migration). Routing and dispatch are the group's (one data shard)."""
    f = params["w_up"].shape[-1]
    n = group._width(f, "expert hidden width")
    wg = params.get("w_gate")
    parts = []
    for r in range(group.e):
        cols = slice(r * n, (r + 1) * n)
        ye = _expert_products(
            xe, params["w_up"][..., cols], params["w_down"][:, cols],
            None if wg is None else wg[..., cols], act_fn)
        parts.append(_combine(ye, comb_w, token_slots))
    return group.psum(parts)
