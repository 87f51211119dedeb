"""Priority pruning principles (paper Sec. III-B, Algorithm 1).

Maintains, per prunable weight scope (layer × matrix), a per-block weight
variation statistic ``w_var`` and derives a keep-first priority permutation
``pri_list``. Three design points from the paper:

* **Priority selection** — blocks whose weights changed least are pruned
  first (they "have a relatively marginal impact on subsequent rounds").
* **Incremental update** — statistics of blocks that were pruned in the
  last window are *preserved*, not refreshed: zero-imputed gradients leave
  pruned weights unchanged, so refreshing would measure a false small
  variation and re-prune the same blocks forever (the paper's
  "endless loop"/false-positive phenomenon). Preserving the stat instead
  yields a round-robin yet prioritized schedule.
* **Differentiated per-layer ratios** — layer k's ratio γ_k is driven by
  how many of its blocks fall below the threshold θ = N_iter·θ_iter, with
  the floor α·γ so the aggregate heterogeneity target is still met.

Granularity note: the statistics are per 128-column *block* (mean of the
per-column mean |Δw|), per DESIGN.md §7.1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.workload import bucket_for_gamma


@dataclasses.dataclass
class PriorityState:
    """Host-side statistics for one prunable weight scope."""

    num_blocks: int
    w_var: np.ndarray                    # [nb] mean |Δw| per block
    pruned_last: np.ndarray              # [nb] bool: pruned in last window
    snapshot: Optional[np.ndarray] = None  # weight values at last update

    @staticmethod
    def create(num_blocks: int) -> "PriorityState":
        return PriorityState(
            num_blocks=num_blocks,
            w_var=np.full((num_blocks,), np.inf, np.float64),  # unseen = important
            pruned_last=np.zeros((num_blocks,), bool),
        )


def block_variation(w_old: np.ndarray, w_new: np.ndarray, block: int) -> np.ndarray:
    """Per-block mean |Δw| along the contraction (first) axis of a [K, N]
    weight: Alg. 1 line 4, extended to block granularity."""
    delta = np.abs(np.asarray(w_new, np.float64) - np.asarray(w_old, np.float64))
    per_row = delta.mean(axis=tuple(range(1, delta.ndim)))  # [K]
    K = per_row.shape[0]
    return per_row.reshape(K // block, block).mean(axis=1)


def update_state(state: PriorityState, w_new: np.ndarray, block: int) -> PriorityState:
    """Incremental statistics update (Alg. 1 lines 4-8).

    Blocks pruned in the last window keep their old statistic (their
    weights were frozen by zero-imputation — a fresh measurement would be
    a false positive). Others are refreshed from the weight delta.
    """
    w_new = np.asarray(w_new)
    if state.snapshot is None:
        return dataclasses.replace(
            state, snapshot=w_new.copy(),
            w_var=np.full((state.num_blocks,), np.inf, np.float64))
    fresh = block_variation(state.snapshot, w_new, block)
    w_var = np.where(state.pruned_last, state.w_var, fresh)
    # snapshot only advances for refreshed blocks, so a preserved block's
    # next real refinement is measured against its last *refined* value.
    K = w_new.shape[0]
    keep_rows = np.repeat(state.pruned_last, block)
    shape = (K,) + (1,) * (w_new.ndim - 1)
    snap = np.where(keep_rows.reshape(shape), state.snapshot, w_new)
    return dataclasses.replace(state, w_var=w_var, snapshot=snap)


def build_pri_list(state: PriorityState, rng: Optional[np.random.Generator] = None,
                   selection: str = "priority") -> np.ndarray:
    """Keep-first permutation of block ids.

    priority — descending variation (large-change blocks kept; Alg.1 l.5/13)
    random   — the paper's ZERO-Rd baseline.
    """
    if selection == "random":
        rng = rng or np.random.default_rng(0)
        return rng.permutation(state.num_blocks).astype(np.int32)
    order = np.argsort(-np.nan_to_num(state.w_var, posinf=np.finfo(np.float64).max),
                       kind="stable")
    return order.astype(np.int32)


def mark_pruned(state: PriorityState, pri_list: np.ndarray, keep_blocks: int) -> PriorityState:
    pruned = np.ones((state.num_blocks,), bool)
    pruned[pri_list[:keep_blocks]] = False
    return dataclasses.replace(state, pruned_last=pruned)


def differentiated_gamma(states: Dict[str, PriorityState], gamma_uniform: float,
                         *, alpha: float, theta: float,
                         buckets) -> Dict[str, int]:
    """Per-layer bucket indices (Alg. 1 lines 9-12).

    L_uni = #blocks with variation > θ (still "moving" → keep);
    γ_k = 1 - L_uni/L_k, floored by α·γ_uniform, then bucket-rounded UP.
    """
    out = {}
    for name, st in states.items():
        finite = np.nan_to_num(st.w_var, posinf=np.finfo(np.float64).max)
        l_uni = int((finite > theta).sum())
        gamma_k = 1.0 - l_uni / max(st.num_blocks, 1)
        gamma_k = max(gamma_k, alpha * gamma_uniform)
        gamma_k = min(gamma_k, max(buckets))
        out[name] = bucket_for_gamma(gamma_k, buckets)
    return out
