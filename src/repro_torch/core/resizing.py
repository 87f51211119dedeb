"""ZERO-resizing (paper Sec. III), forward only (port of
``repro.core.resizing``): temporarily resize a TP linear's matrices by
pruning contraction-dimension blocks.

The reference picks the γ-bucket branch with ``lax.switch`` over
statically shaped pruned matmuls. Here, at ``tp == 1``, the bucket is one
host integer and the branch is a plain Python pick. Gradients (and the
imputation policies) come with the training slice.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.workload import keep_blocks_for_bucket


# ---------------------------------------------------------------------------
# Block gather primitives
# ---------------------------------------------------------------------------


def gather_cols(x: torch.Tensor, keep_idx: torch.Tensor,
                block: int) -> torch.Tensor:
    """Keep the given blocks of the last dim: [..., K] -> [..., kb*block]."""
    *lead, K = x.shape
    xb = x.reshape(*lead, K // block, block)
    xk = xb.index_select(-2, keep_idx.long())
    return xk.reshape(*lead, keep_idx.shape[0] * block)


def gather_rows(w: torch.Tensor, keep_idx: torch.Tensor,
                block: int) -> torch.Tensor:
    """Keep the given blocks of the first dim: [K, N] -> [kb*block, N]."""
    K, N = w.shape
    wb = w.reshape(K // block, block, N)
    wk = wb.index_select(0, keep_idx.long())
    return wk.reshape(keep_idx.shape[0] * block, N)


def keep_mask(keep_idx: torch.Tensor, num_blocks: int,
              block: int) -> torch.Tensor:
    """Boolean [num_blocks*block] mask, True where the dimension was kept."""
    m = torch.zeros((num_blocks,), dtype=torch.bool, device=keep_idx.device)
    m[keep_idx.long()] = True
    return m.repeat_interleave(block)


# ---------------------------------------------------------------------------
# Resized matmul (the paper's pruned computation, Fig. 2)
# ---------------------------------------------------------------------------


def resized_matmul(x: torch.Tensor, w: torch.Tensor, keep_idx: torch.Tensor,
                   *, block: int, use_kernel: bool = False) -> torch.Tensor:
    """y = x[:, keep] @ w[keep, :].

    x: [..., K]; w: [K, N]; keep_idx: [kb] int32 *block* indices (sorted).
    Output: [..., N] — same shape as the unpruned matmul.
    """
    if use_kernel:
        from repro_torch.kernels import ops
        return ops.block_pruned_matmul(x, w, keep_idx, block=block)
    return gather_cols(x, keep_idx, block) @ gather_rows(w, keep_idx, block)


def resized_ffn(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                keep_idx: torch.Tensor, act_fn,
                w_gate: Optional[torch.Tensor] = None, *, block: int,
                use_kernel: bool = False) -> torch.Tensor:
    """Pruned FFN pair y = act(x @ Wup[:, keep] [, · gate]) @ Wdown[keep, :].

    With ``use_kernel`` the pair runs through the pruned-FFN kernel;
    otherwise through gathers and plain products.
    """
    if use_kernel:
        from repro_torch.kernels import ops
        return ops.fused_pruned_ffn(x, w_up, w_down, keep_idx, w_gate,
                                    act_fn, block)
    h = x @ gather_cols(w_up, keep_idx, block)
    if w_gate is not None:
        h = act_fn(x @ gather_cols(w_gate, keep_idx, block)) * h
    else:
        h = act_fn(h)
    return h @ gather_rows(w_down, keep_idx, block)


def sorted_prefix(pri_list: torch.Tensor, kc: int) -> torch.Tensor:
    """The kept block ids of a keep-first list, "concatenated in
    lexicographical order"."""
    return torch.sort(pri_list[:kc]).values


def switched_matmul(x: torch.Tensor, w: torch.Tensor,
                    pri_list: torch.Tensor, bucket_idx: int, *,
                    buckets: Sequence[float], block: int,
                    use_kernel: bool = False,
                    keep_for: Optional[Callable[[int], torch.Tensor]] = None
                    ) -> torch.Tensor:
    """γ-bucket dispatch: the bucket's keep count picks a dense product
    (every block kept) or the pruned product over the sorted keep-first
    prefix of ``pri_list`` ([nb] int32 permutation of block ids).

    ``keep_for(kc)``, when given, returns that sorted prefix from a cache
    (the controlled layers share one per plan), saving a sort per call."""
    nb = w.shape[0] // block
    kc = keep_blocks_for_bucket(buckets[int(bucket_idx)], nb)
    if kc >= nb:
        return x @ w
    keep = keep_for(kc) if keep_for is not None else sorted_prefix(pri_list,
                                                                   kc)
    return resized_matmul(x, w, keep, block=block, use_kernel=use_kernel)
