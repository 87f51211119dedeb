"""ZERO-resizing (paper Sec. III), port of ``repro.core.resizing``:
temporarily resize a TP linear's matrices by pruning contraction-
dimension blocks, with lineage-correct zero imputation of the missing
gradient rows/columns.

As in the reference, the paper's lineage table + imputation machinery
falls out of autodiff: :func:`resized_matmul` is gather(keep blocks) →
matmul, and the VJP of ``index_select`` scatters the gradient to exactly
the kept positions and ZEROS to the pruned ones — Zero-imputation with a
correctly matched lineage, by construction. The kernel path
(``use_kernel``) gets the same zeros from its backward kernels, which
write the pruned blocks in-kernel. The ``average`` / ``same`` policies
of Fig. 3 are explicit gradient transforms (:func:`impute_gradients`).

The reference picks the γ-bucket branch with ``lax.switch`` over
statically shaped pruned matmuls; here the bucket is a host integer and
the branch a plain Python pick.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

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


def scatter_cols(xk: torch.Tensor, keep_idx: torch.Tensor, block: int,
                 K: int) -> torch.Tensor:
    """Inverse of :func:`gather_cols` with zeros at the pruned blocks
    (Zero imputation): [..., kb*block] -> [..., K]."""
    *lead, Kk = xk.shape
    out = xk.new_zeros((*lead, K // block, block))
    out[..., keep_idx.long(), :] = xk.reshape(*lead, Kk // block, block)
    return out.reshape(*lead, K)


def keep_mask(keep_idx: torch.Tensor, num_blocks: int,
              block: int) -> torch.Tensor:
    """Boolean [num_blocks*block] mask, True where the dimension was kept."""
    m = torch.zeros((num_blocks,), dtype=torch.bool, device=keep_idx.device)
    # index_fill_ takes the value as a scalar: no host tensor to upload
    m.index_fill_(0, keep_idx.long(), True)
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


# ---------------------------------------------------------------------------
# Imputation policies (Fig. 3: Zero / Average / Same)
# ---------------------------------------------------------------------------


def impute_rows(grad: torch.Tensor, kept: torch.Tensor, mode: str,
                prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fill the pruned (not-kept) rows of a [K, N] gradient.

    zero    — leave zeros (the paper's final choice; free).
    average — mean over the kept rows of the current iteration.
    same    — the value from the previous iteration's gradient (``prev``).
    """
    if mode == "zero":
        return grad
    kept_f = kept.to(grad.dtype)[:, None]
    if mode == "average":
        denom = torch.clamp(kept_f.sum(), min=1.0)
        avg = (grad * kept_f).sum(dim=0, keepdim=True) / denom
        return grad * kept_f + avg * (1.0 - kept_f)
    if mode == "same":
        if prev is None:
            return grad
        return grad * kept_f + prev * (1.0 - kept_f)
    raise ValueError(f"unknown imputation mode {mode!r}")


def impute_gradients(grads: Dict[str, torch.Tensor],
                     keep_masks: Dict[str, Optional[torch.Tensor]],
                     mode: str,
                     prev_grads: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Apply :func:`impute_rows` across named weight gradients.

    ``keep_masks`` maps a name to a bool [K] mask of kept contraction rows,
    or to None (that weight is left untouched, as is any gradient that is
    not 2-D). ``prev_grads`` (for ``same``) is keyed like ``grads``.
    """
    if mode == "zero":
        return grads
    out = {}
    for name, g in grads.items():
        m = keep_masks.get(name)
        if m is None or g.ndim != 2:
            out[name] = g
        else:
            prev = prev_grads.get(name) if prev_grads is not None else None
            out[name] = impute_rows(g, m, mode, prev)
    return out
