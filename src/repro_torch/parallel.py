"""Tensor-parallel group emulated in one process (the counterpart of
``repro.sharding`` and ``repro.launch.mesh`` for the training slice).

The reference shards its parameters over a JAX mesh's ``model`` axis
(GSPMD's even split) and runs the controlled layers inside
``shard_map``, one program per rank. Here the ``e`` ranks of one TP
group run in one process, in turn: the parameters stay GLOBAL tensors
(so AdamW sees one global tree, as in JAX), and :class:`TPGroup` hands
rank ``r`` its shard as a VIEW — columns ``[r*n, (r+1)*n)`` of a
column-split weight (``w_up`` / ``w_gate`` / ``wq`` / ``wk`` / ``wv``),
rows of a row-split one (``w_down`` / ``wo``). Autograd takes each rank's
gradient back through the view into the global ``.grad``.

The collectives are explicit sums behind a small interface, so that
``torch.distributed`` (NCCL across real cards) can take their place:

* :meth:`TPGroup.psum` — the all-reduce, summed in fixed rank order
  0..e-1;
* :meth:`TPGroup.chunked_psum` — the reference's ``chunked_psum``: the
  last dim split into ``n`` independent sums (the divisor fallback
  kept);
* :meth:`TPGroup.bcast_from` — the masked psum of the reference's
  ``migration._bcast_from``: every rank contributes zeros except the
  source. In one process it reads the source's value directly — the
  other terms are exact zeros — and autograd routes the gradient back
  to the source's shard only, as JAX's transposed psum does.
"""
from __future__ import annotations

from typing import Callable, Sequence, TypeVar

import torch

T = TypeVar("T")


class TPGroup:
    """``e`` tensor-parallel ranks in one process."""

    def __init__(self, e: int):
        if e < 1:
            raise ValueError(f"a TP group needs at least one rank, got {e}")
        self.e = int(e)

    # -- shards (views of the global tensors) ---------------------------------
    def _width(self, n: int, what: str) -> int:
        if n % self.e:
            raise ValueError(
                f"{what} of {n} does not split evenly over {self.e} ranks")
        return n // self.e

    def cols(self, w: torch.Tensor, r: int) -> torch.Tensor:
        """Rank ``r``'s shard of a column-split weight (last dim)."""
        n = self._width(w.shape[-1], "last dim")
        return w[..., r * n:(r + 1) * n]

    def rows(self, w: torch.Tensor, r: int) -> torch.Tensor:
        """Rank ``r``'s shard of a row-split weight (first dim)."""
        n = self._width(w.shape[0], "first dim")
        return w[r * n:(r + 1) * n]

    # -- collectives -----------------------------------------------------------
    def _check(self, parts: Sequence[torch.Tensor]) -> None:
        if len(parts) != self.e:
            raise ValueError(f"expected one part per rank ({self.e}), got "
                             f"{len(parts)}")

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """All-reduce: the sum of the ranks' parts in rank order."""
        self._check(parts)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def chunked_psum(self, parts: Sequence[torch.Tensor],
                     n_chunks: int) -> torch.Tensor:
        """The all-reduce split into independent sums over chunks of the
        last dim. ``n_chunks`` falls back to the largest divisor of the
        last dim at or below the request (1 = one plain psum), as the
        reference's ``tp_linear.chunked_psum``. The value is the same
        sum either way; the chunks only matter to a real collective."""
        self._check(parts)
        if n_chunks <= 1:
            return self.psum(parts)
        d = parts[0].shape[-1]
        n = min(n_chunks, d)
        while n > 1 and d % n:
            n -= 1
        if n <= 1:
            return self.psum(parts)
        pieces = [torch.chunk(p, n, dim=-1) for p in parts]
        return torch.cat([self.psum([pc[i] for pc in pieces])
                          for i in range(n)], dim=-1)

    def bcast_from(self, src: int, value_of: Callable[[int], T]) -> T:
        """The value of rank ``src`` on every rank (masked psum).

        ``value_of(rank)`` is a rank's contribution; only the source's
        survives the masked sum, so only it is computed. An idle source
        (-1) is the caller's to handle: every rank then contributes
        zeros."""
        if not isinstance(src, int) or not 0 <= src < self.e:
            raise ValueError(f"source rank {src!r} outside the group of "
                             f"{self.e}")
        return value_of(src)
