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
* :meth:`TPGroup.bcast_grouped` — the masked psum of the reference's
  ``migration.fused_migration_broadcast``: every migration slot's
  buffers from its own source in ONE grouped psum over all of them, to
  which every rank contributes zeros except each slot's source. In one
  process it reads each source's value directly — the other terms are
  exact zeros — and autograd routes the gradient back to the source's
  shard only, as JAX's transposed psum does.

A ragged static shard geometry (:mod:`repro_torch.core.geometry`) keeps
this equal split: the FFN's hidden width is padded so that it divides
evenly, each rank's view holding its real blocks first and zero blocks
after (:func:`ragged_local_width` checks the arithmetic).

While the analyzer records a run it installs a hook
(:func:`set_collective_hook`) that receives each collective: its kind,
operand count and operand shapes (rule R3).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

_collective_hook = None


def set_collective_hook(hook):
    """Install ``hook(kind, n_operands, shapes)``, called once per
    collective (``None`` removes it); returns the previous hook."""
    global _collective_hook
    prev, _collective_hook = _collective_hook, hook
    return prev


def _report(kind: str, operands) -> None:
    if _collective_hook is not None:
        _collective_hook(kind, len(operands),
                         tuple(tuple(t.shape) for t in operands))


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
        _report("psum", (out,))
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

    def _check_src(self, src: int) -> None:
        if not isinstance(src, int) or not 0 <= src < self.e:
            raise ValueError(f"source rank {src!r} outside the group of "
                             f"{self.e}")

    def bcast_grouped(self, srcs: Sequence[int],
                      value_of: Callable[[int, int], Sequence[Optional[
                          torch.Tensor]]]) -> List[Tuple]:
        """Every slot's buffers from that slot's source, in ONE masked psum.

        ``value_of(rank, slot)`` is a rank's contribution to slot ``slot``
        (a tuple of tensors, ``None`` for an absent one); only each slot's
        source survives the masked sum, so only it is computed. An idle
        slot (source -1) gets zeros shaped as rank 0's contribution.
        Returns one tuple per slot."""
        out = []
        for s, src in enumerate(srcs):
            if src != -1:
                self._check_src(src)
                out.append(tuple(value_of(src, s)))
            else:
                out.append(tuple(None if t is None else torch.zeros_like(t)
                                 for t in value_of(0, s)))
        _report("bcast_grouped",
                [t for bufs in out for t in bufs if t is not None])
        return out


def ragged_local_width(padded_width: int, group: TPGroup,
                       axis: str = "model") -> int:
    """Per-rank lane count of the padded ragged-FFN layout (the
    reference's ``sharding.ragged_local_width``, over the group in place
    of the mesh's ``axis``): the padded width must split evenly over the
    group's ranks."""
    n = group.e
    if padded_width % n:
        raise ValueError(
            f"padded FFN width {padded_width} does not equal-split over "
            f"the {n}-way {axis!r} mesh axis — the geometry's padded "
            "layout is malformed")
    return padded_width // n
