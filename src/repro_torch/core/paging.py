"""Block-paged KV cache layout + host-side page allocator.

The serve engine's fixed slot cache reserves ``num_slots x max_len``
positions up front: a slot holding an 8-token prompt pays for all
``max_len`` rows, and the engine can never hold more resident requests
than slots even when every request is short. Paging (vLLM-style, cf.
saxml's batched serving path) splits each slot's sequence into
fixed-size pages over a SHARED ``[num_pages, page_size, ...]`` pool:

* the **pool** replaces the per-slot seq axis in every attention cache
  leaf (``models/lm.py``): GQA ``[num_pages, KV, page_size, hd]``, MLA
  ``[num_pages, page_size, R]`` — recurrent state leaves (SSM/RG-LRU)
  have no seq axis and keep their slot-batch layout;
* the **page table** ``[num_slots, pages_per_slot]`` (int32, -1 =
  unallocated) maps a slot's linear positions to pool pages; it is a
  regular per-step device input (like ``cur_pos``), host-owned by the
  :class:`PageAllocator` — allocation never touches jitted code;
* writes go through a redirect: an unallocated / out-of-range position
  maps to page id ``num_pages`` which jax's scatter ``mode="drop"``
  discards — invalid lanes of a chunked-prefill substep write nowhere;
* reads gather pool pages through the (clipped) table and mask by
  position exactly like the fixed path, so a freed page can be handed
  to a new slot WITHOUT zeroing (positions > cur_pos are masked,
  <= cur_pos are rewritten by prefill before they are ever attended).

``kv_int8`` stores the GQA K/V pool in int8 with a per-row f32 scale
(``abs(row).max()/127``), halving pool HBM so the same budget holds 2x
the pages. Quantized decode is NOT bit-exact vs f32 — the engine keeps
it opt-in and the bench gates it separately.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# Positions redirected here never write: the page lookup sees an
# out-of-range page index and maps it to the dropped page id. Finite and
# far above any real max_len, so rope/masks stay NaN-free.
INVALID_POS = np.int32(2 ** 30)


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static shape of one paged-cache configuration."""

    page_size: int                 # positions per page
    pages_per_slot: int            # ceil(max_len / page_size)
    num_pages: int                 # shared pool size (all slots)
    kv_int8: bool = False          # int8 K/V pool + per-row f32 scales

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {self.num_pages}")

    @property
    def padded_len(self) -> int:
        """Linear positions addressable through one slot's page list."""
        return self.page_size * self.pages_per_slot

    def pages_for(self, num_positions: int) -> int:
        """Pages needed to hold ``num_positions`` cache rows."""
        return -(-int(num_positions) // self.page_size)


def paged_layout(max_len: int, page_size: int, num_slots: int,
                 num_pages: Optional[int] = None,
                 kv_int8: bool = False) -> PagedLayout:
    """Build a layout for an engine configuration.

    ``num_pages`` defaults to full fixed-cache capacity
    (``num_slots * pages_per_slot`` — every slot can grow to max_len
    simultaneously); benchmarks pass a smaller pool to realize the
    capacity win (more slots than the pool could hold at max_len)."""
    pps = -(-int(max_len) // int(page_size))
    return PagedLayout(page_size=int(page_size), pages_per_slot=pps,
                       num_pages=int(num_pages) if num_pages is not None
                       else int(num_slots) * pps, kv_int8=kv_int8)


class PageAllocator:
    """Host-side free-list allocator over the shared page pool.

    Invariants (asserted by tests/test_paged_serve.py):

    * a page id is owned by AT MOST one slot at a time — ``ensure`` only
      hands out ids from the free list, ``free_slot`` returns a slot's
      whole list (so a preempted neighbor can never alias a live page);
    * ``table()`` row ``s`` holds slot s's pages in sequence order,
      ``-1`` past the allocated frontier;
    * allocation is lazy and monotone per slot: ``ensure(s, upto_pos)``
      extends the slot's list just enough to cover ``upto_pos``.
    """

    def __init__(self, layout: PagedLayout, num_slots: int):
        self.layout = layout
        self.num_slots = num_slots
        # LIFO free list: recycled pages are re-issued hottest-first
        self._free: List[int] = list(range(layout.num_pages))[::-1]
        self._owned: List[List[int]] = [[] for _ in range(num_slots)]
        self._table = np.full((num_slots, layout.pages_per_slot), -1,
                              np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def used_pages(self, slot: int) -> int:
        return len(self._owned[slot])

    def can_fit(self, num_positions: int) -> bool:
        return self.layout.pages_for(num_positions) <= self.free_pages

    def ensure(self, slot: int, upto_pos: int) -> bool:
        """Grow slot's page list to cover linear position ``upto_pos``.

        Returns False (allocating NOTHING) if the free list cannot cover
        the growth — the caller preempts or raises; a partial grant
        would leave a write with no page to land in."""
        need = self.layout.pages_for(upto_pos + 1)
        if need > self.layout.pages_per_slot:
            raise ValueError(
                f"slot {slot}: position {upto_pos} needs {need} pages but "
                f"the layout caps a slot at {self.layout.pages_per_slot}")
        grow = need - len(self._owned[slot])
        if grow <= 0:
            return True
        if grow > len(self._free):
            return False
        for _ in range(grow):
            page = self._free.pop()
            self._table[slot, len(self._owned[slot])] = page
            self._owned[slot].append(page)
        return True

    def free_slot(self, slot: int) -> None:
        """Return all of a slot's pages to the free list (no zeroing —
        reads mask by position, prefill rewrites before attending)."""
        self._free.extend(self._owned[slot])
        self._owned[slot] = []
        self._table[slot, :] = -1

    def table(self) -> np.ndarray:
        """[num_slots, pages_per_slot] int32 page table (-1 = unset).
        A copy — the jitted step must never see in-place growth."""
        return self._table.copy()
