"""Tensor-parallel linear layers with flexible workload control (port of
``repro.layers.tp_linear``).

Two execution paths per op, as in the reference:

* **plain** (ctx is None, or the scope is not controlled): dense
  products on the global tensors.
* **controlled**: each of the ``e`` ranks of the group applies its own
  γ-bucket — ZERO-resizing over its keep-first priority list ``pri`` —
  and, for FFN pairs, each straggler in the concurrent source set sheds
  its slot's ``m_s`` intermediate blocks to the helpers (migration with
  reduce-merging, :mod:`repro_torch.core.migration`). Per rank::

      [ keep (kc_b - m_s·is_straggler) | migrate m_s (slot source only) | pruned ]

The reference runs the ranks inside ``shard_map`` with a ``lax.switch``
over (bucket × source slot) branches. Here the ranks of one TP group run
in one process (:class:`repro_torch.parallel.TPGroup`): each rank's
bucket and the plan's source ranks are host integers, read once per plan,
so every branch choice is a Python pick and no layer syncs with the
device. Each rank computes on views of the global weights; the row-split
epilogue is the group's ``chunked_psum``.

A ragged static shard geometry (``PlanStatic.geometry``,
:mod:`repro_torch.core.geometry`) applies to the FFN pair only: the
weights carry the padded width, rank r's view holds its ``geometry[r]``
real blocks first, and each rank's keep count is quantized against its
own size class, so a small rank never gathers its padding.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import resizing
from repro_torch.core.migration import (fused_migration_broadcast,
                                        fused_migration_delta)
from repro_torch.core.workload import PlanStatic, keep_blocks_for_bucket
from repro_torch.parallel import TPGroup


@dataclasses.dataclass
class ControlContext:
    """Plan handed to the controlled layers for one step.

    bucket_by_rank: [e] int host tensor or array — each rank's bucket is
                    read as a Python integer to pick its branch
    pri:            scope -> [nb] ("col") / [e, nb_loc] ("row") int32,
                    on the device of the weights
    mig_src:        the source rank of each migration slot, host ints
                    aligned with ``static.mig_sheds`` (-1 = slot idle);
                    padded / trimmed to the slot count
    psum_chunks:    chunk-split the row-split epilogue all-reduce
    group:          the TP group (``TPGroup(static.tp_size)`` if None)
    """

    static: PlanStatic
    bucket_by_rank: object
    pri: Dict[str, torch.Tensor]
    use_kernel: bool = False
    mig_src: Sequence[int] = ()
    psum_chunks: int = 1
    group: Optional[TPGroup] = None
    _keep: Dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        b = self.bucket_by_rank
        b = b.tolist() if hasattr(b, "tolist") else list(b)
        self.buckets: List[int] = [int(v) for v in
                                   (b if isinstance(b, list) else [b])]
        if self.group is None:
            self.group = TPGroup(self.static.tp_size)
        S = len(self.static.mig_sheds)
        srcs = [int(s) for s in (self.mig_src.tolist()
                                 if hasattr(self.mig_src, "tolist")
                                 else list(self.mig_src))][:S]
        self.srcs: List[int] = srcs + [-1] * (S - len(srcs))

    def pri_list(self, scope: str, rank: int = 0) -> torch.Tensor:
        """A rank's keep-first list for a scope (the global list of a
        "col" scope is every rank's)."""
        pri = self.pri[scope]
        return pri if pri.ndim == 1 else pri[rank]

    def keep(self, scope: str, kc: int, rank: int = 0) -> torch.Tensor:
        """Sorted kept block ids of a scope at keep count ``kc`` on a rank,
        computed once per plan and shared by every layer."""
        pri = self.pri[scope]
        key = (scope, kc, rank if pri.ndim > 1 else -1)
        if key not in self._keep:
            self._keep[key] = resizing.sorted_prefix(
                self.pri_list(scope, rank), kc)
        return self._keep[key]

    def check_supported(self) -> None:
        st = self.static
        if len(self.buckets) != st.tp_size or self.group.e != st.tp_size:
            raise ValueError(
                f"plan for tp={st.tp_size} carries {len(self.buckets)} "
                f"buckets and a group of {self.group.e}")
        if st.per_layer:
            raise NotImplementedError(
                "per-layer plans (priority_diff) come with the LM training "
                "and prefill slice of the port (ROADMAP.md, queue A.5)")


# ---------------------------------------------------------------------------
# Controlled projection (resizing only) — attention projections
# ---------------------------------------------------------------------------


def controlled_proj(x: torch.Tensor, w: torch.Tensor,
                    ctx: Optional[ControlContext], scope: str, *,
                    split: str) -> torch.Tensor:
    """TP linear with per-rank ZERO-resizing on the contraction dim.

    split="col": w [K, N] split on N over the ranks; x replicated. Every
      rank prunes its K blocks by the scope's global list; the ranks'
      outputs are concatenated along N.
    split="row": w [K, N] split on K; x split on its last dim. Each rank
      prunes its local K blocks by its own list; the partial outputs are
      all-reduced.
    """
    if split not in ("col", "row"):
        raise ValueError(f"split must be 'col' or 'row', got {split!r}")
    if ctx is None or scope not in ctx.pri:
        return x @ w
    ctx.check_supported()
    st, g = ctx.static, ctx.group
    blk = st.block_for(scope)

    def rank_product(xr, wr, r):
        return resizing.switched_matmul(
            xr, wr, ctx.pri_list(scope, r), ctx.buckets[r],
            buckets=st.buckets, block=blk, use_kernel=ctx.use_kernel,
            keep_for=lambda kc: ctx.keep(scope, kc, r))

    if split == "col":
        outs = [rank_product(x, g.cols(w, r), r) for r in range(g.e)]
        return outs[0] if g.e == 1 else torch.cat(outs, dim=-1)
    parts = [rank_product(g.cols(x, r), g.rows(w, r), r) for r in range(g.e)]
    return g.chunked_psum(parts, ctx.psum_chunks)


# ---------------------------------------------------------------------------
# Controlled FFN pair (resizing + migration with reduce-merging)
# ---------------------------------------------------------------------------


def _dense_pair(x2, wu, wd, wg, act_fn):
    h = x2 @ wu
    h = act_fn(x2 @ wg) * h if wg is not None else act_fn(h)
    return h @ wd


def controlled_ffn(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                   ctx: Optional[ControlContext], scope: str,
                   act_fn: Callable,
                   w_gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FFN pair y = act(x@w_up[,·gate]) @ w_down under workload control.

    w_up/w_gate: [d, H] column-split over the ranks; w_down: [H, d_out]
    row-split. The intermediate H blocks are the controlled workload
    unit: each rank resizes by its bucket; each straggler in the source
    set additionally migrates its slot's ``m_s`` blocks, which the
    helpers compute from the broadcast slices and merge into the single
    all-reduce (reduce-merging, Sec. IV-A).

    Under a ragged geometry (``st.geometry``, uneven) the weights carry
    the padded width ``tp · max(geometry) · block``: rank r keeps
    ``keep_blocks_for_bucket(γ, geometry[r])`` of its real blocks (one
    keep table per size class), so only the largest ranks ever take the
    dense shortcut.
    """
    if ctx is None or scope not in ctx.pri:
        return _dense_pair(x, w_up, w_down, w_gate, act_fn)
    ctx.check_supported()
    st, g = ctx.static, ctx.group
    blk = st.block_for(scope)
    sheds = st.mig_sheds
    srcs = ctx.srcs
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    nb = (w_up.shape[1] // g.e) // blk
    if sheds and max(sheds) >= nb:
        raise ValueError(
            f"mig_shed {sheds} must leave each source at least one of "
            f"its {nb} local blocks")
    # an all-equal geometry is the plain equal split: normalized away so
    # it runs the geometry-free path exactly
    geo = st.geometry if len(set(st.geometry)) > 1 else ()
    if geo:
        if len(geo) != g.e:
            raise ValueError(
                f"geometry {geo} has {len(geo)} ranks, tp_size={g.e}")
        if max(geo) != nb:
            raise ValueError(
                f"geometry {geo}: max size {max(geo)} must equal the "
                f"padded local block count {nb} "
                f"(Hloc={w_up.shape[1] // g.e}, blk={blk})")
        if sheds and max(sheds) >= min(geo):
            raise ValueError(
                f"mig_shed {sheds} must leave the smallest-geometry "
                f"rank (L={min(geo)}) at least one real block")
    # each rank's keep count per bucket, quantized against its size class
    # (its real block count under a geometry, the local count otherwise)
    size_of = list(geo) if geo else [nb] * g.e
    kc_rows = {L: [keep_blocks_for_bucket(gm, L) for gm in st.buckets]
               for L in set(size_of)}
    kcs = [kc_rows[size_of[r]] for r in range(g.e)]

    def shards(r):
        return (g.cols(w_up, r), g.rows(w_down, r),
                None if w_gate is None else g.cols(w_gate, r))

    # ---- per-rank local compute: the (bucket × source slot) branch ----
    partials = []
    for r in range(g.e):
        wu, wd, wg = shards(r)
        kc = kcs[r][ctx.buckets[r]]
        if r in srcs:
            kc -= sheds[srcs.index(r)]
        kc = max(1, min(kc, nb))
        if kc >= nb:
            # dense shortcut: keeping every block, the gather is an
            # identity copy — skip it (γ = 0 runs the true dense pair)
            partials.append(_dense_pair(x2, wu, wd, wg, act_fn))
        else:
            partials.append(resizing.resized_ffn(
                x2, wu, wd, ctx.keep(scope, kc, r), act_fn, wg, block=blk,
                use_kernel=ctx.use_kernel))

    # ---- migration: slot source s exports the m_s blocks right after
    # its (clamped) locally-kept prefix; every slot shares one fused
    # broadcast and the helpers fold their partials into the psum
    if sheds:
        def exports(r, s):
            m_s = sheds[s]
            kc_self = kcs[r][ctx.buckets[r]]
            # start from the CLAMPED keep count max(kc − m_s, 1): the
            # local branch never keeps fewer than 1 block, so the
            # migrated window must start after it to stay disjoint
            start = min(max(max(kc_self - m_s, 1), 0), nb - m_s)
            # and within the list, as the reference's dynamic slice
            # clamps it: a layer wider than its scope's list (DeepSeek-V2's
            # dense first layer beside the shared experts) exports the
            # list's last m_s ids
            pri = ctx.pri_list(scope, r)
            start = max(0, min(start, pri.shape[-1] - m_s))
            mig_ids = pri[start:start + m_s]
            wu, wd, wg = shards(r)
            return (resizing.gather_cols(wu, mig_ids, blk),
                    resizing.gather_rows(wd, mig_ids, blk),
                    None if wg is None else
                    resizing.gather_cols(wg, mig_ids, blk))

        bufs = fused_migration_broadcast(g, srcs, sheds, blk, exports)
        for r in range(g.e):
            delta = fused_migration_delta(x2, e=g.e, rank=r, srcs=srcs,
                                          sheds=sheds, block=blk,
                                          act_fn=act_fn, bufs=bufs)
            if delta is not None:
                partials[r] = partials[r] + delta

    y = g.chunked_psum(partials, ctx.psum_chunks)
    return y.reshape(*lead, w_down.shape[1])
