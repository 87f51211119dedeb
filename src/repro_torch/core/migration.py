"""Lightweight workload migration (paper Sec. IV-A), port of
``repro.core.migration`` for the TP group emulated in one process.

Unit of migration: intermediate-dimension blocks of a TP-split linear
pair (the FFN's d_ff). A straggler sheds ``m`` blocks of its local shard;
every helper receives the straggler's weight slices for those blocks
("broadcast"), computes a deterministic sub-range, and adds the result
into its own partial output before the layer's all-reduce — the
migration ``reduce`` is merged into the collective the layer already
has (reduce-merging).

Concurrent multi-straggler migration: S source ranks shed at once. The
helpers are the ranks outside the source set, renumbered by their
position among helpers (hidx), and slot s's export is partitioned as

    j_s(r) = (hidx(r) + H - (r_s mod H)) mod H,   H = e - S,

which for S = 1 is the paper's renumbering r' = (r + e - r_s) mod e.

In the reference the source ranks arrive as a device vector and every
index here is traced. In the port the plan's ``mig_src`` is host-side:
the renumbering and each slot's offsets are Python integers, so a layer
picks its slices without a device sync. The helpers' products are plain
``torch.matmul``, as the reference's are ``jnp`` products outside
Pallas. The broadcast is the group's one grouped masked psum over every
slot (:meth:`repro_torch.parallel.TPGroup.bcast_grouped`); gradients of
the broadcast slices flow back to each source's own shard through it, so
migration stays lossless forward and backward.

The reference's ``migrated_pair_matmul`` / ``scatter_gather_pair_matmul``
(its migration-policy benchmark) are not ported here.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.parallel import TPGroup

Export = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def multi_migration_assignment(rank: int, srcs: Sequence[int], e: int,
                               sheds: Sequence[int]):
    """Deterministic helper partition for S concurrent sources.

    ``srcs`` are the S source ranks (-1 = slot idle) and ``sheds`` the
    matching shed block counts. Only the first H = e - S helpers work
    (the surplus, when slots are idle, stays free). For slot s, helper
    j = (hidx + H - (src_s mod H)) mod H computes blocks
    [j*m_per_s, (j+1)*m_per_s) of that slot's padded export, where
    m_per_s = ceil(shed_s / H).

    Returns ``(los, m_pers, helps)``: per slot, this rank's block offset
    into the slot's padded export, the per-helper block count, and
    whether this rank helps that slot (false for sources, idle slots and
    surplus helpers). All host values.
    """
    srcs = [int(s) for s in srcs]
    S = len(srcs)
    H = max(e - S, 1)
    is_src = [r in srcs for r in range(e)]
    # position among the helpers: #{r'' <= rank not a source} - 1
    hidx = sum(1 for r in range(rank + 1) if not is_src[r]) - 1
    can_help = (not is_src[rank]) and hidx < H
    los, m_pers, helps = [], [], []
    for s, m_s in enumerate(sheds):
        m_per = -(-int(m_s) // H)
        j = (hidx + H - (srcs[s] % H)) % H
        los.append(j * m_per)
        m_pers.append(m_per)
        helps.append(can_help and srcs[s] >= 0)
    return los, tuple(m_pers), helps


def fused_migration_broadcast(group: TPGroup, srcs: Sequence[int],
                              sheds: Sequence[int], block: int,
                              exports: Callable[[int, int], Export]):
    """The ONE fused masked-psum broadcast of every slot's export.

    ``exports(rank, s)`` gathers slot s's ``(exp_in [d, m_s*B],
    exp_out [m_s*B, n], exp_gate | None)`` from ``rank``'s own shard;
    only the slot source's survives the masked psum, so only it is
    computed. Each slot's export is zero-padded to m_per*H blocks and the
    slots are concatenated. Returns ``(b_in, b_out, b_gate | None)``,
    which every rank holds after the collective.
    """
    H = max(group.e - len(sheds), 1)
    c_in, c_out, c_gate = [], [], []
    slots = group.bcast_grouped([int(srcs[s]) for s in range(len(sheds))],
                                exports)
    for (exp_in, exp_out, exp_gate), m_s in zip(slots, sheds):
        pad = (-(-int(m_s) // H)) * H - int(m_s)
        if pad:
            exp_in = torch.nn.functional.pad(exp_in, (0, pad * block))
            exp_out = torch.nn.functional.pad(exp_out, (0, 0, 0, pad * block))
            if exp_gate is not None:
                exp_gate = torch.nn.functional.pad(exp_gate,
                                                   (0, pad * block))
        c_in.append(exp_in)
        c_out.append(exp_out)
        if exp_gate is not None:
            c_gate.append(exp_gate)
    return (torch.cat(c_in, dim=1), torch.cat(c_out, dim=0),
            torch.cat(c_gate, dim=1) if c_gate else None)


def fused_migration_delta(x: torch.Tensor, *, e: int, rank: int,
                          srcs: Sequence[int], sheds: Sequence[int],
                          block: int, act_fn, bufs) -> Optional[torch.Tensor]:
    """This rank's migrated partial [T, n] from the broadcast ``bufs``
    (:func:`fused_migration_broadcast`), to be reduce-merged into its
    partial output ahead of the layer's all-reduce.

    The helper slices its partition of every slot, runs one fused pair
    over all of them, and masks the padded block lanes, idle slots and
    the slots it does not help. A rank that helps no slot gets ``None``:
    its delta is exactly zero, forward and backward, so it is skipped.
    """
    los, m_pers, helps = multi_migration_assignment(rank, srcs, e, sheds)
    if not any(helps):
        return None
    H = max(e - len(sheds), 1)
    b_in, b_out, b_gate = bufs
    sl_in, sl_out, sl_gate, gates = [], [], [], []
    off = 0
    for s, m_s in enumerate(sheds):
        m_per = m_pers[s]
        lo = (off + los[s]) * block
        w = m_per * block
        sl_in.append(b_in[:, lo:lo + w])
        sl_out.append(b_out[lo:lo + w])
        if b_gate is not None:
            sl_gate.append(b_gate[:, lo:lo + w])
        lane = torch.arange(w, device=x.device) + los[s] * block
        gates.append((lane < int(m_s) * block).to(x.dtype)
                     * float(helps[s]))
        off += m_per * H
    cat_in = torch.cat(sl_in, dim=1)
    cat_out = torch.cat(sl_out, dim=0)
    gate_mask = torch.cat(gates)
    h_mig = x @ cat_in
    if b_gate is not None:
        h_mig = act_fn(x @ torch.cat(sl_gate, dim=1)) * h_mig
    else:
        h_mig = act_fn(h_mig)
    return (h_mig * gate_mask[None, :]) @ cat_out

