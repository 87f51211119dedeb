"""Sim-scale → real-mesh plan projection (control plane, part 2).

The latency model can simulate a TP group larger than the real host mesh
(``sim_ranks`` > ``tp`` — the paper's V-A setup, where heterogeneity is a
simulation layered over homogeneous hardware). The controller then plans
at sim scale, but the compiled step executes on the real mesh, so the plan
must be projected:

* **resize buckets** keep the previous critical-path semantics: a
  bulk-synchronous group runs at the pace of its slowest rank, so every
  real rank executes the straggler's γ-bucket branch (the modeled latency
  is computed at sim scale regardless — the real program only determines
  *output values*).
* **migration slots** — previously dropped entirely ("migration needs
  sim == real") — now FOLD onto the real mesh: real rank ``s % tp`` stands
  in for sim source ``s``. Folded sources must be distinct (a real rank
  executes one source slot; collisions keep the heaviest shed, canonical
  order) and at least one real helper must remain. Shed counts are clamped
  to the real shard so each folded source keeps >= 1 local block.

Because migration is lossless for ANY source assignment (the helpers
compute exactly the shed blocks from broadcast weights and reduce-merge),
a pure-migration sim plan projects to a pure-migration real plan with
identical outputs — which is what makes serve-time SEMI token-exact even
when the simulated group is larger than the host mesh.

With ``sim_ranks == tp`` the projection is the identity.

Ragged shard geometry (core/geometry.py) composes with the identity
projection only — the control plane enforces ``sim_ranks == tp`` when a
geometry is set. The caller then passes ``real_nb = min(geometry)``: any
rank can be retargeted as a migration source dynamically, so the clamp
must leave the SMALLEST rank a real block. Lossless-ness is unchanged —
helpers compute exactly the shed blocks from broadcast weights, and under
a geometry those are the source's real (non-padding) blocks because every
keep count and shed is quantized against the source's own block count.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.workload import WorkloadPlan


@dataclasses.dataclass(frozen=True)
class ProjectedPlan:
    """A plan's execution arrays mapped onto the real mesh."""

    bucket_by_rank: np.ndarray        # [tp] int32
    mig_srcs: Tuple[int, ...]         # real source ranks, aligned with sheds
    mig_sheds: Tuple[int, ...]        # per-source shed counts (static)
    folded: bool                      # True when sim_ranks != tp

    @property
    def migrating(self) -> bool:
        return bool(self.mig_sheds)


def project_plan(plan: WorkloadPlan, *, sim_ranks: int, tp: int,
                 real_nb: int = 0) -> ProjectedPlan:
    """Project a (possibly sim-scale) plan onto the real ``tp``-rank mesh.

    ``real_nb`` is the real per-rank block count of the migration scope
    (ffn); sheds are clamped to ``real_nb - 1`` so a source always keeps a
    local block. 0 skips the clamp (caller guarantees fit)."""
    sheds_in = plan.static.mig_sheds
    srcs_in = (plan.dynamic.mig_srcs(len(sheds_in)) if sheds_in
               else np.zeros((0,), np.int32))

    if sim_ranks == tp:
        srcs, sheds = [], []
        for s, m in zip(srcs_in, sheds_in):
            m = _clamp_shed(int(m), real_nb)
            if m > 0:
                srcs.append(int(s))
                sheds.append(m)
        return ProjectedPlan(
            bucket_by_rank=np.asarray(plan.dynamic.bucket_by_rank,
                                      np.int32).copy(),
            mig_srcs=tuple(srcs), mig_sheds=tuple(sheds), folded=False)

    # -- folded: real rank r stands in for sim ranks {r, r+tp, ...} -------
    # critical-path buckets: the slowest sim rank's branch everywhere
    buckets = np.asarray(plan.dynamic.bucket_by_rank, np.int32)
    bucket_real = np.full((tp,), int(buckets.max()) if buckets.size else 0,
                          np.int32)

    srcs, sheds = [], []
    if tp > 1:
        taken = set()
        for s, m in zip(srcs_in, sheds_in):     # canonical shed-desc order
            if int(s) < 0:
                continue
            r = int(s) % tp
            if r in taken:
                continue                         # collision: heaviest wins
            m = _clamp_shed(int(m), real_nb)
            if m <= 0:
                continue
            taken.add(r)
            srcs.append(r)
            sheds.append(m)
            if len(taken) >= tp - 1:             # keep >= 1 real helper
                break
    return ProjectedPlan(bucket_by_rank=bucket_real, mig_srcs=tuple(srcs),
                         mig_sheds=tuple(sheds), folded=True)


def _clamp_shed(m: int, real_nb: int) -> int:
    """Clamp a shed count so the source keeps >= 1 real local block."""
    if real_nb > 0:
        return min(m, real_nb - 1)
    return m
