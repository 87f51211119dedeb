"""Workload-plan datatypes shared by the controller and the TP layers.

The paper's controller runs per-iteration on the host (Alg. 1/2) and emits
a plan. To stay SPMD-compilable on TPU we split the plan into:

* **static** parts (hashable; changing them recompiles): the γ-bucket set,
  pruning block size, the per-source migration shed counts. Buckets
  quantize the paper's continuous γ (DESIGN.md §7.2) — Eq.(1)'s γ is
  rounded *up* so waiting cost stays fully offset. Migration shed counts
  are quantized onto the same grid (:func:`quantize_shed`) so the set of
  distinct static plans — and hence compiled executables — stays small.
* **dynamic** parts (device arrays; changing them does NOT recompile):
  per-rank bucket assignment, per-layer priority permutations, the
  straggler rank ids for migration (one per shed slot, −1 = slot idle).

Multi-straggler plans multiply the number of distinct static shapes, so
:class:`PlanCompileCache` keys built executables on the canonical plan
signature: replanning mid-training reuses compiled code instead of
triggering a recompilation storm (each bucketed signature compiles at
most once — asserted by the property tests via ``compile_count``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


DEFAULT_BUCKETS: Tuple[float, ...] = (0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)


def keep_blocks_for_bucket(gamma: float, num_blocks: int) -> int:
    """Blocks KEPT for a pruning ratio γ; never below 1 block."""
    return max(1, num_blocks - int(round(gamma * num_blocks)))


def bucket_for_gamma(gamma: float, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket with γ_bucket >= γ (round UP: offset the full gap)."""
    for i, b in enumerate(buckets):
        if b >= gamma - 1e-9:
            return i
    return len(buckets) - 1


def shed_bucket_counts(num_blocks: int,
                       buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                       ) -> Tuple[int, ...]:
    """Allowed per-source migration shed counts: the γ-bucket grid projected
    onto whole blocks (0 dropped; capped so the source keeps >= 1 block)."""
    cap = max(num_blocks - 1, 1)
    counts = {min(int(round(g * num_blocks)), cap) for g in buckets}
    return tuple(sorted(c for c in counts if c > 0))


def quantize_shed(m: int, num_blocks: int,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> int:
    """Round a requested shed count UP onto the bucket grid.

    Rounding up mirrors :func:`bucket_for_gamma`: the straggler sheds at
    least as much as Eq.(1) asked for, so the waiting gap stays fully
    offset; the helpers absorb the (small) quantization surplus."""
    if m <= 0:
        return 0
    for c in shed_bucket_counts(num_blocks, buckets):
        if c >= m:
            return c
    grid = shed_bucket_counts(num_blocks, buckets)
    return grid[-1] if grid else 0


def adapt_block_size(contraction_dim: int, preferred: int = 128) -> int:
    """Largest TPU-friendly block size dividing the contraction dim.

    128 aligns with the MXU; fall back through 64/32. Returns 0 if even 32
    does not divide (that linear is exempt from resizing — recorded)."""
    for b in (preferred, 128, 64, 32):
        if b <= contraction_dim and contraction_dim % b == 0:
            return b
    return 0


@dataclasses.dataclass(frozen=True)
class PlanStatic:
    """Hashable plan skeleton; part of the jit static args."""

    buckets: Tuple[float, ...] = DEFAULT_BUCKETS
    block_size: int = 128
    mig_blocks: int = 0          # legacy single-source shed count (0 = off)
    tp_size: int = 1
    imputation: str = "zero"
    per_layer: bool = False      # per-layer γ (PriDiff, Sec. III-B)
    num_layers: int = 0          # required when per_layer
    # per-scope block-size overrides ("qkv"/"attn_out"/"ffn"), hashable
    scope_blocks: Tuple[Tuple[str, int], ...] = ()
    # per-source shed counts for CONCURRENT multi-straggler migration; one
    # entry per source slot, canonical order is descending. Supersedes
    # mig_blocks when non-empty.
    mig_shed: Tuple[int, ...] = ()
    # static ragged shard geometry: per-rank FFN block counts (sum = the
    # model's canonical block total; see core/geometry.py). Empty = the
    # implicit equal split. An all-equal tuple is normalized away by
    # :meth:`canonical` so equal-geometry plans hash/compile identically
    # to geometry-free ones.
    geometry: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.geometry:
            if len(self.geometry) != self.tp_size:
                raise ValueError(
                    f"geometry {self.geometry} has {len(self.geometry)} "
                    f"entries but tp_size={self.tp_size}")
            if any(s < 1 for s in self.geometry):
                raise ValueError(
                    f"geometry {self.geometry} entries must be >= 1")

    @property
    def mig_sheds(self) -> Tuple[int, ...]:
        """Per-source shed counts, unifying the legacy scalar field.

        Zero/negative entries are rejected rather than filtered: silently
        dropping a slot would shift the positional alignment with the
        dynamic ``mig_src`` vector and mispair sources with sheds. Idle
        slots are expressed dynamically (mig_src[slot] = -1)."""
        if self.mig_shed:
            if any(m <= 0 for m in self.mig_shed):
                raise ValueError(
                    f"mig_shed {self.mig_shed} entries must be positive; "
                    "mark idle slots with mig_src[slot] = -1 instead")
            return self.mig_shed
        return (self.mig_blocks,) if self.mig_blocks > 0 else ()

    @property
    def num_sources(self) -> int:
        return len(self.mig_sheds)

    @property
    def migration_enabled(self) -> bool:
        return sum(self.mig_sheds) > 0 and self.tp_size > 1

    def block_for(self, scope: str) -> int:
        for name, b in self.scope_blocks:
            if name == scope:
                return b
        return self.block_size

    def canonical(self) -> "PlanStatic":
        """Normal form used as the compile-cache key: the shed counts live
        in ``mig_shed`` sorted descending, ``mig_blocks`` is folded in,
        and an all-equal geometry (zero padding — byte-identical layout to
        the implicit split) drops to (), so equivalent plans hash
        identically."""
        sheds = tuple(sorted(self.mig_sheds, reverse=True))
        geo = self.geometry if len(set(self.geometry)) > 1 else ()
        if sheds == self.mig_shed and self.mig_blocks == 0 \
                and geo == self.geometry:
            return self
        return dataclasses.replace(self, mig_shed=sheds, mig_blocks=0,
                                   geometry=geo)

    def signature(self) -> "PlanStatic":
        """Alias of :meth:`canonical` — the hashable plan signature."""
        return self.canonical()

    def signature_str(self) -> str:
        """Compact string form of the canonical signature, used by the
        telemetry traces (StepSample.plan_signature) and run histories.
        Stable across processes — unlike hash() — so trace files can be
        diffed and compared between runs."""
        c = self.canonical()
        shed = ",".join(str(m) for m in c.mig_shed)
        sig = f"tp{c.tp_size}b{c.block_size}shed[{shed}]"
        if c.geometry:
            sig += "geo[" + ",".join(str(s) for s in c.geometry) + "]"
        return sig


@dataclasses.dataclass
class PlanDynamic:
    """Device-array plan inputs (donated into the jitted step)."""

    bucket_by_rank: np.ndarray            # [tp] int32 index into buckets
    # migration source rank(s): scalar int32 (legacy single-source) or
    # [S] int32 aligned with PlanStatic.mig_sheds; -1 = slot idle
    mig_src: np.ndarray
    # per-layer-scope priority permutations keyed by scope name;
    # each is int32 [num_blocks] in KEEP-FIRST order (head = most important)
    pri_lists: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def mig_srcs(self, num_slots: int) -> np.ndarray:
        """Normalize ``mig_src`` to a padded [num_slots] int32 vector."""
        n = max(num_slots, 1)
        a = np.atleast_1d(np.asarray(self.mig_src, np.int32))
        out = np.full((n,), -1, np.int32)
        k = min(a.shape[0], n)
        out[:k] = a[:k]
        return out

    @staticmethod
    def neutral(tp: int) -> "PlanDynamic":
        return PlanDynamic(
            bucket_by_rank=np.zeros((tp,), np.int32),
            mig_src=np.array(-1, np.int32),
            pri_lists={},
        )


@dataclasses.dataclass
class WorkloadPlan:
    static: PlanStatic
    dynamic: PlanDynamic

    @staticmethod
    def neutral(tp: int = 1, **kw) -> "WorkloadPlan":
        return WorkloadPlan(PlanStatic(tp_size=tp, **kw), PlanDynamic.neutral(tp))

    def is_neutral(self) -> bool:
        return (not self.static.migration_enabled
                and int(np.max(self.dynamic.bucket_by_rank)) == 0)


# ---------------------------------------------------------------------------
# Plan-signature compile cache
# ---------------------------------------------------------------------------


class PlanCompileCache:
    """Signature-keyed cache of built (jitted) executables.

    The controller replans every iteration; with multi-straggler migration
    the *static* part of the plan (per-source shed counts) changes too.
    Shed counts are quantized onto the bucket grid, so the set of distinct
    signatures is small — this cache makes each of them build/compile at
    most once and replanning hit compiled code thereafter.

    ``builder(static_or_none)`` is called once per new signature (``None``
    is the key for the control-disabled step). ``compile_count`` /
    ``hit_count`` expose the compile hook the property tests assert on;
    ``on_compile`` (if set) is invoked with each new signature.
    """

    def __init__(self, builder: Callable[[Optional[PlanStatic]], Any]):
        self._builder = builder
        self._entries: Dict[Optional[PlanStatic], Any] = {}
        self.compile_count = 0
        self.hit_count = 0
        self.on_compile: Optional[Callable[[Optional[PlanStatic]], None]] = None

    @staticmethod
    def key_for(static: Optional[PlanStatic]) -> Optional[PlanStatic]:
        return static.canonical() if static is not None else None

    def get(self, static: Optional[PlanStatic]):
        key = self.key_for(static)
        entry = self._entries.get(key)
        if entry is None and key not in self._entries:
            self.compile_count += 1
            if self.on_compile is not None:
                self.on_compile(key)
            entry = self._builder(key)
            self._entries[key] = entry
        else:
            self.hit_count += 1
        return entry

    def __len__(self) -> int:
        return len(self._entries)

    def signatures(self):
        return list(self._entries)
