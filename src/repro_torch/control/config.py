"""Shared control-plane configuration (train + serve).

Historically the trainer hand-built a :class:`WorkloadControlConfig` from
its CLI flags while the serve engine kept its own ``ServeControlConfig``
with overlapping-but-renamed knobs. :class:`ControlConfig` collapses the
two: one dataclass carries every knob a driver needs — technique mode,
heterogeneity simulation, telemetry source, and the static ragged shard
geometry — and :meth:`ControlConfig.to_workload` derives the low-level
:class:`WorkloadControlConfig` the plan-assembly layer consumes.

``repro.launch.serve.ServeControlConfig`` remains as a deprecated alias
(it subclasses this and warns on construction).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.config import WorkloadControlConfig

_MODES = ("off", "zero", "mig", "semi")


@dataclasses.dataclass
class ControlConfig:
    """Workload control + straggler-simulation knobs for a driver loop.

    mode "off" runs dense; "zero"/"mig"/"semi" run the controller on
    modeled (or measured — ``times``) per-rank times each control step.
    "semi" emits the paper's full mitigation space: Eq.(3) selects the
    straggler prefix that migrates losslessly (``max_sources`` concurrent
    slots) and the rest ZERO-resizes. ``sim_ranks`` sizes the simulated
    TP group for the latency model (0 = the real ``tp``); when it differs
    the plan is projected (repro.control.projection). ``geometry`` is a
    per-rank FFN block-count tuple (core/geometry.py): static uneven
    sharding the dynamic controller then plans *residually* against.
    """

    mode: str = "off"                  # off | zero | mig | semi
    hetero_kind: str = "none"    # none | static | round_robin | contention | trace
    chi: float = 4.0
    contention_p: float = 0.15
    period: int = 10
    sim_ranks: int = 0                 # 0 => real tp
    block_size: int = 8
    max_sources: int = 3               # migration slots (mig/semi modes)
    shed_cap: int = 0                  # per-source shed-block cap (0 = uncapped)
    beta_policy: str = "lossless"      # lossless | eq2 (semi mission split)
    imputation: str = "zero"           # zero | average | same
    selection: str = "priority"        # random | priority | priority_diff
    straggler_threshold: float = 0.12
    use_kernel: bool = False
    # decode raw-speed knobs — the ONE shared plumbing for the
    # fused decode-attention path (examples + benches + CLI select it
    # here, never via env sniffing). fused_attention works in every mode
    # including "off"; psum_chunks > 1 chunk-splits the controlled-layer
    # epilogue all-reduce; model_decode_overheads prices the decode
    # attention memory term + collective exposure into the engine's
    # latency model (off by default: the classic legs stay bit-stable).
    fused_attention: bool = False
    psum_chunks: int = 1
    model_decode_overheads: bool = False
    seed: int = 0
    peak_flops: float = 5e9            # latency-model calibration (host CPU)
    mfu: float = 1.0
    # telemetry (DESIGN_TELEMETRY.md): controller input source, trace
    # replay (hetero_kind="trace") and replayable trace capture
    times: str = "modeled"             # modeled | measured
    trace_in: Optional[str] = None
    # replay a SLICE of a wider recorded trace: χ lanes [offset,
    # offset + sim_ranks). How one cluster trace feeds R replicas —
    # replica i runs offset = i * ranks_per_replica (repro.cluster).
    trace_rank_offset: int = 0
    trace_out: Optional[str] = None
    measure_noise: float = 0.0
    measure_interval: int = 1
    # static ragged shard geometry: per-rank FFN block counts (None/equal
    # = classic equal split). See core/geometry.py and DESIGN_SHARDING.md.
    geometry: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode {self.mode!r} is not one of {_MODES}")
        if self.psum_chunks < 1:
            raise ValueError(
                f"psum_chunks must be >= 1, got {self.psum_chunks}")
        if self.geometry is not None:
            self.geometry = tuple(int(s) for s in self.geometry)
            if any(s < 1 for s in self.geometry):
                raise ValueError(
                    f"geometry {self.geometry} needs >= 1 block per rank")

    def to_workload(self, *, enabled: Optional[bool] = None,
                    migration_sources: Optional[int] = None,
                    ) -> WorkloadControlConfig:
        """Derive the plan-assembly-layer :class:`WorkloadControlConfig`.

        ``enabled`` defaults to ``mode != "off"``; ``migration_sources``
        defaults to ``max_sources`` in the migration-capable modes and 0
        otherwise. Drivers with legacy CLI contracts (the trainer's
        ``--mig-blocks 0 disables migration``) pass explicit overrides.
        """
        if enabled is None:
            enabled = self.mode != "off"
        if migration_sources is None:
            migration_sources = (self.max_sources
                                 if self.mode in ("mig", "semi") else 0)
        return WorkloadControlConfig(
            enabled=enabled,
            mode=self.mode if self.mode != "off" else "zero",
            imputation=self.imputation, selection=self.selection,
            block_size=self.block_size,
            max_migration_sources=migration_sources,
            migration_shed_cap=self.shed_cap,
            beta_policy=self.beta_policy,
            straggler_threshold=self.straggler_threshold,
            use_kernel=self.use_kernel,
            fused_attention=self.fused_attention,
            psum_chunks=self.psum_chunks,
            times=self.times,
            measure_interval=self.measure_interval)
