"""Heterogeneity model & straggler simulation (paper Sec. V-A).

The paper simulates heterogeneity on homogeneous V100s by injecting sleeps
into the matmul path of chosen ranks, quantified by the straggling
skewness χ (matmul is χ× slower). We do the analogous thing for a TPU/CPU
SPMD runtime: a ``HeteroSchedule`` yields per-rank speed multipliers
χ_i(t) ≥ 1, and an ``IterationModel`` converts a workload plan + χ into
per-rank iteration times

    T_i = M·(workload share_i)·χ_i + C        (matmul time + comm/other)

which is what the controller consumes (the controller never sees χ
directly — only measured-style times, as in the paper).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class HeteroSchedule:
    """χ_i(step) generator."""

    num_ranks: int
    kind: str = "none"       # none | static | round_robin | contention | trace
    chis: Sequence[float] = ()         # static per-rank χ, or χ values to rotate
    period: int = 100                  # steps between round-robin moves
    contention_p: float = 0.15         # P(rank is contended at a step)
    contention_chi: float = 4.0
    seed: int = 0
    # kind="trace": per-step χ rows replayed from a recorded telemetry
    # trace (telemetry.trace.schedule_from_trace); wraps past the end
    trace_chis: "tuple[tuple[float, ...], ...]" = ()

    def chi(self, step: int) -> np.ndarray:
        x = np.ones((self.num_ranks,), np.float64)
        if self.kind == "none":
            return x
        if self.kind == "static":
            c = np.asarray(self.chis, np.float64)
            x[: len(c)] = c
            return x
        if self.kind == "round_robin":
            # one straggler at a time, rotating across ranks (paper Sec. V-B)
            chi = self.chis[0] if self.chis else 2.0
            x[(step // self.period) % self.num_ranks] = chi
            return x
        if self.kind == "contention":
            # per-step stream derived from the (seed, step) PAIR: a plain
            # seed+step sum aliases across schedules (seed=0/step=5 would
            # replay seed=5/step=0 exactly — pinned by tests/test_telemetry)
            rng = np.random.default_rng(np.random.SeedSequence(
                (int(self.seed), int(step))))
            hit = rng.random(self.num_ranks) < self.contention_p
            x[hit] = self.contention_chi
            return x
        if self.kind == "trace":
            if not self.trace_chis:
                raise ValueError(
                    "kind='trace' needs trace_chis — build the schedule "
                    "via repro.telemetry.trace.schedule_from_trace")
            row = np.asarray(self.trace_chis[step % len(self.trace_chis)],
                             np.float64)
            n = min(len(row), self.num_ranks)
            x[:n] = row[:n]
            return x
        raise ValueError(f"unknown hetero kind {self.kind!r}")


@dataclasses.dataclass
class IterationModel:
    """Per-rank iteration-time model for one training step.

    matmul_time: seconds of TP matmul work at χ=1 with the FULL workload
      (the paper's M_i^j); scaled by each rank's retained workload fraction.
    other_time: everything not tunable by the technique (comm, layernorm,
      optimizer, ...), assumed χ-insensitive (collectives are ICI-bound).
    """

    matmul_time: float
    other_time: float

    def times(self, chi: np.ndarray, work_frac: np.ndarray) -> np.ndarray:
        """T_i for each rank given χ_i and retained-work fraction_i."""
        return self.matmul_time * work_frac * chi + self.other_time

    def step_time(self, chi: np.ndarray, work_frac: np.ndarray) -> float:
        """Bulk-synchronous: the step takes as long as the slowest rank."""
        return float(self.times(chi, work_frac).max())


def matmul_flops_per_rank(model_cfg, shape_cfg, tp: int) -> float:
    """FLOPs of TP-matmul work per rank per iteration (fwd+bwd ≈ 3× fwd).

    Counts the linear projections/transformations (the paper's target
    workload): attention QKV/out + FFN, per token. MoE counts active
    experts. The recurrence/softmax parts are excluded (not prunable).
    """
    c = model_cfg
    d = c.d_model
    tokens = shape_cfg.global_batch * shape_cfg.seq_len
    hd = c.resolved_head_dim
    if c.family == "ssm":
        s = c.ssm
        d_in = s.expand * d
        per_tok = 2 * d * 2 * d_in + 2 * d_in * d     # in/out projections
    else:
        attn = 2 * d * (c.num_heads * hd) + 2 * 2 * d * (c.num_kv_heads * hd) \
            + 2 * (c.num_heads * hd) * d
        if c.moe is not None:
            ff_mult = 3 if c.act == "silu" else 2
            ff = ff_mult * 2 * d * c.moe.d_expert * (c.moe.top_k + c.moe.num_shared_experts)
        else:
            ff_mult = 3 if c.act in ("silu", "gelu_glu") else 2
            ff = ff_mult * 2 * d * c.d_ff
        per_tok = attn + ff
    fwd = tokens * per_tok * c.num_layers
    return 3.0 * fwd / tp           # fwd + 2x bwd, split over TP ranks


def iteration_model(model_cfg, shape_cfg, tp: int,
                    peak_flops: float = 197e12,
                    mfu: float = 0.4,
                    comm_frac: float = 0.15) -> IterationModel:
    """Build an IterationModel from the analytic workload (paper Sec. II-B)."""
    f = matmul_flops_per_rank(model_cfg, shape_cfg, tp)
    t_mm = f / (peak_flops * mfu)
    return IterationModel(matmul_time=t_mm, other_time=comm_frac * t_mm)


# ---------------------------------------------------------------------------
# decode-step overhead model: the terms the IterationModel
# deliberately excludes — decode attention's cache-read bandwidth and the
# exposed TP all-reduce — priced per step from the ACTUAL slot occupancy.
# ---------------------------------------------------------------------------

# HBM bandwidth per peak FLOP (TPU v5e: 819 GB/s against 197 TFLOP/s).
# The serve engine's latency model is calibrated in arbitrary peak_flops
# units (5e9 on the host simulator); keeping the bytes/FLOP ratio at the
# hardware's value keeps the RELATIVE weight of memory-bound attention
# vs compute-bound matmul realistic — decode at small batch is
# attention-read dominated, which is exactly what the fused kernel and
# the roofline correction (benchmarks/roofline.py) are about.
HBM_BYTES_PER_FLOP = 819e9 / 197e12


@dataclasses.dataclass
class DecodeOverheadModel:
    """Per-step decode overheads from actual per-slot cache occupancy.

    * attention memory term: the UNFUSED path reads every ``max_len``
      cache row of every slot each step plus a full score-matrix HBM
      round-trip; the FUSED kernel reads only the occupied 128-row tiles
      (``pl.when`` skip) and keeps scores in VMEM.
    * collective exposure: the IterationModel's ``other_time`` charges
      one fat synchronous all-reduce; with ``psum_chunks`` k > 1 only
      ~1/k of it stays exposed (the first chunk), the rest overlaps
      with compute under the latency-hiding scheduler.

    ``overhead_s`` returns the DELTA against the plain IterationModel
    step (which already includes ``comm_time``), so it can be added to
    ``IterationModel.step_time`` without double counting.
    """

    kv_bytes_per_pos: float     # cache bytes read per occupied row (all layers)
    score_bytes_per_pos: float  # unfused score round-trip per row (all layers)
    num_slots: int
    max_len: int
    tile: int                   # fused kernel touches whole tiles
    hbm_bw: float               # bytes/s at the calibrated scale
    comm_time: float            # modeled exposed all-reduce time (1 chunk), s

    def attn_s(self, cur_pos, fused: bool, active=None) -> float:
        """``active``: optional [num_slots] mask of OCCUPIED slots. An
        empty slot holds pos=0 in the engine's per-step vector; without
        the mask it is billed as one occupied cache row (tile), which
        inflated the occupancy roofline serve_bench gates on. The
        unfused path ignores it: that path physically
        reads every ``max_len`` row of every slot regardless."""
        cur = np.asarray(cur_pos, np.float64)
        if fused:
            # a tile can't be wider than the cache itself (a short
            # max_len is covered by a single tile), and a slot never
            # reads more rows than it has
            ts = min(self.tile, self.max_len)
            per_slot = np.minimum(np.ceil((cur + 1.0) / ts) * ts,
                                  self.max_len)
            if active is not None:
                per_slot = per_slot * np.asarray(active, np.float64)
            return float(per_slot.sum()) * self.kv_bytes_per_pos / self.hbm_bw
        rows = float(self.num_slots * self.max_len)
        return rows * (self.kv_bytes_per_pos
                       + self.score_bytes_per_pos) / self.hbm_bw

    def comm_exposed_s(self, psum_chunks: int) -> float:
        return self.comm_time / max(int(psum_chunks), 1)

    def overhead_s(self, cur_pos, *, fused: bool, psum_chunks: int,
                   active=None) -> float:
        # the chunking credit (comm_time - exposed) can only hide the
        # all-reduce behind the attention-read phase that actually
        # exists this step: clamp at zero so modeled latency never
        # drops below the compute-only IterationModel floor (tiny
        # occupancy + large psum_chunks would go negative)
        return max(0.0, self.attn_s(cur_pos, fused, active=active)
                   - (self.comm_time - self.comm_exposed_s(psum_chunks)))


def decode_overhead_model(model_cfg, num_slots: int, max_len: int,
                          it_model: IterationModel, *,
                          peak_flops: float, bytes_per_el: int = 4,
                          tile: int = 128) -> DecodeOverheadModel:
    """Build the decode overhead model for one engine configuration.

    Attention-free (SSM) families have no cache-attention term; MLA
    reads the compressed latent+rope row (latent twice: scores and the
    weighted sum); GQA reads K and V. Score traffic counts 3 HBM
    accesses per score element (write, softmax read, weighted-sum read)
    at f32."""
    c = model_cfg
    L = c.num_layers
    if c.is_attention_free:
        kv_bytes = score_bytes = 0.0
    elif c.mla is not None:
        m = c.mla
        width = 2.0 * m.kv_lora_rank + m.qk_rope_head_dim
        kv_bytes = width * bytes_per_el * L
        score_bytes = 3.0 * c.num_heads * 4.0 * L
    else:
        kv = c.num_kv_heads * c.resolved_head_dim
        kv_bytes = 2.0 * kv * bytes_per_el * L
        score_bytes = 3.0 * c.num_heads * 4.0 * L
    return DecodeOverheadModel(
        kv_bytes_per_pos=kv_bytes, score_bytes_per_pos=score_bytes,
        num_slots=num_slots, max_len=max_len, tile=tile,
        hbm_bw=peak_flops * HBM_BYTES_PER_FLOP,
        comm_time=it_model.other_time)
