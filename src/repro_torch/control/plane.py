"""The control plane (port of ``repro.control.plane``).

Responsibilities, as in the reference:

* **plan skeleton** — derive the real-group :class:`PlanStatic` from a
  :class:`WorkloadControlConfig` and null it when the architecture has no
  prunable scope at this TP degree.
* **build cache** — own the signature-keyed :class:`PlanCompileCache`;
  the caller supplies a ``builder(static_or_none) -> step_fn`` and the
  plane guarantees each canonical signature builds once,
  so the build and hit counts keep the reference's meaning.
* **controller** — the sim-scale :class:`SemiController` (Eq. 1–3), fed
  either the χ-oracle or the closed telemetry loop (``times=measured``).
* **dispatch** — :meth:`dispatch` projects a (possibly sim-scale) plan
  onto the real group, picks the step built for the projected signature
  and assembles the plan tensors.
* **telemetry** — measurement capture, online estimation, and replayable
  trace output.

The reference's ragged shard geometry and checkpoint round-trip, and its
``controller_blocks="global"`` / unclamped-shed conventions (the
trainer's), come with the training slice; this plane plans in per-rank
shard blocks and clamps projected sheds, as the reference's serve engine
asks it to.

Plan tensors: ``bucket_by_rank`` stays on the host (the layers read the
bucket as a Python integer to pick a branch, which would cost a device
sync if it lived on the card); the priority lists live on the plane's
device, where the kernels read their keep ids. The reference's
``mig_src`` vector has no reader before migration (the training slice).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, WorkloadControlConfig
from repro_torch.control import scopes as scopes_lib
from repro_torch.control.projection import project_plan
from repro_torch.core import hetero as hetero_lib
from repro_torch.core.controller import SemiController, work_fraction
from repro_torch.core.workload import PlanCompileCache, PlanStatic, WorkloadPlan
from repro_torch.telemetry import (EstimatorConfig, RankTimer,
                                   StragglerEstimator, TraceWriter,
                                   capture_sample, measurement_rng,
                                   schedule_from_trace)


def make_schedule(kind: str, num_ranks: int, *, chi: float = 2.0,
                  period: int = 10, contention_p: float = 0.15,
                  seed: int = 0, trace_in: Optional[str] = None,
                  trace_rank_offset: int = 0):
    """χ-schedule factory shared by the drivers (``None`` = homogeneous).

    ``kind="trace"`` replays a recorded telemetry trace (``trace_in``;
    ``trace_rank_offset`` selects a lane slice of a wider cluster
    trace); the other kinds are the paper's Sec. V-A simulation regimes.
    """
    if kind == "trace":
        if not trace_in:
            raise ValueError("hetero kind 'trace' needs trace_in "
                             "(a telemetry trace to replay)")
        return schedule_from_trace(trace_in, num_ranks=num_ranks,
                                   rank_offset=trace_rank_offset)
    if kind == "none":
        return None
    return hetero_lib.HeteroSchedule(
        num_ranks=num_ranks, kind=kind,
        chis=(chi,) if kind in ("static", "round_robin") else (),
        period=period, contention_p=contention_p, contention_chi=chi,
        seed=seed)


@dataclasses.dataclass(frozen=True)
class PlanCapacity:
    """Plan-adjusted capacity snapshot the cluster router consumes:
    the modeled step time at this step's χ feed under the ACTIVE plan's
    retained-work fractions, and the homogeneous floor."""

    step: int
    chi: np.ndarray
    work_frac: np.ndarray
    step_time_s: float
    dense_step_time_s: float

    @property
    def effective_speed(self) -> float:
        """Fraction of homogeneous throughput this replica sustains
        under its active plan (1.0 = uncontended-equivalent)."""
        return self.dense_step_time_s / max(self.step_time_s, 1e-12)


class ControlPlane:
    """Plan assembly, build caching, mitigation dispatch and telemetry.

    ``builder(static_or_none)`` returns the step function for that plan
    skeleton.
    """

    def __init__(self, model_cfg: ModelConfig, wc: WorkloadControlConfig, *,
                 tp: int,
                 builder: Callable[[Optional[PlanStatic]], Any],
                 it_model: hetero_lib.IterationModel,
                 device="cpu", sim_ranks: int = 0,
                 hetero_kind: str = "none", chi: float = 2.0,
                 period: int = 10, contention_p: float = 0.15,
                 seed: int = 0, trace_in: Optional[str] = None,
                 trace_rank_offset: int = 0,
                 trace_out: Optional[str] = None,
                 trace_meta: Optional[Dict[str, Any]] = None,
                 measure_noise: float = 0.0):
        self.wc = wc
        self.tp = tp
        self.device = torch.device(device)
        self.it_model = it_model
        self.sim_ranks = sim_ranks or tp
        self.measure_noise = measure_noise

        # -- plan skeleton (real group scale) ------------------------------
        static = None
        if wc.enabled:
            static = PlanStatic(
                buckets=wc.gamma_buckets, block_size=wc.block_size,
                tp_size=tp, imputation=wc.imputation)
            if not scopes_lib.control_scopes(model_cfg, static):
                static = None               # arch exempt at this tp
        self.static = static
        self.scopes = (scopes_lib.control_scopes(model_cfg, static)
                       if static is not None else {})
        self.identity_pri = (scopes_lib.plan_pri_arrays(
            self.scopes, {}, tp, device=self.device)
            if static is not None else {})

        # -- build cache ---------------------------------------------------
        self.cache = PlanCompileCache(builder)
        self.base = self.cache.get(static)

        # -- controller at the simulated group scale -----------------------
        # it reasons in per-rank shard blocks (the paper's L_i)
        if static is not None and self.sim_ranks != tp:
            sim_static = dataclasses.replace(static, tp_size=self.sim_ranks)
            sim_scopes = scopes_lib.control_scopes(model_cfg, sim_static)
        else:
            sim_scopes = self.scopes
        self.sim_nb = next(iter(sim_scopes.values()), 1)
        self.controller: Optional[SemiController] = None
        if wc.enabled and static is not None:
            self.controller = SemiController(wc, self.sim_ranks, it_model,
                                             self.sim_nb, seed=seed)

        # -- χ schedule + telemetry ----------------------------------------
        self.schedule = make_schedule(
            hetero_kind, self.sim_ranks, chi=chi, period=period,
            contention_p=contention_p, seed=seed, trace_in=trace_in,
            trace_rank_offset=trace_rank_offset)
        measured = self.controller is not None and wc.times == "measured"
        self.estimator = (StragglerEstimator(
            it_model, self.sim_ranks, EstimatorConfig.from_control(wc))
            if measured else None)
        self.timer = RankTimer()
        self.writer = (TraceWriter(
            trace_out, self.sim_ranks,
            matmul_time=it_model.matmul_time,
            other_time=it_model.other_time, meta=trace_meta or {})
            if trace_out else None)
        self.measure_rng = measurement_rng(seed)
        # retained-work fractions of the last DISPATCHED plan (None until
        # the first controlled step) — what `capacity` prices against
        self._active_frac: Optional[np.ndarray] = None

    # -- per-iteration loop ---------------------------------------------------
    def chis(self, step: int) -> np.ndarray:
        """Simulated per-rank χ for this step (ones when homogeneous)."""
        if self.schedule is not None:
            return self.schedule.chi(step)
        return np.ones((self.sim_ranks,))

    def controller_times(self, chis: np.ndarray) -> np.ndarray:
        """Per-rank FULL-workload-equivalent times for the controller:
        the estimator's reconstruction in measured mode (neutral nominal
        times until its warmup gate opens), the χ-oracle through the
        iteration model otherwise — Eq.(1) measures the heterogeneity
        degree, never the already-mitigated runtime."""
        if self.estimator is not None:
            return (self.estimator.full_times() if self.estimator.ready
                    else self.estimator.nominal_times())
        return self.it_model.times(np.asarray(chis, np.float64),
                                   np.ones(self.sim_ranks))

    def decide(self, times: np.ndarray):
        """Run the controller (Alg. 2) on per-rank times."""
        return self.controller.plan(times)

    def dispatch(self, plan: WorkloadPlan):
        """Step + plan tensors for a plan, on the real group.

        Projects the (possibly sim-scale) plan onto the real TP group and
        picks the step built for the projected signature. Returns
        ``(step_fn, plan_arrays, projected)``; ``projected`` is the plan
        that actually EXECUTES.
        """
        proj = project_plan(plan, sim_ranks=self.sim_ranks, tp=self.tp,
                            real_nb=self.scopes.get("ffn", 0))
        st_iter = dataclasses.replace(self.static, mig_shed=proj.mig_sheds,
                                      mig_blocks=0)
        step_fn = self.cache.get(st_iter)
        pri = (scopes_lib.plan_pri_arrays(self.scopes,
                                          plan.dynamic.pri_lists, self.tp,
                                          device=self.device)
               if plan.dynamic.pri_lists else self.identity_pri)
        arrays = {"bucket_by_rank": torch.as_tensor(
                      np.asarray(proj.bucket_by_rank, np.int32)),
                  "pri": pri}
        return step_fn, arrays, proj

    def work_frac(self, plan: WorkloadPlan) -> np.ndarray:
        """Retained-work fraction per simulated rank implied by a plan;
        also records it as the ACTIVE plan for :meth:`capacity`."""
        f = work_fraction(plan, self.sim_nb)
        self._active_frac = np.asarray(f, np.float64)
        return f

    # -- cluster-router feed --------------------------------------------------
    def chi_feed(self, step: int) -> np.ndarray:
        """Per-rank χ the cluster router consumes: the estimator's χ̂
        once the measured loop is locked, else the schedule's oracle."""
        if self.estimator is not None and self.estimator.ready:
            return np.asarray(self.estimator.chi_hat, np.float64)
        return np.asarray(self.chis(step), np.float64)

    def capacity(self, step: int) -> PlanCapacity:
        """Plan-adjusted capacity at this step's χ feed. Pure — never
        runs the controller."""
        chi = self.chi_feed(step)
        frac = (self._active_frac if self._active_frac is not None
                else np.ones(self.sim_ranks))
        ones = np.ones_like(chi)
        return PlanCapacity(
            step=step, chi=chi, work_frac=frac,
            step_time_s=self.it_model.step_time(chi, frac),
            dense_step_time_s=self.it_model.step_time(ones, ones))

    def capture(self, chis, work_frac, *, step: int, plan, wall: float):
        """Simulated-measurement capture: feed the estimator + the trace.
        The rank gather only applies when the measurement vector is
        rank-aligned with the real group (sim group == real tp)."""
        if self.estimator is None and self.writer is None:
            return None
        sample = capture_sample(
            self.it_model, chis, work_frac, step=step, plan=plan, wall=wall,
            rng=self.measure_rng, noise=self.measure_noise,
            timer=self.timer if self.sim_ranks == self.tp else None)
        if self.estimator is not None:
            self.estimator.observe(sample)
        if self.writer is not None:
            self.writer.append(sample)
        return sample

    def close(self) -> None:
        """Flush/close the telemetry trace (safe to call repeatedly)."""
        if self.writer is not None:
            self.writer.close()

    def counts(self) -> Dict[str, int]:
        """Build-cache + estimator telemetry for histories/benchmarks."""
        out = {"plan_compiles": self.cache.compile_count,
               "plan_cache_hits": self.cache.hit_count}
        if self.estimator is not None:
            out["estimator_updates"] = self.estimator.updates
            out["estimator_rejected"] = self.estimator.rejected_total
        return out
