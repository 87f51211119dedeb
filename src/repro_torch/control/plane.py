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

``controller_blocks`` picks the block-count convention the controller
reasons in: ``"local"`` (per-rank shard blocks, the paper's L_i — the
serve engine's) or ``"global"`` (whole-scope blocks — the trainer's
historical convention, which its pinned trajectories depend on).
``clamp_sheds`` clamps projected shed counts to the real FFN shard
(source keeps >= 1 block), as the serve engine asks; the trainer keeps
the loud ``ValueError`` of its ``mig_blocks`` cap instead.
``geometry`` (per-rank FFN block counts, :mod:`repro_torch.core.geometry`)
puts the plane in the reference's geometry mode: the model config carries
the padded ``d_ff``, the controller plans at real group scale relative to
the static split (its workloads are the sizes), sheds are clamped against
the smallest rank's real blocks, and the priority lists keep the
canonical order; an all-equal geometry normalizes away.
:meth:`state_arrays` / :meth:`state_meta` / :meth:`load_state` carry the
controller's, the estimator's and the host RNG streams' state through a
checkpoint, as the reference's do.

Plan tensors: ``bucket_by_rank`` and ``mig_src`` stay on the host (the
layers read each rank's bucket and each slot's source rank as Python
integers to pick their branches, which would cost a device sync if they
lived on the card); the priority lists live on the plane's device, where
the kernels read their keep ids.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

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
                 controller_blocks: str = "local",
                 clamp_sheds: bool = True,
                 hetero_kind: str = "none", chi: float = 2.0,
                 period: int = 10, contention_p: float = 0.15,
                 seed: int = 0, trace_in: Optional[str] = None,
                 trace_rank_offset: int = 0,
                 trace_out: Optional[str] = None,
                 trace_meta: Optional[Dict[str, Any]] = None,
                 measure_noise: float = 0.0,
                 geometry: Optional[Sequence[int]] = None):
        self.wc = wc
        self.tp = tp
        self.device = torch.device(device)
        self.it_model = it_model
        self.sim_ranks = sim_ranks or tp
        self.clamp_sheds = clamp_sheds
        self.measure_noise = measure_noise
        if controller_blocks not in ("local", "global"):
            raise ValueError(f"controller_blocks must be 'local' or "
                             f"'global', got {controller_blocks!r}")

        # -- static ragged shard geometry (core/geometry.py) ---------------
        # per-rank FFN block counts; an all-equal tuple IS the implicit
        # split and normalizes away, keeping equal-geometry runs on the
        # geometry-free path
        geo = tuple(int(s) for s in geometry) if geometry else ()
        if len(set(geo)) <= 1:
            geo = ()
        if geo:
            if len(geo) != tp:
                raise ValueError(
                    f"geometry {geo} has {len(geo)} ranks but tp={tp}")
            if self.sim_ranks != tp:
                raise ValueError(
                    "ragged geometry requires the controller to plan at "
                    f"real mesh scale (sim_ranks={self.sim_ranks} != "
                    f"tp={tp})")
        self.geometry = geo

        # -- plan skeleton (real group scale) ------------------------------
        static = None
        if wc.enabled:
            static = PlanStatic(
                buckets=wc.gamma_buckets, block_size=wc.block_size,
                tp_size=tp, imputation=wc.imputation, geometry=geo)
            if not scopes_lib.control_scopes(model_cfg, static):
                static = None               # arch exempt at this tp
        self.static = static
        self.scopes = (scopes_lib.control_scopes(model_cfg, static)
                       if static is not None else {})
        if geo and static is not None:
            nb_pad = self.scopes.get("ffn", 0)
            if nb_pad != max(geo):
                raise ValueError(
                    f"geometry {geo}: padded local FFN block count "
                    f"{nb_pad} != max(geometry) — the model config must "
                    "carry the padded d_ff (core/geometry.py "
                    "apply_geometry_cfg)")
        elif geo and wc.enabled:
            raise ValueError(
                "ragged geometry needs the FFN controlled scope, but this "
                "architecture is exempt at this TP degree")
        self.identity_pri = (scopes_lib.plan_pri_arrays(
            self.scopes, {}, tp, geometry=geo or None, device=self.device)
            if static is not None else {})

        # -- build cache ---------------------------------------------------
        self.builder = builder          # the analyzer builds past the cache
        self.cache = PlanCompileCache(builder)
        self.base = self.cache.get(static)

        # -- controller at the simulated group scale -----------------------
        if static is not None and self.sim_ranks != tp:
            sim_static = dataclasses.replace(static, tp_size=self.sim_ranks)
            sim_scopes = scopes_lib.control_scopes(model_cfg, sim_static)
        else:
            sim_scopes = self.scopes
        self.sim_nb = next(iter(sim_scopes.values()), 1)
        self.controller: Optional[SemiController] = None
        if wc.enabled and static is not None:
            if geo:
                # geometry mode: the controller reasons in per-rank local
                # blocks (L_i = geometry[i]) whatever the configured
                # convention — sheds must fit a source's REAL blocks
                n_blocks = int(round(float(np.mean(geo))))
                self.controller = SemiController(
                    wc, self.sim_ranks, it_model, n_blocks, seed=seed,
                    workloads=np.asarray(geo, np.float64))
            else:
                n_blocks = (self.sim_nb * self.sim_ranks
                            if controller_blocks == "global"
                            else self.sim_nb)
                self.controller = SemiController(wc, self.sim_ranks,
                                                 it_model, n_blocks,
                                                 seed=seed)

        # -- χ schedule + telemetry ----------------------------------------
        self.schedule = make_schedule(
            hetero_kind, self.sim_ranks, chi=chi, period=period,
            contention_p=contention_p, seed=seed, trace_in=trace_in,
            trace_rank_offset=trace_rank_offset)
        measured = self.controller is not None and wc.times == "measured"
        self.estimator = (StragglerEstimator(
            it_model, self.sim_ranks, EstimatorConfig.from_control(wc))
            if measured else None)
        self.timer = RankTimer(tp=tp, interval=wc.measure_interval)
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

    def _geometry_base_frac(self) -> Optional[np.ndarray]:
        """Per-rank STATIC workload fractions L_i/L_eq, or None when the
        split is equal (keeps the geometry-free path untouched)."""
        if not self.geometry:
            return None
        L = np.asarray(self.geometry, np.float64)
        return L / max(float(L.mean()), 1e-12)

    def controller_times(self, chis: np.ndarray) -> np.ndarray:
        """Per-rank FULL-workload-equivalent times for the controller:
        the estimator's reconstruction in measured mode (neutral nominal
        times until its warmup gate opens), the χ-oracle through the
        iteration model otherwise — Eq.(1) measures the heterogeneity
        degree, never the already-mitigated runtime.

        Under a ragged geometry the static split is part of the baseline:
        times are evaluated at the geometry's own workload fractions
        (T_i = M·(L_i/L_eq)·χ_i + C), so Eq.(1) sees only the RESIDUAL
        imbalance the static shards did not absorb."""
        base = self._geometry_base_frac()
        if self.estimator is not None:
            if base is None:
                return (self.estimator.full_times() if self.estimator.ready
                        else self.estimator.nominal_times())
            chi_hat = (self.estimator.chi_hat if self.estimator.ready
                       else np.ones(self.sim_ranks))
            return self.it_model.times(chi_hat, base)
        return self.it_model.times(
            np.asarray(chis, np.float64),
            np.ones(self.sim_ranks) if base is None else base)

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
        # under a ragged geometry the clamp is against the SMALLEST rank's
        # real blocks — any rank can be retargeted as a source
        real_ffn_nb = (min(self.geometry) if self.geometry
                       else self.scopes.get("ffn", 0)) \
            if self.clamp_sheds else 0
        proj = project_plan(plan, sim_ranks=self.sim_ranks, tp=self.tp,
                            real_nb=real_ffn_nb)
        st_iter = dataclasses.replace(self.static, mig_shed=proj.mig_sheds,
                                      mig_blocks=0)
        step_fn = self.cache.get(st_iter)
        # learned priority statistics are collected over the PADDED weight
        # layout and do not renumber onto the ragged split — geometry runs
        # keep the canonical (identity) order instead
        use_learned = bool(plan.dynamic.pri_lists) and not self.geometry
        pri = (scopes_lib.plan_pri_arrays(self.scopes,
                                          plan.dynamic.pri_lists, self.tp,
                                          device=self.device)
               if use_learned else self.identity_pri)
        # one source rank per slot of the executed signature (-1 = idle)
        srcs = np.full((max(st_iter.num_sources, 1),), -1, np.int32)
        k = min(len(proj.mig_srcs), srcs.shape[0])
        srcs[:k] = np.asarray(proj.mig_srcs[:k], np.int32)
        arrays = {"bucket_by_rank": torch.as_tensor(
                      np.asarray(proj.bucket_by_rank, np.int32)),
                  "mig_src": srcs, "pri": pri}
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

    # -- checkpoint / resume --------------------------------------------------
    def state_arrays(self) -> Dict[str, Any]:
        """Numeric control-plane state as a tree of numpy arrays
        (checkpointed alongside params/opt in the same npz)."""
        out: Dict[str, Any] = {}
        if self.controller is not None:
            c = self.controller.state_arrays()
            if c:
                out["controller"] = c
        if self.estimator is not None:
            out["estimator"] = self.estimator.state_arrays()
        return out

    def state_meta(self) -> Dict[str, Any]:
        """JSON-able control-plane state (host RNG streams: their 128-bit
        PCG64 state words don't fit numpy dtypes)."""
        meta: Dict[str, Any] = {
            "measure_rng": self.measure_rng.bit_generator.state}
        if self.controller is not None:
            meta["controller_rng"] = self.controller.rng.bit_generator.state
        return meta

    def load_state(self, arrays: Optional[Dict[str, Any]],
                   meta: Optional[Dict[str, Any]]) -> None:
        """Restore :meth:`state_arrays` + :meth:`state_meta` output.

        Missing keys keep the fresh-start default (old checkpoints stay
        loadable). The converse — checkpointed state the CURRENT config
        cannot host (e.g. estimator state resumed without
        ``times=measured``) — voids the bit-identical-resume contract,
        so it warns loudly instead of being dropped in silence."""
        arrays = arrays or {}
        meta = meta or {}
        if "controller" in arrays:
            if self.controller is not None:
                self.controller.load_state_arrays(arrays["controller"])
            else:
                warnings.warn(
                    "checkpoint carries controller state but workload "
                    "control is disabled in this run — the control "
                    "trajectory will NOT match the interrupted run",
                    stacklevel=2)
        if "estimator" in arrays:
            if self.estimator is not None:
                self.estimator.load_state_arrays(arrays["estimator"])
            else:
                warnings.warn(
                    "checkpoint carries estimator state but this run is "
                    "not in times='measured' mode — the control "
                    "trajectory will NOT match the interrupted run",
                    stacklevel=2)
        if "measure_rng" in meta:
            self.measure_rng.bit_generator.state = meta["measure_rng"]
        if "controller_rng" in meta:
            if self.controller is not None:
                self.controller.rng.bit_generator.state = \
                    meta["controller_rng"]
            elif "controller" not in arrays:
                warnings.warn(
                    "checkpoint carries controller RNG state but workload "
                    "control is disabled in this run", stacklevel=2)
