"""Straggler detection and the SEMI-migration controller (Sec. III-A, IV-B).

Host-side logic that runs between training steps (the paper operates at
iteration/epoch granularity too). Consumes per-rank iteration times —
measured or produced by the heterogeneity model — and emits a
:class:`WorkloadPlan`.

Equations implemented:
  Eq.(1)  γ_i = (T_i − T_ref) / M_i            (T_ref = T_avg or T_min)
  Eq.(2)  Ω1 + Ω2(Lγ(1−β)) = Φ1(Lγβ) + Φ2(Lγβ/(e−1))   → β (closed form
          with the linear cost fits obtained from the pre-test)
  Eq.(3)  f(x) = (T_x − T_min) − Φ1(Γ(x)) − max_y (Γ(x)/(e−x) · T_y/L_y)
          → largest x with f(x) > 0 migrates; the rest resize.

T_avg maintenance: instead of an all-reduce per iteration, each rank
monitors its own runtime and the controller only refreshes the global
average when some rank drifted >10% since the last refresh (Sec. III-A).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.config import WorkloadControlConfig
from repro_torch.core.hetero import IterationModel
from repro_torch.core.priority import (PriorityState, build_pri_list,
                                 differentiated_gamma, mark_pruned,
                                 update_state)
from repro_torch.core.workload import (PlanDynamic, PlanStatic, WorkloadPlan,
                                 bucket_for_gamma, keep_blocks_for_bucket,
                                 quantize_shed, shed_bucket_counts)


# ---------------------------------------------------------------------------
# Cost functions (pre-test, Sec. IV-B / Alg. 2 line 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostFunctions:
    """Linear fits of the cost curves sampled in the pre-test.

    Ω1: static allocation overhead of a resized submatrix (seconds).
    Ω2(n) = omega2_slope·n: dimension-extraction cost for n columns.
    Φ1(n) = phi1_base + phi1_slope·n: broadcast communication for n columns.
    Φ2(n) = phi2_slope·n: helper-side compute for n columns.
    """

    omega1: float
    omega2_slope: float
    phi1_base: float
    phi1_slope: float
    phi2_slope: float

    def phi1(self, n: float) -> float:
        """Broadcast cost of migrating n columns.

        Φ1(0) = 0 exactly: migrating nothing launches no collective, so
        the base (launch-latency) term applies only when n > 0. The
        function is therefore INTENTIONALLY discontinuous at n = 0 by
        ``phi1_base`` — Eq.(3) relies on this, pricing the first migrated
        column at the full collective-launch cost (pinned by
        tests/test_controller_properties.py).
        """
        if n <= 0:
            return 0.0
        return self.phi1_base + self.phi1_slope * n


def pretest_cost_functions(model: IterationModel, L_total: int,
                           *, e: int,
                           link_bytes_per_col: float = 0.0,
                           link_bw: float = 50e9) -> CostFunctions:
    """Derive the cost fits from the iteration model + ICI constants.

    In the paper this is measured by running a few ratios before training;
    without real heterogeneous hardware we sample the same analytic model
    the simulator uses (equivalent epistemics, and unit-consistent).
    """
    per_col_compute = model.matmul_time / max(L_total, 1)
    return CostFunctions(
        omega1=0.002 * model.matmul_time,          # small static realloc cost
        omega2_slope=0.05 * per_col_compute,        # gather/extract per column
        phi1_base=5e-5,                             # collective launch latency
        phi1_slope=(link_bytes_per_col / link_bw) if link_bytes_per_col
        else 0.20 * per_col_compute,
        phi2_slope=per_col_compute,                 # helper computes the column
    )


# ---------------------------------------------------------------------------
# Equations
# ---------------------------------------------------------------------------


def eq1_gamma(t_i: float, t_ref: float, m_i: float, gamma_max: float = 0.875) -> float:
    """Pruning ratio that offsets the runtime gap (Eq. 1)."""
    if m_i <= 0:
        return 0.0
    return float(np.clip((t_i - t_ref) / m_i, 0.0, gamma_max))


def eq2_beta(L_gamma: float, costs: CostFunctions, e: int) -> float:
    """Allocation ratio β between migration (β) and resizing (1−β), Eq. (2).

    With linear fits: Ω1 + a·Lγ(1−β) = c0 + c1·Lγβ + c2·Lγβ/(e−1)
    → β = (Ω1 + a·Lγ − c0) / (Lγ·(a + c1 + c2/(e−1))).
    """
    if L_gamma <= 0:
        return 0.0
    a = costs.omega2_slope
    denom = L_gamma * (a + costs.phi1_slope + costs.phi2_slope / max(e - 1, 1))
    if denom <= 0:
        return 1.0
    beta = (costs.omega1 + a * L_gamma - costs.phi1_base) / denom
    return float(np.clip(beta, 0.0, 1.0))


def eq3_migration_prefix(times_desc: np.ndarray, workloads: np.ndarray,
                         costs: CostFunctions, e: int) -> int:
    """Largest straggler prefix x for which migration stays cost-effective.

    times_desc: per-rank times sorted descending; workloads: matching L_i
    (current column workloads). Returns x (0 => nobody migrates).
    """
    t_min = float(times_desc.min())
    x_best = 0
    for x in range(1, len(times_desc)):
        # total migrated volume Γ(x)
        gamma_x = 0.0
        for k in range(x):
            if times_desc[k] > 0:
                gamma_x += workloads[k] * (times_desc[k] - t_min) / times_desc[k]
        helpers = np.arange(x, len(times_desc))
        if len(helpers) == 0:
            break
        # max additional runtime among receivers
        recv_cost = max(
            (gamma_x / max(e - x, 1)) * (times_desc[y] / max(workloads[y], 1e-12))
            for y in helpers)
        f_x = (times_desc[x - 1] - t_min) - costs.phi1(gamma_x) - recv_cost
        if f_x > 0:
            x_best = x
        else:
            break
    return x_best


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ControllerReport:
    """What the controller decided this step (for logs/benchmarks)."""

    stragglers: list
    gammas: Dict[int, float]
    bucket_by_rank: np.ndarray
    mig_src: int                       # first (heaviest) source, -1 = none
    mig_blocks: int                    # TOTAL shed blocks over all sources
    beta: float                        # β of the heaviest source
    x_migrating: int
    t_ref: float
    # concurrent multi-straggler decision (aligned, canonical shed-desc order)
    mig_srcs: tuple = ()
    mig_shed: tuple = ()
    betas: tuple = ()


class SemiController:
    """Implements Alg. 2 (SEMI) and its ZERO / MIG degenerate modes."""

    def __init__(self, cfg: WorkloadControlConfig, tp: int,
                 iter_model: IterationModel, num_blocks: int,
                 costs: Optional[CostFunctions] = None, seed: int = 0,
                 max_sources: Optional[int] = None,
                 shed_cap: Optional[int] = None,
                 workloads: Optional[Sequence[float]] = None):
        self.cfg = cfg
        self.tp = tp
        self.model = iter_model
        self.num_blocks = num_blocks            # prunable blocks per rank shard
        # per-rank static workloads L_i (block counts). Under a ragged
        # shard geometry (core/geometry.py) these are the geometry sizes,
        # and every Eq.(1)-(3) quantity scales rank-locally so the
        # controller plans only the RESIDUAL imbalance on top of the
        # static split. Default: the equal split (L_i = num_blocks), which
        # reproduces the geometry-free numerics exactly.
        if workloads is not None:
            w = np.asarray(workloads, np.float64)
            if w.shape != (tp,):
                raise ValueError(
                    f"workloads shape {w.shape} != ({tp},)")
            if np.any(w < 1):
                raise ValueError(f"workloads must be >= 1, got {w}")
            self.workloads = w
        else:
            self.workloads = np.full((tp,), float(num_blocks))
        # static geometry to stamp into emitted plans (uneven only — an
        # equal split is the geometry-free baseline)
        geo = tuple(int(round(v)) for v in self.workloads)
        self.geometry = geo if (workloads is not None
                                and len(set(geo)) > 1) else ()
        self.max_sources = (cfg.max_migration_sources
                            if max_sources is None else max_sources)
        self.shed_cap = (cfg.migration_shed_cap
                         if shed_cap is None else shed_cap)
        self.costs = costs or pretest_cost_functions(
            iter_model, num_blocks, e=tp)
        self.priority: Dict[str, PriorityState] = {}
        self.rng = np.random.default_rng(seed)
        self._t_avg: Optional[float] = None
        self._t_at_refresh: Optional[np.ndarray] = None

    # -- priority bookkeeping -------------------------------------------
    def observe_weights(self, named_weights: Dict[str, np.ndarray], block: int):
        """Epoch-granularity statistics refresh (Alg. 1)."""
        for name, w in named_weights.items():
            nb = w.shape[0] // block
            st = self.priority.get(name) or PriorityState.create(nb)
            self.priority[name] = update_state(st, np.asarray(w), block)

    def pri_lists(self) -> Dict[str, np.ndarray]:
        return {name: build_pri_list(st, self.rng, self.cfg.selection
                                     if self.cfg.selection != "priority_diff"
                                     else "priority")
                for name, st in self.priority.items()}

    # -- checkpoint / resume ----------------------------------------------
    def state_arrays(self) -> Dict[str, object]:
        """Numeric controller state as a pytree of numpy arrays: the
        passive T_avg bookkeeping plus the per-scope priority statistics.
        (The host RNG stream is 128-bit PCG64 state — checkpointed
        separately as JSON by the control plane.)"""
        out: Dict[str, object] = {}
        if self._t_avg is not None:
            out["t_avg"] = np.asarray(self._t_avg, np.float64)
        if self._t_at_refresh is not None:
            out["t_at_refresh"] = np.asarray(self._t_at_refresh, np.float64)
        pri = {}
        for name, st in self.priority.items():
            d = {"w_var": np.asarray(st.w_var, np.float64),
                 "pruned_last": np.asarray(st.pruned_last, bool)}
            if st.snapshot is not None:
                d["snapshot"] = np.asarray(st.snapshot)
            pri[name] = d
        if pri:
            out["pri"] = pri
        return out

    def load_state_arrays(self, arrays: Dict[str, object]) -> None:
        """Restore :meth:`state_arrays` output (missing keys keep the
        fresh-start default, so old checkpoints stay loadable)."""
        t_avg = arrays.get("t_avg")
        self._t_avg = float(np.asarray(t_avg)) if t_avg is not None else None
        t_ref = arrays.get("t_at_refresh")
        self._t_at_refresh = (np.asarray(t_ref, np.float64).copy()
                              if t_ref is not None else None)
        self.priority = {}
        for name, d in (arrays.get("pri") or {}).items():
            w_var = np.asarray(d["w_var"], np.float64)
            snap = d.get("snapshot")
            self.priority[name] = PriorityState(
                num_blocks=int(w_var.shape[0]), w_var=w_var.copy(),
                pruned_last=np.asarray(d["pruned_last"], bool).copy(),
                snapshot=np.asarray(snap).copy() if snap is not None
                else None)

    # -- T_avg maintenance (Sec. III-A) ----------------------------------
    def _t_ref(self, times: np.ndarray) -> float:
        if self.cfg.mode in ("semi", "mig"):
            return float(times.min())           # strictest criterion (Sec. IV-B)
        if (self._t_avg is None or self._t_at_refresh is None
                or np.any(np.abs(times - self._t_at_refresh)
                          > self.cfg.tavg_refresh_threshold * self._t_at_refresh)):
            self._t_avg = float(times.mean())   # "passive refresh on demand"
            self._t_at_refresh = times.copy()
        return self._t_avg

    # -- main entry -------------------------------------------------------
    def plan(self, times: np.ndarray) -> "tuple[WorkloadPlan, ControllerReport]":
        times = np.asarray(times, np.float64)
        e = self.tp
        cfg = self.cfg
        t_ref = self._t_ref(times)
        m_i = self.model.matmul_time
        # deadband: a rank within straggler_threshold of T_ref is noise,
        # not heterogeneity — reacting would flip plans on every jittered
        # measurement (the scenario tests pin this stability).
        band = max(cfg.straggler_threshold, 1e-9)
        stragglers = [i for i in range(e) if times[i] > t_ref * (1 + band)]

        # M_i^j: the straggler's own matmul time this iteration scales with
        # its slowdown — a rank running χ× slow also prunes χ×-cheaper work,
        # so Eq.(1) uses the rank-local matmul cost. Under a ragged
        # geometry it additionally scales with the rank's static workload
        # share L_i/L_eq (the model's matmul_time is the equal-shard M).
        wl_mean = max(float(self.workloads.mean()), 1e-12)
        gammas = {i: eq1_gamma(times[i], t_ref,
                               m_i * (self.workloads[i] / wl_mean)
                               * times[i] / max(t_ref, 1e-12))
                  for i in stragglers}
        bucket_by_rank = np.zeros((e,), np.int32)
        beta, x_mig = 0.0, 0
        srcs: list = []          # source ranks, time-desc order
        sheds: list = []         # matching quantized shed counts
        betas: list = []
        # the compiled program needs >= 1 helper slot per source set
        max_src = min(self.max_sources, e - 1, max(len(stragglers), 0))

        def _quantized_shed(want: float, nb: Optional[int] = None) -> int:
            nb = self.num_blocks if nb is None else nb
            # ceil BEFORE the grid round-up: `round()` here let a
            # fractional request (e.g. 8.42 blocks) quantize DOWN onto
            # the grid, leaving a residual resize bucket on a source the
            # lossless β-policy promises is output-preserving
            m_q = quantize_shed(int(np.ceil(want - 1e-9)), nb,
                                cfg.gamma_buckets)
            if self.shed_cap:
                m_q = min(m_q, self.shed_cap)
            if self.geometry:
                # compiled branch tables require every shed to leave the
                # smallest-geometry rank at least one real block
                m_q = min(m_q, min(self.geometry) - 1)
            return max(m_q, 0)

        if cfg.mode == "zero" or not stragglers or max_src == 0:
            for i, g in gammas.items():
                bucket_by_rank[i] = bucket_for_gamma(g, cfg.gamma_buckets)

        elif cfg.mode == "mig":
            # migrate everything for every straggler (slowest first)
            for i in sorted(stragglers, key=lambda r: -times[r])[:max_src]:
                nb_i = int(round(self.workloads[i]))
                m_q = _quantized_shed(gammas[i] * nb_i, nb_i)
                if m_q > 0:
                    srcs.append(i)
                    sheds.append(m_q)
                    betas.append(1.0)
            x_mig = len(srcs)

        else:  # semi (Alg. 2)
            order = np.argsort(-times)
            times_desc = times[order]
            workloads = self.workloads[order]
            if len(stragglers) == 1:
                x_mig = 1
            else:
                x_mig = eq3_migration_prefix(times_desc, workloads,
                                             self.costs, e)
            x_mig = min(x_mig, max_src)
            # Eq.(3) selection over the sorted straggler list: the first
            # x ranks migrate (β-split per source), the rest resize.
            for k in range(x_mig):
                i = int(order[k])
                g = gammas.get(i, 0.0)
                nb_i = int(round(self.workloads[i]))
                L_gamma = g * nb_i
                # helpers shrink as the source set grows: e' − 1 = e − x
                # "lossless" β-policy: every Eq.(3)-selected source sheds
                # its FULL offset volume, so the residual resize bucket is
                # 0 and the plan is output-preserving (serve default)
                b_k = (1.0 if cfg.beta_policy == "lossless"
                       else eq2_beta(L_gamma, self.costs,
                                     max(e - x_mig + 1, 2)))
                m_q = _quantized_shed(L_gamma * b_k, nb_i)
                # fit check: the source must KEEP >= 1 block after both its
                # residual-resize bucket and the migrated shed — otherwise
                # the compiled branch clamp would double-compute blocks.
                grid = shed_bucket_counts(nb_i, cfg.gamma_buckets)
                while m_q > 0:
                    resid_gamma = max(0.0, (L_gamma - m_q) / nb_i)
                    b_res = bucket_for_gamma(resid_gamma, cfg.gamma_buckets)
                    kc = keep_blocks_for_bucket(
                        cfg.gamma_buckets[b_res], nb_i)
                    if kc - m_q >= 1:
                        break
                    smaller = [cnt for cnt in grid if cnt < m_q]
                    m_q = smaller[-1] if smaller else 0
                if m_q > 0:
                    srcs.append(i)
                    sheds.append(m_q)
                    betas.append(b_k)
                    resid_gamma = max(0.0, (L_gamma - m_q) / nb_i)
                    bucket_by_rank[i] = bucket_for_gamma(
                        resid_gamma, cfg.gamma_buckets)
                else:
                    bucket_by_rank[i] = bucket_for_gamma(g, cfg.gamma_buckets)
            beta = betas[0] if betas else 0.0
            x_mig = len(srcs)
            for i in order:
                i = int(i)
                if i not in stragglers or i in srcs:
                    continue
                bucket_by_rank[i] = bucket_for_gamma(
                    gammas[i], cfg.gamma_buckets)

        # canonical plan-signature order: shed counts descending (stable on
        # the time-desc order above), sources aligned — equivalent plans
        # then hash to the same compiled executable.
        if srcs:
            pairs = sorted(zip(sheds, srcs, betas), key=lambda p: -p[0])
            sheds = [p[0] for p in pairs]
            srcs = [p[1] for p in pairs]
            betas = [p[2] for p in pairs]

        report = ControllerReport(
            stragglers=stragglers, gammas=gammas,
            bucket_by_rank=bucket_by_rank.copy(),
            mig_src=srcs[0] if srcs else -1,
            mig_blocks=int(sum(sheds)), beta=betas[0] if betas else beta,
            x_migrating=x_mig, t_ref=t_ref,
            mig_srcs=tuple(srcs), mig_shed=tuple(sheds), betas=tuple(betas))

        static = PlanStatic(
            buckets=tuple(cfg.gamma_buckets), block_size=cfg.block_size,
            mig_shed=tuple(sheds), tp_size=e, imputation=cfg.imputation,
            geometry=self.geometry)
        dynamic = PlanDynamic(
            bucket_by_rank=bucket_by_rank,
            mig_src=(np.asarray(srcs, np.int32) if srcs
                     else np.array(-1, np.int32)),
            pri_lists=self.pri_lists())
        # mark pruned blocks for the incremental-update rule
        for name, st in list(self.priority.items()):
            pri = dynamic.pri_lists.get(name)
            if pri is None:
                continue
            worst_bucket = int(bucket_by_rank.max())
            kc = keep_blocks_for_bucket(cfg.gamma_buckets[worst_bucket], st.num_blocks)
            self.priority[name] = mark_pruned(st, pri, kc)

        return WorkloadPlan(static, dynamic), report


def decision_key(report: ControllerReport) -> tuple:
    """Hashable summary of WHAT the controller decided: the per-rank
    resize buckets plus the (source, shed) migration set. Two plans with
    the same key drive identical compiled branches."""
    return (tuple(int(b) for b in report.bucket_by_rank),
            tuple(sorted(zip(map(int, report.mig_srcs),
                             map(int, report.mig_shed)))))


def reports_agree(a: ControllerReport, b: ControllerReport,
                  bucket_slack: int = 1) -> bool:
    """Deadband-aware agreement between two controller decisions.

    Used by the telemetry suite to compare measured-mode against
    modeled-mode runs: the measured path sees EWMA-smoothed estimates, so
    a γ sitting near a bucket boundary may land one bucket away from the
    oracle's choice — that is measurement jitter inside the controller's
    own ``straggler_threshold`` deadband (one bucket = 0.125 ≈ the 0.12
    deadband), not a different decision. Migration source/shed sets must
    match exactly (they change the compiled signature)."""
    ka, kb = decision_key(a), decision_key(b)
    if ka[1] != kb[1]:
        return False
    return all(abs(x - y) <= bucket_slack for x, y in zip(ka[0], kb[0]))


def work_fraction(plan: WorkloadPlan, num_blocks: int) -> np.ndarray:
    """Retained matmul-work fraction per rank implied by a plan (for the
    iteration model / benchmarks). Handles concurrent multi-source
    migration: each active source drops its shed fraction; the H = e − S
    working helpers (first non-source ranks in helper order) each absorb
    ceil(shed_s / H) blocks per slot — mirroring the padded partition of
    the real dataflow.

    Fractions are in units of the EQUAL-shard matmul workload (what
    ``IterationModel.matmul_time`` prices), so under a ragged geometry a
    rank's base fraction is kc_r / L_eq with L_eq = mean(geometry): the
    static split shows up as per-rank work, not as a plan decision."""
    geo = plan.static.geometry
    if len(set(geo)) > 1:
        return _geometry_work_fraction(plan)
    e = plan.static.tp_size
    frac = np.ones((e,), np.float64)
    for r in range(e):
        g = plan.static.buckets[int(plan.dynamic.bucket_by_rank[r])]
        frac[r] *= (keep_blocks_for_bucket(g, num_blocks) / num_blocks)
    sheds = plan.static.mig_sheds
    if plan.static.migration_enabled and sheds:
        srcs = plan.dynamic.mig_srcs(len(sheds))
        active = [(int(s), int(m)) for s, m in zip(srcs, sheds)
                  if s >= 0 and m > 0]
        if active:
            H = max(e - len(sheds), 1)
            src_set = {s for s, _ in active}
            helpers = [r for r in range(e) if r not in src_set][:H]
            extra = 0.0
            for s, m in active:
                frac[s] *= max(0.0, 1.0 - m / num_blocks)
                extra += -(-m // H) / num_blocks
            for r in helpers:
                frac[r] += extra
    return frac


def _geometry_work_fraction(plan: WorkloadPlan) -> np.ndarray:
    """Per-rank work fractions under a ragged geometry, in equal-shard
    units (L_eq = mean(geometry) blocks = the matmul_time workload)."""
    st = plan.static
    e = st.tp_size
    L = np.asarray(st.geometry, np.float64)
    L_eq = max(float(L.mean()), 1e-12)
    kc = np.zeros((e,), np.float64)
    for r in range(e):
        g = st.buckets[int(plan.dynamic.bucket_by_rank[r])]
        kc[r] = keep_blocks_for_bucket(g, int(L[r]))
    frac = kc / L_eq
    sheds = st.mig_sheds
    if st.migration_enabled and sheds:
        srcs = plan.dynamic.mig_srcs(len(sheds))
        active = [(int(s), int(m)) for s, m in zip(srcs, sheds)
                  if s >= 0 and m > 0]
        if active:
            H = max(e - len(sheds), 1)
            src_set = {s for s, _ in active}
            helpers = [r for r in range(e) if r not in src_set][:H]
            extra = 0.0
            for s, m in active:
                # the compiled source branch runs exactly max(kc − m, 1)
                frac[s] = max(kc[s] - m, 1.0) / L_eq
                extra += -(-m // H) / L_eq
            for r in helpers:
                frac[r] += extra
    return frac
