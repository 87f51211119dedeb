"""Online straggler estimation from measured times (DESIGN_TELEMETRY.md §2).

The controller (Eq. 1-3) wants to know each rank's heterogeneity degree,
but a closed measurement loop only observes the MITIGATED runtime: once
the plan prunes a straggler, its measured time drops and a naive loop
would immediately un-prune it (prune/un-prune oscillation). The fix is to
invert the iteration-time decomposition under the plan that was active
for the measured step:

    T_i = M · f_i · χ_i + C            (measured, f_i = retained-work
                                        fraction of the active plan)
    χ̂_i = (T_i − C) / (M · f_i)        (inversion; M, C from the pretest
                                        / IterationModel)
    T̂_i = M · χ̂_i + C                  (full-workload-equivalent time the
                                        controller consumes)

χ̂ is maintained per rank with:

* **median/MAD outlier rejection** — a single spiked sample (GC pause,
  page fault) deviating from the rank's recent median by more than
  ``outlier_nmad`` robust standard deviations is dropped, not smoothed
  in. ``regime_steps`` CONSECUTIVE rejections in a row are not noise but
  a regime change (contention burst start/end): the rank's window is
  flushed and χ̂ re-locks to the new level immediately.
* **EWMA smoothing** — accepted samples fold in with weight
  ``ewma_alpha`` (first accepted sample after a flush seeds χ̂ directly).
* **warmup gate** — ``ready`` is False until ``warmup_steps`` updates
  have been ingested; the drivers keep the plan neutral until then.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.hetero import IterationModel


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    ewma_alpha: float = 0.4        # weight of the newest accepted sample
    warmup_steps: int = 3          # updates before `ready` (and per-rank
    #                                history needed before outlier tests)
    outlier_nmad: float = 4.0      # rejection threshold in robust sigmas
    outlier_rel_floor: float = 0.05  # MAD floor as a fraction of the median
    #                                (an all-identical window has MAD 0 and
    #                                 would otherwise reject everything)
    regime_steps: int = 2          # consecutive rejections = regime change
    window: int = 16               # per-rank accepted-sample history
    min_work_frac: float = 1e-3    # guard for inverting near-zero fractions
    min_chi: float = 1e-3

    @staticmethod
    def from_control(wc) -> "EstimatorConfig":
        """Build from a WorkloadControlConfig (the --times=measured knobs)."""
        return EstimatorConfig(ewma_alpha=wc.ewma_alpha,
                               warmup_steps=wc.estimator_warmup,
                               outlier_nmad=wc.outlier_nmad)


class StragglerEstimator:
    """Per-rank χ̂ from a stream of measured (mitigated) step times."""

    def __init__(self, model: IterationModel, num_ranks: int,
                 cfg: Optional[EstimatorConfig] = None):
        self.model = model
        self.num_ranks = num_ranks
        self.cfg = cfg or EstimatorConfig()
        w = self.cfg.window
        self._buf = np.full((num_ranks, w), np.nan)
        self._ptr = np.zeros(num_ranks, np.int64)
        self._count = np.zeros(num_ranks, np.int64)
        self._rejects = np.zeros(num_ranks, np.int64)
        self.chi_hat = np.ones(num_ranks, np.float64)
        self.updates = 0
        self.rejected_total = 0
        self.relocks = 0

    # -- core --------------------------------------------------------------
    def invert(self, rank_times: np.ndarray,
               work_frac: Optional[np.ndarray] = None) -> np.ndarray:
        """Raw per-sample χ from measured times under the active plan."""
        t = np.asarray(rank_times, np.float64)
        f = (np.ones_like(t) if work_frac is None
             else np.asarray(work_frac, np.float64))
        f = np.maximum(f, self.cfg.min_work_frac)
        m = max(self.model.matmul_time, 1e-12)
        return np.maximum((t - self.model.other_time) / (m * f),
                          self.cfg.min_chi)

    def update(self, rank_times: np.ndarray,
               work_frac: Optional[np.ndarray] = None) -> np.ndarray:
        """Ingest one measured sample; returns the updated χ̂ vector."""
        cfg = self.cfg
        raw = self.invert(rank_times, work_frac)
        reject = np.zeros(self.num_ranks, bool)
        have = self._count >= max(cfg.warmup_steps, 1)
        if have.any():
            sub = self._buf[have]
            med = np.nanmedian(sub, axis=1)
            mad = np.nanmedian(np.abs(sub - med[:, None]), axis=1)
            thr = cfg.outlier_nmad * np.maximum(
                1.4826 * mad, cfg.outlier_rel_floor * np.abs(med))
            reject[have] = np.abs(raw[have] - med) > thr
        self._rejects = np.where(reject, self._rejects + 1, 0)
        self.rejected_total += int(reject.sum())

        # persistent deviation is not a spike but a regime change
        # (contention burst start/end): flush and re-lock
        relock = self._rejects >= cfg.regime_steps
        if relock.any():
            self.relocks += int(relock.sum())
            self._buf[relock] = np.nan
            self._ptr[relock] = 0
            self._count[relock] = 0
            self._rejects[relock] = 0
            reject &= ~relock

        accept = ~reject
        idx = np.nonzero(accept)[0]
        self._buf[idx, self._ptr[idx] % cfg.window] = raw[idx]
        self._ptr[idx] += 1
        self._count[idx] = np.minimum(self._count[idx] + 1, cfg.window)
        first = accept & (self._count == 1)
        a = cfg.ewma_alpha
        self.chi_hat = np.where(
            first, raw,
            np.where(accept, (1 - a) * self.chi_hat + a * raw, self.chi_hat))
        self.updates += 1
        return self.chi_hat

    def observe(self, sample) -> np.ndarray:
        """Ingest a :class:`StepSample` (rank_times + its work_frac)."""
        return self.update(sample.rank_times, sample.work_frac)

    # -- checkpoint / resume ------------------------------------------------
    def state_arrays(self) -> dict:
        """Full estimator state as numpy arrays, so a resumed run's χ̂
        stream is bit-identical to an uninterrupted one."""
        return {"buf": self._buf.copy(), "ptr": self._ptr.copy(),
                "count": self._count.copy(), "rejects": self._rejects.copy(),
                "chi_hat": self.chi_hat.copy(),
                "counters": np.asarray([self.updates, self.rejected_total,
                                        self.relocks], np.int64)}

    def load_state_arrays(self, arrays: dict) -> None:
        """Restore :meth:`state_arrays` output (shape-checked)."""
        buf = np.asarray(arrays["buf"], np.float64)
        if buf.shape != self._buf.shape:
            raise ValueError(
                f"estimator checkpoint window {buf.shape} does not match "
                f"the configured ({self.num_ranks}, {self.cfg.window})")
        self._buf = buf.copy()
        self._ptr = np.asarray(arrays["ptr"], np.int64).copy()
        self._count = np.asarray(arrays["count"], np.int64).copy()
        self._rejects = np.asarray(arrays["rejects"], np.int64).copy()
        self.chi_hat = np.asarray(arrays["chi_hat"], np.float64).copy()
        updates, rejected, relocks = np.asarray(arrays["counters"], np.int64)
        self.updates = int(updates)
        self.rejected_total = int(rejected)
        self.relocks = int(relocks)

    # -- what the controller consumes --------------------------------------
    @property
    def ready(self) -> bool:
        """Warmup gate: enough samples ingested to trust the estimate."""
        return self.updates >= self.cfg.warmup_steps

    def full_times(self) -> np.ndarray:
        """Full-workload-equivalent per-rank times T̂ = M·χ̂ + C."""
        return self.model.matmul_time * self.chi_hat + self.model.other_time

    def nominal_times(self) -> np.ndarray:
        """Homogeneous (χ=1) times — what the drivers feed the controller
        while the warmup gate is closed, so the plan stays neutral."""
        return np.full((self.num_ranks,),
                       self.model.matmul_time + self.model.other_time)
