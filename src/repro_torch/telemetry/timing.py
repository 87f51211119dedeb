"""Measurement layer: per-rank step timing (port of ``repro.telemetry.timing``).

Two clocks feed a :class:`StepSample`:

* **host wall** — :class:`RankTimer` brackets the step with
  ``time.perf_counter``; ``stop`` first waits for the device
  (``torch.cuda.synchronize()`` when the step's outputs live on a CUDA
  device, nothing on the CPU, where PyTorch runs synchronously), so the
  wall includes the device work and not just its enqueue.
* **per-rank segment clock** — each simulated rank's matmul-path time,
  from the simulated measurement backend (χ-schedule ×
  ``IterationModel`` × the ACTIVE plan's work fraction). The reference
  all-gathers the ranks' local clocks over the mesh's ``model`` axis once
  per control interval. Here the ``tp`` ranks are emulated in one
  process, so the gather is the identity over the group — the vector
  goes through float32 as the reference's does, and ``gather_count``
  counts it as the reference counts its collectives. At ``tp == 1``
  there is no group and the vector passes through unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class StepSample:
    """One control-interval measurement record (the trace unit).

    rank_times are the times AS MEASURED — i.e. under the plan that was
    active for the step (mitigated). ``work_frac`` records that plan's
    retained-work fraction so the estimator (and trace replay) can
    reconstruct full-workload-equivalent times exactly.
    """

    step: int
    rank_times: np.ndarray               # [e] measured per-rank seconds
    plan_signature: str = ""             # canonical static-plan signature
    work_frac: Optional[np.ndarray] = None   # [e] retained-work fraction
    wall_s: float = 0.0                  # host wall around the device wait

    def to_json(self) -> Dict[str, Any]:
        d = {"kind": "sample", "step": int(self.step),
             "rank_times": [float(t) for t in np.asarray(self.rank_times)],
             "plan_signature": self.plan_signature,
             "wall_s": float(self.wall_s)}
        if self.work_frac is not None:
            d["work_frac"] = [float(f) for f in np.asarray(self.work_frac)]
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "StepSample":
        wf = d.get("work_frac")
        return StepSample(
            step=int(d["step"]),
            rank_times=np.asarray(d["rank_times"], np.float64),
            plan_signature=d.get("plan_signature", ""),
            work_frac=(np.asarray(wf, np.float64) if wf is not None else None),
            wall_s=float(d.get("wall_s", 0.0)))


def _wait_for(outputs) -> None:
    """Block until the device work producing ``outputs`` has finished."""
    tensors = outputs if isinstance(outputs, (list, tuple)) else (outputs,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class RankTimer:
    """Host wall clock + per-rank gather for the measurement loop.

    ``start``/``stop`` measure the real step wall (``stop`` waits for the
    step outputs' device first, so asynchronous launches cannot hide
    device time). ``gather`` exchanges the ranks' local clocks — run
    every ``interval`` steps by ``maybe_gather`` when the group has more
    than one rank.
    """

    def __init__(self, tp: int = 1, interval: int = 1):
        self.tp = int(tp)
        self.interval = max(int(interval), 1)
        self.gather_count = 0
        self._t0: Optional[float] = None

    # -- host wall ---------------------------------------------------------
    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, outputs=None) -> float:
        """Wait for ``outputs`` (if given) and return elapsed seconds."""
        if outputs is not None:
            _wait_for(outputs)
        t0 = self._t0 if self._t0 is not None else time.perf_counter()
        self._t0 = None
        return time.perf_counter() - t0

    # -- per-rank gather ----------------------------------------------------
    def gather(self, local_times: np.ndarray) -> np.ndarray:
        """All-gather the per-rank local clocks: the identity over the
        emulated group, in float32 as the reference's collective."""
        if self.tp <= 1:
            return np.asarray(local_times, np.float64)
        self.gather_count += 1
        return np.asarray(np.asarray(local_times, np.float32), np.float64)

    def maybe_gather(self, step: int, local_times: np.ndarray) -> np.ndarray:
        """Gather on control-interval boundaries; pass through otherwise."""
        if self.tp > 1 and step % self.interval == 0:
            return self.gather(local_times)
        return np.asarray(local_times, np.float64)


MEASURE_STREAM = 0x7E1E    # SeedSequence domain tag for measurement noise


def measurement_rng(seed: int) -> np.random.Generator:
    """Noise stream for simulated measurements, keyed off the run seed on
    its own SeedSequence domain so it never aliases the data or
    χ-schedule RNG streams."""
    return np.random.default_rng(
        np.random.SeedSequence((int(seed), MEASURE_STREAM)))


def capture_sample(model, chis, work_frac, *, step: int, plan=None,
                   wall: float = 0.0, rng=None, noise: float = 0.0,
                   timer: Optional[RankTimer] = None) -> StepSample:
    """Simulated-measurement backend shared by the drivers: what each rank
    would locally observe for this step — per-rank times under the ACTIVE
    plan (mitigated), optional multiplicative measurement noise — passed
    through the ``timer``'s gather hook when one is supplied (only when
    the measurement vector is rank-aligned with the real group)."""
    meas = model.times(np.asarray(chis, np.float64),
                       np.asarray(work_frac, np.float64))
    if noise and rng is not None:
        meas = meas * (1.0 + rng.uniform(-noise, noise, len(meas)))
    if timer is not None:
        meas = timer.maybe_gather(step, meas)
    return StepSample(
        step=step, rank_times=meas,
        plan_signature=(plan.static.signature_str()
                        if plan is not None else ""),
        work_frac=np.asarray(work_frac, np.float64).copy(), wall_s=wall)
