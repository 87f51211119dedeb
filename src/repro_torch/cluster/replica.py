"""ReplicaHandle: one :class:`~repro_torch.launch.serve.ServeEngine` behind
the cluster router, with a lifecycle state machine (port of
``repro.cluster.replica``; DESIGN_CLUSTER.md).

States and transitions::

    SPARE ──promote()──> ACTIVE ──begin_drain()──> DRAINING ──(idle)──> DRAINED
                            │                          │
                            └────────fail()────────────┴──> FAILED
    FAILED/DRAINED ──restart()──> ACTIVE        (engine rebuilt from the
                                                 factory, i.e. from the
                                                 latest checkpoint)

A replica is *warm* by construction: the factory builds its engine (and
loads params from the checkpoint directory, the race-tolerant
``checkpoint/store.load_latest_params`` path) at handle creation, so
``promote()`` is O(1) — it only opens admission. ``begin_drain`` and
``fail`` both return the requests the cluster manager must re-route;
greedy decode is deterministic, so a reassigned request regenerates its
exact tokens from scratch on another replica (no drops, no divergence).

Two things are the port's own. ``fail()`` RELEASES the engine: an engine
is a reference cycle (its control plane keeps a closure over it), so
dropping the handle's reference alone would leave its parameters and
cache on the device until the next collection; ``fail()`` collects it
before it returns. And each engine keeps the device its factory gave it:
nothing here moves a tensor or picks a device.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.launch.serve import (Completion, LoadSnapshot, Request,
                                      ServeEngine, release_device_memory)

# lifecycle states
SPARE = "spare"          # warm, params loaded, not admitting, not ticking work
ACTIVE = "active"        # admitting + serving
DRAINING = "draining"    # not admitting; finishing in-flight slots
DRAINED = "drained"      # drain complete: idle, engine intact
FAILED = "failed"        # engine discarded; incomplete work reassigned

#: states whose engine ticks every cluster step (SPARE ticks idle so its
#: χ-schedule lane stays aligned with the cluster step for when it is
#: promoted mid-run; DRAINED/FAILED replicas are out of the time base)
_TICKING = (SPARE, ACTIVE, DRAINING)


class ReplicaHandle:
    """One serve engine + its lifecycle state, as the router sees it."""

    def __init__(self, name: str,
                 engine_factory: Callable[[], ServeEngine], *,
                 spare: bool = False):
        self.name = name
        self._factory = engine_factory
        self.engine: Optional[ServeEngine] = engine_factory()
        self.state = SPARE if spare else ACTIVE
        self._harvested = 0            # engine.completions consumed so far
        self.restarts = 0

    # -- routing interface ---------------------------------------------------
    @property
    def admitting(self) -> bool:
        return self.state == ACTIVE

    def try_route(self, req: Request) -> bool:
        """Admit a request if this replica is ACTIVE and can take it
        (non-blocking — the engine's ``try_submit`` contract)."""
        if not self.admitting:
            return False
        return self.engine.try_submit(req)

    def snapshot(self) -> LoadSnapshot:
        """The engine's load/capacity snapshot (raises when FAILED)."""
        if self.engine is None:
            raise RuntimeError(f"replica {self.name} is failed — no engine")
        return self.engine.load_snapshot()

    def score(self) -> float:
        """Aggregate effective-throughput score: modeled decode slots per
        second under the replica's ACTIVE plan — num_slots over the
        plan-adjusted step time (StragglerEstimator-fed in measured
        mode). Higher is better; the chi_aware policy uses the full
        snapshot, this scalar is for dashboards/tests. MODELED, from the
        iteration model: not a device time."""
        s = self.snapshot()
        return s.num_slots / max(s.step_time_s, 1e-12)

    # -- cluster-step driving ------------------------------------------------
    def tick(self) -> Optional[dict]:
        """One cluster step for this replica (no-op unless ticking).

        A DRAINING replica that has gone idle completes its drain here
        (state -> DRAINED)."""
        if self.state not in _TICKING or self.engine is None:
            return None
        report = self.engine.tick()
        if self.state == DRAINING and self.engine.idle:
            self.state = DRAINED
        return report

    def harvest(self) -> List[Completion]:
        """Completions finished since the last harvest."""
        if self.engine is None:
            return []
        out = self.engine.completions[self._harvested:]
        self._harvested = len(self.engine.completions)
        return out

    # -- lifecycle -----------------------------------------------------------
    def promote(self) -> None:
        """SPARE -> ACTIVE (warm-spare promotion: admission opens; params
        were already loaded at construction)."""
        if self.state != SPARE:
            raise ValueError(
                f"replica {self.name}: promote() from {self.state!r} — "
                "only a SPARE can be promoted")
        self.state = ACTIVE

    def begin_drain(self) -> List[Request]:
        """Stop admitting; in-flight slots finish, queued-but-unadmitted
        requests are returned for reassignment (they haven't started, so
        moving them costs nothing and shortens the drain)."""
        if self.state not in (ACTIVE, DRAINING):
            raise ValueError(
                f"replica {self.name}: begin_drain() from {self.state!r}")
        evicted = self.engine.evict_queue()
        self.state = DRAINED if self.engine.idle else DRAINING
        return evicted

    def fail(self) -> List[Request]:
        """Simulated replica loss: every INCOMPLETE request — in-flight
        slots first (admission order), then the queue — is returned for
        reassignment, and the engine is released: closed, dropped and
        collected, so its parameters and cache have left the device when
        this returns. The caller must harvest completions before failing,
        or finished work is lost."""
        if self.engine is None:
            return []
        inflight = self.engine.active_requests()
        queued = self.engine.evict_queue()
        self._release_engine()
        self.state = FAILED
        return inflight + queued

    def _release_engine(self) -> None:
        device = self.engine.device
        self.engine.close()
        self.engine = None             # the handle's only reference
        release_device_memory(device)

    def restart(self, sync_step: int = 0) -> None:
        """Rebuild the engine from the factory (fresh params from the
        latest checkpoint) and return to ACTIVE. ``sync_step``
        fast-forwards the new engine's step counter so its χ-schedule
        lane stays aligned with the cluster step."""
        if self.state not in (FAILED, DRAINED):
            raise ValueError(
                f"replica {self.name}: restart() from {self.state!r}")
        if self.engine is None:
            self.engine = self._factory()
            self._harvested = 0
        self.engine.step_count = max(self.engine.step_count, int(sync_step))
        self.state = ACTIVE
        self.restarts += 1

    def close(self) -> None:
        if self.engine is not None:
            self.engine.close()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ReplicaHandle({self.name!r}, state={self.state!r})"


# ---------------------------------------------------------------------------
# static-analysis registration (repro_torch.analysis)
# ---------------------------------------------------------------------------

from repro_torch.analysis import registry as _analysis  # noqa: E402


def _an_cluster_tick_cases(env):
    """The step a cluster tick drives IS its replica engine's base serve
    step — run it through the ReplicaHandle path, so a future
    replica-specific step wrapper cannot dodge the audit. The reference
    builds this engine whenever its ``CaseEnv.heavy`` is set, which is its
    default; the port's every provider builds live engines, so its
    ``CaseEnv`` has no such switch, and the one smoke engine is built on
    every run (a fraction of a second at this size)."""
    handle = ReplicaHandle(
        "analysis", lambda: ServeEngine("yi-6b", num_slots=2, max_len=8,
                                        device=env.device))
    try:
        return handle.engine.analysis_cases("cluster_tick")
    finally:
        handle.close()


_analysis.register("cluster_tick", _an_cluster_tick_cases)
