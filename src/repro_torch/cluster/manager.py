"""ReplicaManager: lockstep multi-replica serving with lifecycle +
zero-drop reassignment (port of ``repro.cluster.manager``;
DESIGN_CLUSTER.md §3).

One host loop drives R serve engines deterministically: each *cluster
step* routes newly eligible requests, then ticks every replica exactly
once (``ServeEngine.tick`` — a replica with nothing admissible takes an
idle tick that advances its step counter but not its modeled clock, so
χ-schedule lanes stay aligned with the cluster step across replicas
while latencies remain honest durations).

Zero-drop invariant: every submitted request produces exactly one
completion, token-exact regardless of drains, failures, or promotions.
It holds because

* drain/fail return the incomplete requests (queued, and for fail also
  in-flight) and the manager re-routes them with priority over fresh
  arrivals;
* completed uids are excluded from fail-reassignment, and harvest
  dedupes by uid (``duplicate_completions`` counts violations — pinned
  to zero by tests);
* greedy decode is deterministic, so a request re-run from scratch on
  another replica regenerates its exact tokens.

``record_trace`` writes ONE R·W-lane telemetry JSONL for the whole
cluster (header tagged ``{"replicas": R, "ranks_per_replica": W}``), so
a cluster run replays from one trace set via
:func:`repro_torch.telemetry.replica_schedules`.

Latencies, makespan and scores are MODELED from each engine's iteration
model (a host-CPU calibration), as in the reference; they are never a
device time. The replicas tick in turn on one host thread.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.replica import (ACTIVE, DRAINING, SPARE,
                                         ReplicaHandle)
from repro_torch.cluster.router import Router
from repro_torch.launch.serve import Completion, Request, latency_percentiles
from repro_torch.telemetry import StepSample, TraceWriter


class ReplicaManager:
    """Cluster of :class:`ReplicaHandle`\\ s behind one :class:`Router`."""

    def __init__(self, replicas: Sequence[ReplicaHandle],
                 router: Optional[Router] = None, *,
                 record_trace: Optional[str] = None):
        names = [h.name for h in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.replicas: List[ReplicaHandle] = list(replicas)
        self.by_name: Dict[str, ReplicaHandle] = {h.name: h
                                                  for h in self.replicas}
        self.router = router or Router()
        self.cluster_step = 0
        # cluster-level admission: `pending` holds not-yet-eligible /
        # not-yet-routable fresh arrivals (FIFO by arrival step);
        # `_reassign` holds drain/fail evictees, served FIRST — they
        # already waited once.
        self.pending: collections.deque = collections.deque()
        self._reassign: collections.deque = collections.deque()
        self.completions: Dict[int, Completion] = {}
        self.owner: Dict[int, str] = {}       # uid -> completing replica
        self.routed_to: Dict[int, str] = {}   # uid -> last routed replica
        self.duplicate_completions = 0
        self.reassigned = 0
        self.events: List[dict] = []
        self._writer: Optional[TraceWriter] = None
        self._trace_path = record_trace

    # -- submission ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request at cluster level; it is routed once its
        ``arrival_step`` (in CLUSTER steps) has passed and a replica can
        take it."""
        self.pending.append(req)

    def _route_one(self, req: Request) -> bool:
        handle = self.router.route(req, self.replicas)
        if handle is None:
            return False
        self.routed_to[req.uid] = handle.name
        self.events.append({"step": self.cluster_step, "kind": "route",
                            "uid": req.uid, "replica": handle.name,
                            "policy": self.router.policy_name})
        return True

    # -- the lockstep cluster step -------------------------------------------
    def step(self) -> None:
        """One cluster step: route, tick every replica once, harvest."""
        # reassigned requests first (priority — they were already queued
        # once); unroutable ones stay for the next step
        if self._reassign:
            stuck = collections.deque()
            while self._reassign:
                req = self._reassign.popleft()
                if not self._route_one(req):
                    stuck.append(req)
            self._reassign = stuck
        # then newly eligible fresh arrivals, in FIFO order — a blocked
        # head blocks the tail (arrival order is part of determinism)
        while self.pending \
                and self.pending[0].arrival_step <= self.cluster_step:
            if not self._route_one(self.pending[0]):
                break
            self.pending.popleft()

        for h in self.replicas:
            h.tick()

        for h in self.replicas:
            for c in h.harvest():
                if c.uid in self.completions:
                    self.duplicate_completions += 1
                    continue
                self.completions[c.uid] = c
                self.owner[c.uid] = h.name

        if self._trace_path is not None:
            self._record_sample()
        self.cluster_step += 1

    def busy(self) -> bool:
        """Any work left anywhere in the cluster?"""
        if self.pending or self._reassign:
            return True
        return any(h.state in (ACTIVE, DRAINING) and h.engine is not None
                   and not h.engine.idle for h in self.replicas)

    def run(self, requests: Sequence[Request],
            max_steps: Optional[int] = None,
            on_step: Optional[Callable[["ReplicaManager"], None]] = None,
            ) -> List[Completion]:
        """Drive the cluster until every request completes.

        ``on_step(manager)`` fires at the START of each cluster step —
        the hook benchmarks/tests use to inject drains, failures, and
        promotions mid-run at a deterministic step."""
        for r in sorted(requests, key=lambda r: (r.arrival_step, r.uid)):
            self.submit(r)
        horizon = max((r.arrival_step for r in requests), default=0)
        per_req = max((h.engine.max_len for h in self.replicas
                       if h.engine is not None), default=64)
        limit = max_steps or (horizon + per_req * (len(requests) + 2))
        while self.busy():
            if self.cluster_step >= limit:
                raise RuntimeError(
                    f"cluster loop exceeded {limit} steps with "
                    f"{len(self.pending)} pending / {len(self._reassign)} "
                    "reassigned requests unplaced — is every replica "
                    "drained or failed?")
            if on_step is not None:
                on_step(self)
            self.step()
        self.close_trace()
        return sorted(self.completions.values(), key=lambda c: c.uid)

    # -- lifecycle -----------------------------------------------------------
    def drain(self, name: str, promote_spare: bool = True) -> List[Request]:
        """Stop admission on ``name``; its queued requests are re-routed
        (priority), in-flight slots finish where they are. Optionally
        promotes a warm spare to replace the lost capacity."""
        h = self.by_name[name]
        evicted = h.begin_drain()
        self._reassign.extend(evicted)
        self.reassigned += len(evicted)
        self.events.append({"step": self.cluster_step, "kind": "drain",
                            "replica": name, "evicted": len(evicted)})
        if promote_spare:
            self.promote_spare()
        return evicted

    def fail(self, name: str, promote_spare: bool = True) -> List[Request]:
        """Simulated replica loss: completions finished before the
        failure are harvested first (they happened), every INCOMPLETE
        request — in-flight and queued — is re-routed with priority."""
        h = self.by_name[name]
        for c in h.harvest():             # keep work that already finished
            if c.uid in self.completions:
                self.duplicate_completions += 1
                continue
            self.completions[c.uid] = c
            self.owner[c.uid] = h.name
        lost = [r for r in h.fail() if r.uid not in self.completions]
        self._reassign.extend(lost)
        self.reassigned += len(lost)
        self.events.append({"step": self.cluster_step, "kind": "fail",
                            "replica": name, "reassigned": len(lost)})
        if promote_spare:
            self.promote_spare()
        return lost

    def promote_spare(self) -> Optional[str]:
        """Promote the first warm spare (list order) to ACTIVE; returns
        its name, or ``None`` when no spare is available."""
        for h in self.replicas:
            if h.state == SPARE:
                h.promote()
                self.events.append({"step": self.cluster_step,
                                    "kind": "promote", "replica": h.name})
                return h.name
        return None

    def restart(self, name: str) -> None:
        """Rebuild a FAILED/DRAINED replica from its factory (latest
        checkpoint) and rejoin it at the current cluster step."""
        self.by_name[name].restart(sync_step=self.cluster_step)
        self.events.append({"step": self.cluster_step, "kind": "restart",
                            "replica": name})

    # -- aggregate stats -----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Cluster-level latency/TTFT percentiles over ALL completions,
        with throughput over the cluster makespan (slowest replica's
        modeled clock — replicas run concurrently). MODELED, from the
        iteration model: no number here is a device time."""
        comps = sorted(self.completions.values(), key=lambda c: c.uid)
        makespan = max((h.engine.clock for h in self.replicas
                        if h.engine is not None), default=0.0)
        out = latency_percentiles(comps,
                                  total_time_s=makespan or None)
        out["makespan_s"] = float(makespan)
        out["reassigned"] = self.reassigned
        out["duplicates"] = self.duplicate_completions
        return out

    def scores(self) -> Dict[str, float]:
        """Per-replica effective-throughput scores (live replicas;
        modeled, as :meth:`ReplicaHandle.score`)."""
        return {h.name: h.score() for h in self.replicas
                if h.engine is not None}

    # -- cluster trace recording ---------------------------------------------
    def _record_sample(self) -> None:
        """Append one R·W-lane sample: each live replica's current χ feed
        priced through ITS iteration model at full work (the RAW
        heterogeneity, like the fixture generator writes, so replay
        inverts χ exactly); a failed/closed replica records dense lanes
        (χ=1) — it has no feed, and replay should not invent contention.
        """
        per = [h.engine.sim_ranks for h in self.replicas
               if h.engine is not None]
        if not per:
            return
        W = per[0]
        if any(w != W for w in per):
            raise ValueError(
                f"cluster trace needs a uniform TP width; got {per}")
        if self._writer is None:
            ref = next(h.engine for h in self.replicas
                       if h.engine is not None)
            self._writer = TraceWriter(
                self._trace_path, num_ranks=len(self.replicas) * W,
                matmul_time=ref.it_model.matmul_time,
                other_time=ref.it_model.other_time,
                # the reference's header, "source" included: one trace
                # format that either package's replay reads
                meta={"replicas": len(self.replicas),
                      "ranks_per_replica": W,
                      "source": "repro.cluster.ReplicaManager",
                      "policy": self.router.policy_name})
        ones = np.ones(W)
        rows = []
        for h in self.replicas:
            if h.engine is None:
                rows.append(ones * self._ref_times(ones))
            else:
                chi = h.engine.plane.chi_feed(h.engine.step_count)
                rows.append(h.engine.it_model.times(chi, ones))
        self._writer.append(StepSample(
            step=self.cluster_step,
            rank_times=np.concatenate(rows),
            work_frac=np.ones(len(self.replicas) * W)))

    def _ref_times(self, ones: np.ndarray) -> np.ndarray:
        ref = next(h.engine for h in self.replicas if h.engine is not None)
        return ref.it_model.times(ones, ones)

    def close_trace(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def close(self) -> None:
        """Close every live engine (flushes per-replica traces) and the
        cluster trace."""
        for h in self.replicas:
            h.close()
        self.close_trace()
