"""Multi-replica serving cluster (port of ``repro.cluster``;
DESIGN_CLUSTER.md).

The paper's SEMI loop balances work *within* one TP group; this package
adds the loop *around* it — straggler-aware routing across R serve
replicas, sharing the same χ/plan/capacity telemetry vocabulary:

* :class:`ReplicaHandle` — one ServeEngine + lifecycle state machine
  (SPARE / ACTIVE / DRAINING / DRAINED / FAILED).
* :class:`Router` — pluggable policies: ``round_robin``,
  ``least_queue``, and the headline ``chi_aware`` (prices a request
  against each replica's plan-adjusted residual capacity).
* :class:`ReplicaManager` — lockstep cluster driver: deterministic
  tick interleaving, drain + warm-spare promotion, fail + zero-drop
  request reassignment, one replayable R·W-lane cluster trace.

Over the port's ``ServeEngine``: each engine keeps the device its
factory gives it, and a failed replica's engine leaves the device.
"""
from repro_torch.cluster.manager import ReplicaManager
from repro_torch.cluster.replica import (ACTIVE, DRAINED, DRAINING,
                                         FAILED, SPARE, ReplicaHandle)
from repro_torch.cluster.router import POLICIES, Router, chi_aware_cost

__all__ = [
    "ReplicaHandle", "ReplicaManager", "Router", "POLICIES",
    "chi_aware_cost", "SPARE", "ACTIVE", "DRAINING", "DRAINED", "FAILED",
]
