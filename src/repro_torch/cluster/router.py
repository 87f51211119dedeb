"""Request routing across serve replicas (port of ``repro.cluster.router``;
DESIGN_CLUSTER.md §2).

The router is the OUTER control loop of the nested pair: inside each
replica the SEMI controller migrates/resizes work across TP ranks every
step (paper Eq. 1–3); across replicas the router steers whole requests.
Both loops speak the same telemetry vocabulary — the
:class:`~repro_torch.launch.serve.LoadSnapshot` a replica exposes carries
its χ feed, its ACTIVE plan's retained-work fractions, and the resulting
modeled step time (``ControlPlane.capacity``), so the router prices a
replica at its capacity *after* intra-replica mitigation. A straggling
replica whose SEMI loop already absorbed the imbalance reads near-dense;
only the residual slowdown the inner loop could not hide leaks into the
routing cost.

Policies (pluggable; a policy is a pure ranking function):

* ``round_robin``   — rotate over admitting replicas; load-blind.
* ``least_queue``   — fewest waiting+active requests; χ-blind.
* ``chi_aware``     — the headline policy: estimated completion time of
  the request on each replica, ``step_time_s * (backlog_steps +
  request_cost) / num_slots`` — the replica's plan-adjusted step time
  times the slot-steps ahead of (and including) the request, amortized
  over its decode slots. Deterministic: ties break to the lowest
  replica index.

``route`` walks the ranking and admits on the first replica whose
non-blocking ``try_submit`` accepts — a full/bounded queue falls through
to the next-best replica instead of dropping the request.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.cluster.replica import ReplicaHandle
from repro_torch.launch.serve import LoadSnapshot, Request

POLICIES = ("round_robin", "least_queue", "chi_aware")

#: a candidate is (index in the manager's replica list, handle, snapshot)
Candidate = Tuple[int, ReplicaHandle, LoadSnapshot]
#: policy: (request, candidates) -> candidates ranked best-first
Policy = Callable[[Request, List[Candidate]], List[Candidate]]


def _cost_steps(handle: ReplicaHandle, req: Request) -> int:
    return handle.engine.request_cost_steps(len(req.prompt),
                                            req.max_new_tokens)


def chi_aware_cost(req: Request, cand: Candidate) -> float:
    """Modeled seconds until this replica finishes the request: every
    slot-step owed (its backlog plus this request) priced at the
    replica's plan-adjusted step time, spread over its decode slots."""
    _, handle, snap = cand
    owed = snap.backlog_steps + _cost_steps(handle, req)
    return snap.step_time_s * owed / max(snap.num_slots, 1)


class Router:
    """Pluggable request router over a replica set.

    ``policy`` is one of :data:`POLICIES` or a custom callable
    ``(request, candidates) -> ranked candidates``. The router holds the
    only routing state (the round-robin cursor); everything else reads
    fresh snapshots per decision, so lifecycle changes (drain, fail,
    promote) take effect on the very next request.
    """

    def __init__(self, policy="chi_aware"):
        if callable(policy):
            self.policy_name = getattr(policy, "__name__", "custom")
            self._rank = policy
        else:
            if policy not in POLICIES:
                raise ValueError(
                    f"unknown routing policy {policy!r}; pick one of "
                    f"{POLICIES} or pass a callable")
            self.policy_name = policy
            self._rank = getattr(self, f"_rank_{policy}")
        self._rr = 0                      # round-robin cursor
        self.decisions = 0

    # -- built-in policies (pure rankings, best first) -----------------------
    def _rank_round_robin(self, req: Request,
                          cands: List[Candidate]) -> List[Candidate]:
        k = self._rr % len(cands)
        return cands[k:] + cands[:k]

    def _rank_least_queue(self, req: Request,
                          cands: List[Candidate]) -> List[Candidate]:
        return sorted(cands, key=lambda c: (c[2].queue_depth + c[2].active,
                                            c[0]))

    def _rank_chi_aware(self, req: Request,
                        cands: List[Candidate]) -> List[Candidate]:
        return sorted(cands, key=lambda c: (chi_aware_cost(req, c), c[0]))

    # -- routing -------------------------------------------------------------
    def rank(self, req: Request,
             replicas: Sequence[ReplicaHandle]) -> List[Candidate]:
        """Admitting replicas ranked best-first under the policy."""
        cands = [(i, h, h.snapshot()) for i, h in enumerate(replicas)
                 if h.admitting]
        if not cands:
            return []
        return self._rank(req, cands)

    def route(self, req: Request,
              replicas: Sequence[ReplicaHandle]) -> Optional[ReplicaHandle]:
        """Admit ``req`` on the best replica that will take it.

        Walks the ranking so a refused admission (bounded queue at
        capacity, request too large for that engine) falls through to
        the next-best replica. Returns the admitting handle, or ``None``
        when no replica can take the request right now (the manager
        retries it next cluster step)."""
        ranked = self.rank(req, replicas)
        for _, handle, _ in ranked:
            if handle.try_route(req):
                self.decisions += 1
                if self.policy_name == "round_robin":
                    self._rr += 1
                return handle
        return None
