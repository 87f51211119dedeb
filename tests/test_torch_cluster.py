"""The port's multi-replica cluster (``repro_torch.cluster``) on the CPU.

The reference's router, lifecycle and manager tests
(``tests/test_cluster.py``), one for one, over the port's classes at
smoke width with ``device="cpu"``; completions are held token for token
against the port's ``FixedBatchEngine``. Beside them, what is the port's
own: a failed replica's engine is unreachable once ``fail()`` returns,
and importing the package (and the analyzer's providers) loads no
``jax`` and nothing of the JAX package.
"""
import gc
import json
import os
import subprocess
import sys
import types
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import store
from repro_torch.cluster import (ACTIVE, DRAINED, DRAINING, FAILED, POLICIES,
                                 SPARE, ReplicaHandle, ReplicaManager, Router,
                                 chi_aware_cost)
from repro_torch.control import ControlConfig
from repro_torch.launch.serve import (FixedBatchEngine, LoadSnapshot, Request,
                                      ServeEngine)

torch.set_num_threads(1)

ARCH = "yi-6b"
SRC = str(Path(__file__).resolve().parents[1] / "src")


def _mk_requests(vocab, specs, seed=0):
    """specs: list of (prompt_len, gen_len, arrival_step)."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                    max_new_tokens=g, arrival_step=a)
            for i, (p, g, a) in enumerate(specs)]


def _factory(num_slots=2, max_len=12, control=None, **kw):
    def build():
        return ServeEngine(ARCH, num_slots=num_slots, max_len=max_len,
                           seed=0, control=control or ControlConfig(),
                           device="cpu", **kw)
    return build


def _assert_token_exact(engine_max_len, completions, seed=0):
    base = FixedBatchEngine(ARCH, batch=1, max_len=engine_max_len,
                            seed=seed, device="cpu")
    for c in completions:
        seq = base.generate(c.prompt[None], len(c.tokens))
        ref = seq[0, len(c.prompt):]
        np.testing.assert_array_equal(
            c.tokens, ref,
            err_msg=f"request {c.uid} diverged after cluster routing")


# ---------------------------------------------------------------------------
# Router policies — pure ranking math over synthetic snapshots (no engines)
# ---------------------------------------------------------------------------


def _snap(step_time_s=1.0, backlog_steps=0, queue_depth=0, active=0,
          num_slots=2):
    return LoadSnapshot(step=0, clock=0.0, queue_depth=queue_depth,
                        active=active, free_slots=num_slots - active,
                        free_pages=None, num_slots=num_slots,
                        chi=np.ones(4), work_frac=np.ones(4),
                        step_time_s=step_time_s, dense_step_time_s=1.0,
                        backlog_steps=backlog_steps)


class _FakeHandle:
    """Routing-interface stub: fixed snapshot + scripted admission."""

    def __init__(self, name, snap, accept=True, cost_steps=5):
        self.name = name
        self.state = ACTIVE
        self._snap = snap
        self._accept = accept
        self.admitted = []
        self.engine = types.SimpleNamespace(
            request_cost_steps=lambda p, g: cost_steps)

    @property
    def admitting(self):
        return self.state == ACTIVE

    def snapshot(self):
        return self._snap

    def try_route(self, req):
        if self._accept:
            self.admitted.append(req.uid)
        return self._accept


def _req(uid=0, arrival=0):
    return Request(uid=uid, prompt=np.zeros(4, np.int32),
                   max_new_tokens=4, arrival_step=arrival)


class TestRouterPolicies:
    def test_chi_aware_cost_formula(self):
        """cost = step_time * (backlog + request_cost) / num_slots."""
        h = _FakeHandle("r0", _snap(step_time_s=2.0, backlog_steps=3,
                                    num_slots=2), cost_steps=5)
        assert chi_aware_cost(_req(), (0, h, h.snapshot())) == \
            pytest.approx(2.0 * (3 + 5) / 2)

    def test_chi_aware_prefers_residual_capacity(self):
        slow = _FakeHandle("slow", _snap(step_time_s=2.0))
        fast = _FakeHandle("fast", _snap(step_time_s=1.0))
        r = Router("chi_aware")
        ranked = r.rank(_req(), [slow, fast])
        assert [h.name for _, h, _ in ranked] == ["fast", "slow"]
        # saturate the fast replica: 2x step time < 12-step backlog
        busy = _FakeHandle("fast", _snap(step_time_s=1.0, backlog_steps=12))
        ranked = r.rank(_req(), [slow, busy])
        assert [h.name for _, h, _ in ranked] == ["slow", "fast"]

    def test_chi_aware_tie_breaks_lowest_index(self):
        hs = [_FakeHandle(f"r{i}", _snap()) for i in range(3)]
        ranked = Router("chi_aware").rank(_req(), hs)
        assert [i for i, _, _ in ranked] == [0, 1, 2]

    def test_least_queue_counts_waiting_plus_active(self):
        a = _FakeHandle("a", _snap(queue_depth=2, active=0))
        b = _FakeHandle("b", _snap(queue_depth=0, active=1))
        ranked = Router("least_queue").rank(_req(), [a, b])
        assert [h.name for _, h, _ in ranked] == ["b", "a"]
        # a tie breaks to the lowest replica index
        c = _FakeHandle("c", _snap(queue_depth=1, active=0))
        ranked = Router("least_queue").rank(_req(), [c, b])
        assert [h.name for _, h, _ in ranked] == ["c", "b"]

    def test_round_robin_rotates_only_on_success(self):
        hs = [_FakeHandle(f"r{i}", _snap()) for i in range(3)]
        r = Router("round_robin")
        names = [r.route(_req(uid=u), hs).name for u in range(4)]
        assert names == ["r0", "r1", "r2", "r0"]
        # a refused round does NOT advance the cursor
        for h in hs:
            h._accept = False
        assert r.route(_req(uid=9), hs) is None
        for h in hs:
            h._accept = True
        assert r.route(_req(uid=10), hs).name == "r1"
        assert r.decisions == 5

    def test_route_falls_through_refused_admission(self):
        best = _FakeHandle("best", _snap(step_time_s=1.0), accept=False)
        worse = _FakeHandle("worse", _snap(step_time_s=2.0))
        got = Router("chi_aware").route(_req(uid=7), [best, worse])
        assert got is worse and worse.admitted == [7]

    def test_non_admitting_replicas_are_invisible(self):
        h0 = _FakeHandle("r0", _snap())
        h1 = _FakeHandle("r1", _snap())
        h0.state = DRAINING
        ranked = Router("chi_aware").rank(_req(), [h0, h1])
        assert [h.name for _, h, _ in ranked] == ["r1"]
        h1.state = FAILED
        assert Router("chi_aware").rank(_req(), [h0, h1]) == []
        assert Router("chi_aware").route(_req(), [h0, h1]) is None

    def test_unknown_policy_rejected(self):
        with pytest.raises(ValueError, match="unknown routing policy"):
            Router("fastest_first")
        assert set(POLICIES) == {"round_robin", "least_queue", "chi_aware"}

    def test_custom_callable_policy(self):
        def reverse(req, cands):
            return list(reversed(cands))
        hs = [_FakeHandle(f"r{i}", _snap()) for i in range(2)]
        r = Router(reverse)
        assert r.policy_name == "reverse"
        assert r.route(_req(), hs).name == "r1"


# ---------------------------------------------------------------------------
# ReplicaHandle lifecycle state machine (real engines, control off)
# ---------------------------------------------------------------------------


class TestReplicaLifecycle:
    def test_spare_ticks_idle_but_does_not_admit(self):
        h = ReplicaHandle("s", _factory(), spare=True)
        assert h.state == SPARE and not h.admitting
        assert not h.try_route(_req())
        before = h.engine.step_count
        h.tick()
        # the idle tick keeps the χ-schedule lane cluster-aligned ...
        assert h.engine.step_count == before + 1
        # ... without burning modeled time
        assert h.engine.clock == 0.0
        h.promote()
        assert h.state == ACTIVE and h.admitting
        h.close()

    def test_invalid_transitions_raise(self):
        h = ReplicaHandle("r", _factory())
        with pytest.raises(ValueError, match="only a SPARE"):
            h.promote()                      # ACTIVE -> promote
        with pytest.raises(ValueError, match="restart"):
            h.restart()                      # ACTIVE -> restart
        h.fail()
        with pytest.raises(ValueError, match="begin_drain"):
            h.begin_drain()                  # FAILED -> drain
        with pytest.raises(RuntimeError, match="failed"):
            h.snapshot()                     # FAILED has no engine
        h.close()

    def test_drain_finishes_inflight_and_returns_queue(self):
        h = ReplicaHandle("r", _factory(num_slots=1))
        reqs = _mk_requests(h.engine.cfg.vocab_size, [(3, 3, 0), (3, 3, 0)])
        assert h.try_route(reqs[0]) and h.try_route(reqs[1])
        h.tick()                             # admit req 0; req 1 queued
        evicted = h.begin_drain()
        assert [r.uid for r in evicted] == [1]
        assert h.state == DRAINING and not h.admitting
        for _ in range(10):
            if h.state == DRAINED:
                break
            h.tick()
        assert h.state == DRAINED
        # the in-flight request FINISHED on the draining replica
        assert [c.uid for c in h.harvest()] == [0]
        h.close()

    def test_fail_returns_incomplete_work_and_restart_rejoins(self):
        h = ReplicaHandle("r", _factory(num_slots=1))
        reqs = _mk_requests(h.engine.cfg.vocab_size, [(3, 3, 0), (3, 3, 0)])
        h.try_route(reqs[0]), h.try_route(reqs[1])
        h.tick()
        lost = h.fail()
        # in-flight first (admission order), then the queue; engine gone
        assert [r.uid for r in lost] == [0, 1]
        assert h.state == FAILED and h.engine is None
        assert h.harvest() == [] and h.fail() == []
        h.restart(sync_step=17)
        assert h.state == ACTIVE and h.restarts == 1
        # the rebuilt engine rejoined the cluster time base
        assert h.engine.step_count == 17
        h.close()

    def test_fail_releases_the_engine(self):
        """The port's own: an engine is a reference cycle (its control
        plane closes over it), and fail() collects it before returning —
        on a card, its parameters and cache leave the device there."""
        h = ReplicaHandle("r", _factory(num_slots=1))
        reqs = _mk_requests(h.engine.cfg.vocab_size, [(3, 3, 0)])
        assert h.try_route(reqs[0])
        h.tick()
        gc.disable()                 # only fail() may collect the cycle
        try:
            ref = weakref.ref(h.engine)
            params = weakref.ref(h.engine.params)
            assert [r.uid for r in h.fail()] == [0]
            assert ref() is None and params() is None
        finally:
            gc.enable()
        # the factory builds a fresh engine on restart
        h.restart()
        assert h.engine is not None and h.engine.step_count == 0
        h.close()


# ---------------------------------------------------------------------------
# ReplicaManager: lockstep driving + zero-drop reassignment
# ---------------------------------------------------------------------------


class TestReplicaManager:
    def test_duplicate_names_rejected(self):
        hs = [ReplicaHandle("r", _factory()) for _ in range(2)]
        with pytest.raises(ValueError, match="duplicate"):
            ReplicaManager(hs)
        for h in hs:
            h.close()

    def test_fail_midrun_zero_drop_zero_dup_token_exact(self):
        hs = [ReplicaHandle(f"r{i}", _factory(num_slots=1, max_len=16))
              for i in range(2)]
        mgr = ReplicaManager(hs, Router("round_robin"))
        reqs = _mk_requests(hs[0].engine.cfg.vocab_size,
                            [(4, 6, 0), (4, 6, 0), (4, 6, 1), (4, 6, 1)])

        def hook(m):
            if m.cluster_step == 3:
                m.fail("r0", promote_spare=False)

        comps = mgr.run(reqs, on_step=hook)
        assert [c.uid for c in comps] == [0, 1, 2, 3]
        assert mgr.duplicate_completions == 0
        assert mgr.reassigned > 0
        assert any(e["kind"] == "fail" for e in mgr.events)
        # the failed replica's survivors finished on r1
        assert all(mgr.owner[uid] == "r1" for uid in mgr.owner)
        _assert_token_exact(16, comps)
        mgr.close()

    def test_drain_promotes_spare_and_inflight_finishes_in_place(self):
        hs = [ReplicaHandle("r0", _factory(num_slots=1, max_len=16)),
              ReplicaHandle("spare", _factory(num_slots=1, max_len=16),
                            spare=True)]
        mgr = ReplicaManager(hs, Router("least_queue"))
        reqs = _mk_requests(hs[0].engine.cfg.vocab_size,
                            [(4, 5, 0), (4, 5, 0), (4, 5, 2)])

        def hook(m):
            if m.cluster_step == 2:
                m.drain("r0")

        comps = mgr.run(reqs, on_step=hook)
        assert [c.uid for c in comps] == [0, 1, 2]
        kinds = [e["kind"] for e in mgr.events if e["kind"] != "route"]
        assert kinds == ["drain", "promote"]
        assert hs[0].state == DRAINED and hs[1].state == ACTIVE
        # request 0 was in-flight on r0 at the drain: it finished THERE
        assert mgr.owner[0] == "r0"
        # evicted/later requests ran on the promoted spare
        assert {mgr.owner[1], mgr.owner[2]} == {"spare"}
        assert mgr.duplicate_completions == 0
        _assert_token_exact(16, comps)
        mgr.close()

    def test_restart_rejoins_and_serves(self):
        hs = [ReplicaHandle(f"r{i}", _factory(num_slots=1, max_len=16))
              for i in range(2)]
        mgr = ReplicaManager(hs, Router("round_robin"))
        reqs = _mk_requests(hs[0].engine.cfg.vocab_size,
                            [(4, 4, 0), (4, 4, 0), (4, 4, 6), (4, 4, 6)])

        def hook(m):
            if m.cluster_step == 2:
                m.fail("r0", promote_spare=False)
            if m.cluster_step == 5:
                m.restart("r0")

        comps = mgr.run(reqs, on_step=hook)
        assert len(comps) == 4 and mgr.duplicate_completions == 0
        assert hs[0].restarts == 1
        assert hs[0].engine.step_count >= 5        # rejoined the time base
        # the restarted replica served some of the later arrivals
        assert "r0" in set(mgr.owner.values())
        _assert_token_exact(16, comps)
        mgr.close()

    def test_all_replicas_down_raises_instead_of_spinning(self):
        h = ReplicaHandle("r0", _factory())
        mgr = ReplicaManager([h])
        reqs = _mk_requests(h.engine.cfg.vocab_size, [(3, 3, 0)])

        def hook(m):
            if m.cluster_step == 0:
                m.fail("r0", promote_spare=False)

        with pytest.raises(RuntimeError, match="unplaced"):
            mgr.run(reqs, max_steps=8, on_step=hook)
        mgr.close()

    def test_warm_spare_serves_checkpoint_params(self, tmp_path):
        """A spare built against a checkpoint directory (written by the
        port's store from a seed-7 engine) decodes with the CHECKPOINTED
        params, not its seed-0 init; promotion itself touches no disk."""
        d = str(tmp_path)
        donor = ServeEngine(ARCH, num_slots=1, max_len=16, seed=7,
                            device="cpu")
        store.save(d, 3, bridge.params_to_numpy(donor.params))

        def build():
            return ServeEngine(ARCH, num_slots=1, max_len=16, seed=0,
                               ckpt_dir=d, device="cpu")
        hs = [ReplicaHandle("r0", _factory(num_slots=1, max_len=16)),
              ReplicaHandle("spare", build, spare=True)]
        mgr = ReplicaManager(hs, Router("round_robin"))
        reqs = _mk_requests(donor.cfg.vocab_size, [(4, 5, 0), (4, 5, 2)])

        def hook(m):
            if m.cluster_step == 1:
                m.drain("r0")          # promotes the spare

        comps = mgr.run(reqs, on_step=hook)
        assert [c.uid for c in comps] == [0, 1]
        assert mgr.owner[1] == "spare"
        c1 = mgr.completions[1]
        _assert_token_exact(16, [c1], seed=7)
        # the discriminating half: seed-0 init params decode DIFFERENTLY,
        # so matching the donor proves the checkpoint actually loaded
        alt = FixedBatchEngine(ARCH, batch=1, max_len=16, seed=0,
                               device="cpu")
        alt_ref = alt.generate(c1.prompt[None], len(c1.tokens))[
            0, len(c1.prompt):]
        assert not np.array_equal(c1.tokens, alt_ref)
        mgr.close()
        donor.close()

    def test_stats_empty_cluster_is_well_defined(self):
        h = ReplicaHandle("r0", _factory())
        mgr = ReplicaManager([h])
        s = mgr.stats()
        assert s["requests"] == 0 and s["tokens"] == 0
        assert s["p95_ms"] == 0.0 and s["duplicates"] == 0
        assert mgr.scores()["r0"] > 0
        mgr.close()


# ---------------------------------------------------------------------------
# FixedBatchEngine (the token oracle above) and the port's own contracts
# ---------------------------------------------------------------------------


def test_fixed_batch_engine_matches_serve_engine_weights():
    """Same seed, config and dtype: bit-identical weights, so the oracle
    and a replica decode the same function."""
    fb = FixedBatchEngine(ARCH, batch=2, max_len=12, seed=3, device="cpu")
    se = ServeEngine(ARCH, num_slots=2, max_len=12, seed=3, device="cpu")
    for (na, a), (nb, b) in zip(fb.params.named_parameters(),
                                se.params.named_parameters()):
        assert na == nb and torch.equal(a, b), na
    se.close()
    with pytest.raises(ValueError, match="do not fit"):
        fb.generate(np.zeros((2, 8), np.int32), 5)
    out = fb.generate(np.ones((2, 3), np.int32), 4)
    assert out.shape == (2, 7) and (out[:, :3] == 1).all()


def test_fixed_batch_engine_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FixedBatchEngine(ARCH, batch=1, max_len=8)


def test_cluster_imports_neither_jax_nor_repro():
    code = ("import sys, json\n"
            "import repro_torch.cluster\n"
            "import repro_torch.analysis as an\n"
            "names = an.load_providers()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(json.dumps([bad, names]))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": SRC})
    bad, names = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    assert "cluster_tick" in names
