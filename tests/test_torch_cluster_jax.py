"""The port's multi-replica cluster against the JAX package's, on the CPU.

The reference's end-to-end cluster run (``tests/test_cluster.py``,
``TestClusterE2E``): R = 3 replicas and a warm spare replaying the
committed ``replica_skew`` fixture (W = 4 lanes each; replica 1 carries
two persistent χ = 4 ranks), its first 8 arrivals, SEMI control, a drain
of ``r0`` mid-run, under ``round_robin`` and ``chi_aware``. Both
packages serve the same weights: the JAX replicas build from seed 0, and
the port's load one seed-0 JAX engine's parameters, saved with the JAX
store, through ``ckpt_dir`` (the warm path, which reads either package's
checkpoint). Per policy the route events, owners, tokens, the modeled
stats (``rtol`` 1e-12: copied code) and the recorded R·W-lane cluster
trace must be equal. A fail / restart run and ``FixedBatchEngine`` are
held to the JAX package's the same way.
"""
import collections
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.cluster import ReplicaHandle as JReplicaHandle
from repro.cluster import ReplicaManager as JReplicaManager
from repro.cluster import Router as JRouter
from repro.control import ControlConfig as JControlConfig
from repro.launch.serve import FixedBatchEngine as JFixedBatchEngine
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.telemetry import replica_schedules as j_replica_schedules
from repro_torch.bridge import params_from_jax
from repro_torch.cluster import ReplicaHandle, ReplicaManager, Router
from repro_torch.control import ControlConfig
from repro_torch.launch.serve import FixedBatchEngine, Request, ServeEngine
from repro_torch.telemetry import replica_schedules

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "examples", "traces", "replica_skew.jsonl")
ARCH = "yi-6b"
NUM_SLOTS, MAX_LEN, PREFILL_CHUNK = 4, 16, 2
POLICIES = ("round_robin", "chi_aware")


def _fixture_setup():
    """The reference test's requests: the fixture's first 8 arrivals,
    materialized with its ``SeedSequence((0xC1, 5))``."""
    with open(FIXTURE) as f:
        hdr = json.loads(f.readline())
    R, W = int(hdr["replicas"]), int(hdr["ranks_per_replica"])
    rng = np.random.default_rng(np.random.SeedSequence((0xC1, 5)))
    specs = []
    for uid, step, p, g in hdr["arrivals"]:
        prompt = rng.integers(0, 100, (p,)).astype(np.int32)
        if len(specs) < 8:
            specs.append((int(uid), prompt, int(g), int(step)))
    return R, W, specs


def _requests(cls, specs):
    return [cls(uid=u, prompt=p, max_new_tokens=g, arrival_step=a)
            for u, p, g, a in specs]


def _control(cls, lane, W):
    return cls(mode="semi", hetero_kind="trace", sim_ranks=W,
               trace_in=FIXTURE, trace_rank_offset=lane * W)


def _run(pkg, policy, reqs, R, W, drain_step, ckpt_dir, trace_out):
    """One cluster run in ``pkg`` ("jax" or "torch"), the reference's
    ``TestClusterE2E._run``."""
    if pkg == "jax":
        def factory(lane):
            return lambda: JServeEngine(
                ARCH, num_slots=NUM_SLOTS, max_len=MAX_LEN, seed=0,
                control=_control(JControlConfig, lane, W),
                prefill_chunk=PREFILL_CHUNK)
        handle, manager, router = JReplicaHandle, JReplicaManager, JRouter
    else:
        def factory(lane):
            return lambda: ServeEngine(
                ARCH, num_slots=NUM_SLOTS, max_len=MAX_LEN, seed=0,
                control=_control(ControlConfig, lane, W),
                prefill_chunk=PREFILL_CHUNK, ckpt_dir=ckpt_dir,
                device="cpu")
        handle, manager, router = ReplicaHandle, ReplicaManager, Router
    handles = [handle(f"r{i}", factory(i)) for i in range(R)]
    handles.append(handle("spare", factory(0), spare=True))
    mgr = manager(handles, router(policy), record_trace=trace_out)

    def hook(m):
        if m.cluster_step == drain_step:
            m.drain("r0")

    comps = mgr.run(reqs, on_step=hook)
    out = {"tokens": {c.uid: c.tokens.tolist() for c in comps},
           "uids": [c.uid for c in comps],
           "events": list(mgr.events), "owner": dict(mgr.owner),
           "routed_to": dict(mgr.routed_to), "stats": mgr.stats(),
           "routed": collections.Counter(mgr.routed_to.values()),
           "comps": comps, "trace": trace_out}
    mgr.close()
    return out


@pytest.fixture(scope="module")
def jax_params_dir(tmp_path_factory):
    """One seed-0 JAX engine's parameters, saved with the JAX store."""
    d = str(tmp_path_factory.mktemp("jax_seed0"))
    eng = JServeEngine(ARCH, num_slots=NUM_SLOTS, max_len=MAX_LEN, seed=0)
    jstore.save(d, 1, jax.tree_util.tree_map(np.asarray, eng.params))
    eng.close()
    return d


@pytest.fixture(scope="module")
def runs(jax_params_dir, tmp_path_factory):
    """Both packages, both policies, each run once for the module."""
    R, W, specs = _fixture_setup()
    assert R == 3 and W == 4
    drain_step = max(4, max(a for *_, a in specs) // 2)
    out_dir = tmp_path_factory.mktemp("cluster_traces")
    res = {}
    for policy in POLICIES:
        for pkg, cls in (("jax", JRequest), ("torch", Request)):
            res[pkg, policy] = _run(
                pkg, policy, _requests(cls, specs), R, W, drain_step,
                jax_params_dir, str(out_dir / f"{pkg}_{policy}.jsonl"))
    return R, W, res


@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_events_and_routing_match_jax(runs, policy):
    _, _, res = runs
    j, t = res["jax", policy], res["torch", policy]
    assert t["uids"] == sorted(t["tokens"]) == j["uids"]
    # route decisions (uid, replica, policy, step), drain and promotion
    assert t["events"] == j["events"]
    kinds = [e["kind"] for e in t["events"] if e["kind"] != "route"]
    assert kinds == ["drain", "promote"]
    assert t["owner"] == j["owner"]
    assert t["routed_to"] == j["routed_to"]


@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_tokens_match_jax_and_the_oracle(runs, jax_params_dir,
                                                 policy):
    _, _, res = runs
    j, t = res["jax", policy], res["torch", policy]
    assert t["tokens"] == j["tokens"]
    assert t["stats"]["duplicates"] == 0 == j["stats"]["duplicates"]
    # zero-drop through the drain and promotion, token-exact against a
    # lone fixed-batch run of the same weights
    base = FixedBatchEngine(ARCH, batch=1, max_len=MAX_LEN,
                            ckpt_dir=jax_params_dir, device="cpu")
    for c in t["comps"]:
        ref = base.generate(c.prompt[None], len(c.tokens))[0, len(c.prompt):]
        np.testing.assert_array_equal(c.tokens, ref, err_msg=str(c.uid))


@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_modeled_stats_match_jax(runs, policy):
    _, _, res = runs
    j, t = res["jax", policy]["stats"], res["torch", policy]["stats"]
    assert set(t) == set(j)
    for k in j:
        if isinstance(j[k], float):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-12, err_msg=k)
        else:
            assert t[k] == j[k], k


@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_trace_matches_jax(runs, policy):
    R, W, res = runs
    paths = [res[pkg, policy]["trace"] for pkg in ("jax", "torch")]
    lines = []
    for p in paths:
        with open(p) as f:
            lines.append([json.loads(ln) for ln in f])
    (jh, *js), (th, *ts) = lines
    assert th == jh
    # R replicas and the spare, W lanes each
    assert th["replicas"] == R + 1 and th["ranks_per_replica"] == W
    assert len(ts) == len(js) > 0
    for a, b in zip(ts, js):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["rank_times"], b["rank_times"],
                                   rtol=1e-12)
        assert a["work_frac"] == b["work_frac"]
    # the one-JSONL cluster replay splits into R + 1 per-replica schedules
    ts_, js_ = replica_schedules(paths[1]), j_replica_schedules(paths[0])
    assert len(ts_) == len(js_) == R + 1
    assert all(s.kind == "trace" and s.num_ranks == W for s in ts_)
    for a, b in zip(ts_, js_):
        np.testing.assert_allclose(a.chi(0), b.chi(0), rtol=1e-12)
    # the contended replica's lanes carry its raw (pre-mitigation) χ
    np.testing.assert_allclose(ts_[1].chi(0)[:2], [4.0, 4.0], rtol=0.1)
    np.testing.assert_allclose(ts_[1].chi(0)[2:], [1.0, 1.0], rtol=0.1)


def test_chi_aware_beats_round_robin(runs):
    """The reference's headline on the port alone: pricing against the
    plan-adjusted residual capacity beats load-blind rotation under
    persistent replica skew (modeled latencies) and avoids ``r1``."""
    _, _, res = runs
    rr, ca = res["torch", "round_robin"], res["torch", "chi_aware"]
    assert ca["stats"]["p95_ms"] < rr["stats"]["p95_ms"]
    assert ca["stats"]["ttft_mean_ms"] < rr["stats"]["ttft_mean_ms"]
    assert ca["routed"].get("r1", 0) < rr["routed"]["r1"]


def test_fail_and_restart_match_jax(jax_params_dir):
    """R = 2 one-slot replicas, control off: ``r0`` fails at step 2 and is
    rebuilt at step 5 (the reference's ``test_restart_rejoins_and_serves``);
    events and tokens equal in both packages."""
    specs = [(4, 4, 0), (4, 4, 0), (4, 4, 6), (4, 4, 6)]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (p,)).astype(np.int32)
               for p, _, _ in specs]
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            handles = [JReplicaHandle(f"r{i}", lambda: JServeEngine(
                ARCH, num_slots=1, max_len=16, seed=0)) for i in range(2)]
            mgr = JReplicaManager(handles, JRouter("round_robin"))
            cls = JRequest
        else:
            handles = [ReplicaHandle(f"r{i}", lambda: ServeEngine(
                ARCH, num_slots=1, max_len=16, seed=0,
                ckpt_dir=jax_params_dir, device="cpu")) for i in range(2)]
            mgr = ReplicaManager(handles, Router("round_robin"))
            cls = Request
        reqs = [cls(uid=i, prompt=p, max_new_tokens=g, arrival_step=a)
                for i, (p, (_, g, a)) in enumerate(zip(prompts, specs))]

        def hook(m):
            if m.cluster_step == 2:
                m.fail("r0", promote_spare=False)
            if m.cluster_step == 5:
                m.restart("r0")

        comps = mgr.run(reqs, on_step=hook)
        out[pkg] = ({c.uid: c.tokens.tolist() for c in comps},
                    list(mgr.events), dict(mgr.owner),
                    mgr.duplicate_completions, mgr.reassigned)
        assert handles[0].restarts == 1
        mgr.close()
    assert out["torch"] == out["jax"]
    kinds = [e["kind"] for e in out["torch"][1] if e["kind"] != "route"]
    assert kinds == ["fail", "restart"]
    assert out["torch"][4] > 0 and "r0" in set(out["torch"][2].values())


@pytest.mark.parametrize("eos", [False, True])
def test_fixed_batch_generate_matches_jax(eos):
    jfb = JFixedBatchEngine(ARCH, batch=2, max_len=16, seed=0)
    tfb = FixedBatchEngine(ARCH, batch=2, max_len=16, seed=0, device="cpu")
    tfb.params = params_from_jax(jax.tree.map(np.asarray, jfb.params),
                                 tfb.cfg, device="cpu")
    prompts = np.random.default_rng(4).integers(
        0, tfb.cfg.vocab_size, (2, 5)).astype(np.int32)
    eos_id = None
    if eos:
        # a token row 0 emits mid-way: that row stops there, row 1 runs on
        free = jfb.generate(prompts, 8)
        eos_id = int(free[0, 5 + 3])
    j = jfb.generate(prompts, 8, eos_id=eos_id)
    t = tfb.generate(prompts, 8, eos_id=eos_id)
    np.testing.assert_array_equal(t, j)
    if eos:
        assert (t[0, 5 + 3:] == eos_id).all()
