"""Tests of the port's static analyzer (``repro_torch.analysis``), the
counterparts of ``tests/test_analysis.py``: known-good / known-bad
fixtures per rule R1–R5, the engine's failure handling, registry
completeness against the reference's step list, and the gate itself
(``--check --mutate`` on the CPU, every mutant firing).

Each counterpart holds to what its reference test's name and docstring
state. The reference tests ``test_r3_grouped_psum_jaxpr_counting``,
``test_r5_fires_on_f64_jaxpr`` and ``test_mutate_mode_every_rule_fires``
are not oracles (ROADMAP.md, queue C); their counterparts here are
``test_r3_grouped_bcast_counting``, ``test_r5_fires_on_f64_op`` and
``test_mutate_mode_every_rule_fires``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import engine, rules, smem
from repro_torch.analysis.engine import lint, trace_artifact
from repro_torch.analysis.registry import Artifact, CaseEnv, TraceCase
from repro_torch.kernels.build import Launch

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
CPU = CaseEnv(device="cpu")


def _case(**kw):
    kw.setdefault("step", "t")
    kw.setdefault("name", "c")
    kw.setdefault("fn", lambda: None)
    kw.setdefault("args", ())
    return TraceCase(**kw)


def _rules_fired(arts, rule_id):
    return [v for v in lint(arts, [rule_id]) if v.rule == rule_id]


def _run(fn, *args, **kw):
    return trace_artifact(_case(fn=fn, args=args, **kw), CPU)


# ---------------------------------------------------------------------------
# R1 — retrace audit
# ---------------------------------------------------------------------------


def test_r1_clean_when_hashes_agree():
    a = Artifact(case=_case(signature="sig"), log_hash="aaaa",
                 retrace_hashes=(("double-trace", "aaaa"),))
    b = Artifact(case=_case(name="c2", signature="sig"), log_hash="aaaa")
    assert _rules_fired([a, b], "R1") == []


def test_r1_fires_on_forked_retrace():
    a = Artifact(case=_case(), log_hash="aaaa",
                 retrace_hashes=(("alias-build", "bbbb"),))
    assert _rules_fired([a], "R1")


def test_r1_fires_on_signature_bucket_split():
    a = Artifact(case=_case(name="c1", signature="sig"), log_hash="aaaa")
    b = Artifact(case=_case(name="c2", signature="sig"), log_hash="bbbb")
    assert _rules_fired([a, b], "R1")


def test_r1_double_run_of_a_step_logs_one_program():
    # a real run: scalars enter the log, so a rebuild with another baked
    # constant forks, and the same build run twice does not
    x = torch.ones(4)
    same = _run(lambda t: t * 2.0, x,
                retrace=(("rebuild", lambda t: t * 2.0, (x,)),))
    fork = _run(lambda t: t * 2.0, x,
                retrace=(("rebuild", lambda t: t * 3.0, (x,)),))
    assert not same.error and _rules_fired([same], "R1") == []
    assert _rules_fired([fork], "R1")


# ---------------------------------------------------------------------------
# R2 — host sync / state in place
# ---------------------------------------------------------------------------


def test_r2_fires_on_item_in_the_step():
    a = _run(lambda t: t * t.sum().item(), torch.ones(4))
    hits = _rules_fired([a], "R2")
    assert hits and "_local_scalar_dense" in hits[0].message


@pytest.mark.parametrize("op", [
    lambda t: t[t > 0],                       # masked indexing: nonzero
    lambda t: torch.nonzero(t),
    lambda t: torch.unique(t),
    lambda t: t * int(t[0]),
])
def test_r2_fires_on_data_dependent_syncs(op):
    assert _rules_fired([_run(op, torch.arange(4.0))], "R2")


def test_r2_fires_on_a_device_to_host_copy_and_the_sync_net():
    to_cpu = ("op", "aten._to_copy.default", (((4,), "float32", "cuda"),),
              (((4,), "float32", "cpu"),), ())
    upload = ("op", "aten._to_copy.default", (((4,), "float32", "cpu"),),
              (((4,), "float32", "cuda"),), ())
    bad = Artifact(case=_case(), device="cuda", log=(to_cpu,))
    ok = Artifact(case=_case(), device="cuda", log=(upload,))
    net = Artifact(case=_case(), device="cuda",
                   log=(("sync", "called a synchronizing CUDA operation"),))
    assert "device -> cpu" in _rules_fired([bad], "R2")[0].message
    assert _rules_fired([ok], "R2") == []
    assert "sync net" in _rules_fired([net], "R2")[0].message


def test_r2_clean_on_state_updated_in_place():
    def step(p, cache):
        cache.add_(p[:, None])
        return p, cache
    a = _run(step, torch.ones(4), torch.zeros(4, 8), state_argnums=(1,))
    assert not a.error and a.state_lost == ()
    assert _rules_fired([a], "R2") == []


def test_r2_fires_on_state_not_updated_in_place():
    a = _run(lambda p, cache: (p, cache + 1.0), torch.ones(4),
             torch.zeros(4, 8), state_argnums=(1,))
    hits = _rules_fired([a], "R2")
    assert hits and "not updated in place" in hits[0].message


# ---------------------------------------------------------------------------
# R3 — collective audit
# ---------------------------------------------------------------------------


def _psums(*shapes):
    return tuple(("collective", "psum", 1, (s,)) for s in shapes)


def test_r3_chunked_audit_good_and_bad():
    full, chunk = (2, 8, 256), (2, 8, 64)
    ok, observed = rules.audit_chunked_psum(_psums(*[chunk] * 4), 4, full,
                                            chunk)
    assert ok == [] and observed == [chunk] * 4
    bad, _ = rules.audit_chunked_psum(_psums(full), 4, full, chunk)
    assert len(bad) == 2          # missing chunks AND a surviving fat one
    ok1, _ = rules.audit_chunked_psum(_psums(full), 1, full, chunk)
    assert ok1 == []


def test_r3_rule_reads_expectations_from_case():
    exp = {"chunked_psum": {"chunks": 4, "full": (2, 8, 256),
                            "chunk": (2, 8, 64)}}
    good = Artifact(case=_case(expect=exp), log=_psums(*[(2, 8, 64)] * 4))
    bad = Artifact(case=_case(expect=exp), log=_psums((2, 8, 256)))
    assert _rules_fired([good], "R3") == []
    assert _rules_fired([bad], "R3")


def test_r3_real_chunked_psum_logs_k_chunk_sums():
    from repro_torch.parallel import TPGroup
    g = TPGroup(4)
    parts = [torch.ones(2, 8, 256) for _ in range(4)]
    for k, want in ((1, [(2, 8, 256)]), (4, [(2, 8, 64)] * 4)):
        a = _run(lambda *p, k=k: g.chunked_psum(list(p), k), *parts)
        _, observed = rules.audit_chunked_psum(
            [e for e in a.log if e[0] == "collective"], k, (2, 8, 256),
            (2, 8, 64))
        assert observed == want


def test_r3_grouped_bcast_counting():
    """The multi-source migration broadcast is ONE grouped call over
    every slot's buffers; one call per slot shows up as a count of 2."""
    from repro_torch.core.migration import fused_migration_broadcast
    from repro_torch.parallel import TPGroup

    class PerSlot(TPGroup):
        def bcast_grouped(self, srcs, value_of):
            return [super(PerSlot, self).bcast_grouped(
                [s], lambda r, _, i=i: value_of(r, i))[0]
                for i, s in enumerate(srcs)]

    w = torch.arange(8 * 32, dtype=torch.float32).reshape(8, 32)

    def exports(r, s):
        return w[:, r * 4:r * 4 + 2], w[:, r * 4:r * 4 + 2].t(), None

    def run(group):
        return _run(lambda: fused_migration_broadcast(
            group, [5, 2], [2, 2], 1, exports),
            expect={"grouped_bcast": {"count": 1}})
    grouped, split = run(TPGroup(8)), run(PerSlot(8))
    count = rules.grouped_bcast_count
    colls = [[e for e in a.log if e[0] == "collective"]
             for a in (grouped, split)]
    assert count(colls[0]) == 1 and count(colls[1]) == 2
    assert _rules_fired([grouped], "R3") == []
    assert _rules_fired([split], "R3")


# ---------------------------------------------------------------------------
# R4 — launch budget (a fixture ptxas -v log and launch configuration)
# ---------------------------------------------------------------------------

_NS = "_GLOBAL__N__5a7c1e29_18_mla_decode_attn_cu_3f2a1b0c"
_PTXAS = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN{len(_NS)}{_NS}18mla_partial_kernelIfNS_8SlotRowsEEEvPKT_S5_S5_S5_PKiPfS8_S8_T0_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN{len(_NS)}{_NS}18mla_partial_kernelIfNS_8SlotRowsEEEvPKT_S5_S5_S5_PKiPfS8_S8_T0_iiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 128 bytes smem, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_Z20reduce_splits_kernelI13__nv_bfloat16EvPKfPT_li' for 'sm_90a'
ptxas info    : Function properties for _Z20reduce_splits_kernelI13__nv_bfloat16EvPKfPT_li
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 380 bytes cmem[0]
"""
_MLA = "mla_partial_kernel<float,SlotRows>"
_RED = "reduce_splits_kernel<__nv_bfloat16>"


def test_r4_parses_the_ptxas_log():
    res = smem.parse_ptxas_log(_PTXAS)
    assert res[_MLA] == smem.FunctionResources(_MLA, 40, 128, 0, 0)
    assert res[_RED] == smem.FunctionResources(_RED, 255, 0, 4, 4)


def _launch_art(*launches, budget=smem.Budget()):
    return Artifact(case=_case(expect={
        "ptxas_resources": smem.parse_ptxas_log(_PTXAS),
        "smem_budget": budget}),
        log=(("launch", "w", tuple(launches)),))


def test_r4_clean_within_budget_fires_when_over():
    fits = Launch(_MLA, (8, 32, 1), 256, 108_000)
    assert _rules_fired([_launch_art(fits)], "R4") == []
    too_big = Launch(_MLA, (8, 32, 1), 256, 232_448)   # + 128 static
    hits = _rules_fired([_launch_art(too_big)], "R4")
    assert hits and "shared memory" in hits[0].message
    tight = smem.Budget(smem_per_block=64 * 1024)
    assert _rules_fired([_launch_art(fits, budget=tight)], "R4")


def test_r4_fires_on_registers_and_unpriced_launches():
    regs = Launch(_RED, (100, 1, 1), 512, 0)            # 255 x 512 > 64K
    hits = _rules_fired([_launch_art(regs)], "R4")
    assert hits and "registers" in hits[0].message
    ghost = Launch("no_such_kernel<float>", (1, 1, 1), 32, 0)
    assert "unpriced" in _rules_fired([_launch_art(ghost)], "R4")[0].message


def test_r4_assert_fits_raises_named_error():
    res = smem.parse_ptxas_log(_PTXAS)
    smem.assert_fits([Launch(_MLA, (8, 32, 1), 256, 1024)], res,
                     smem.Budget())
    with pytest.raises(smem.SmemBudgetError):
        smem.assert_fits([Launch(_MLA, (8, 32, 1), 256, 300_000)], res,
                         smem.Budget())


# ---------------------------------------------------------------------------
# R5 — dtype leak
# ---------------------------------------------------------------------------


def test_r5_fires_on_f64_op():
    a = _run(lambda t: t.to(torch.float64) * 2, torch.ones(4))
    assert _rules_fired([a], "R5")


def test_r5_respects_allowance_and_passes_f32():
    allowed = _run(lambda t: t.to(torch.float64), torch.ones(4),
                   expect={"allow_f64": True})
    clean = _run(lambda t: t.to(torch.float32) * 2, torch.ones(4))
    assert _rules_fired([allowed], "R5") == []
    assert _rules_fired([clean], "R5") == []


# ---------------------------------------------------------------------------
# engine-level behaviour
# ---------------------------------------------------------------------------


def test_engine_surfaces_run_failures_as_violations():
    def boom():
        raise RuntimeError("boom")
    art = trace_artifact(_case(fn=boom), CPU)
    assert art.error
    hits = [v for v in lint([art]) if v.rule == "engine"]
    assert hits and "boom" in hits[0].message


def test_engine_runs_on_fresh_copies():
    x = torch.zeros(3)

    def step(t):
        t.add_(1.0)
        return t
    engine.run_once(step, (x,), "cpu")
    assert torch.equal(x, torch.zeros(3))


def test_unknown_rule_id_rejected():
    with pytest.raises(ValueError):
        rules.rules_by_id(["R9"])


def test_registry_completeness_every_cli_step_registered():
    from repro.analysis.registry import REQUIRED_STEPS as JAX_STEPS
    from repro_torch.analysis.registry import (NOT_YET_PORTED,
                                               REQUIRED_STEPS,
                                               load_providers)
    names = load_providers()
    missing = set(REQUIRED_STEPS) - set(names)
    assert not missing, (
        f"step builders missing analysis registration: {sorted(missing)}")
    # every step the reference registers is either registered here or
    # named, with the item that brings it, as not yet ported
    assert set(JAX_STEPS) == (set(REQUIRED_STEPS) & set(JAX_STEPS)) \
        | set(NOT_YET_PORTED)
    assert not set(NOT_YET_PORTED) & set(names)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


def test_check_and_mutate_on_cpu(capsys):
    from repro_torch.analysis.__main__ import main
    from repro_torch.kernels import ops
    assert main(["--device", "cpu", "--check", "--mutate", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["check"]["violations"] == []
    cases = set(report["check"]["cases"])
    for w in ops.KERNEL_WRAPPERS:
        assert any(c.startswith("micro_kernel/" + w.__name__)
                   for c in cases), w.__name__
    assert {"micro_collective/proj_psum_chunks1",
            "micro_collective/proj_psum_chunks4",
            "micro_collective/ffn_migration_broadcast",
            "micro_collective/ffn_migration_broadcast_2src",
            "train_step/dense_tp1", "train_step/controlled_tp4",
            "serve_decode_step/controlled_tp1",
            "serve_engine_step/base_tp1"} <= cases
    fired = {n: m["fired"] for n, m in report["mutate"].items()}
    assert fired == {n: True for n in ("retrace_forks", "host_item",
                                       "state_replaced", "chunks_ignored",
                                       "smem_blowout", "f64_leak")}
    for name, rule in (("retrace_forks", "R1"), ("host_item", "R2"),
                       ("state_replaced", "R2"), ("chunks_ignored", "R3"),
                       ("smem_blowout", "R4"), ("f64_leak", "R5")):
        assert report["mutate"][name]["detail"].startswith(f"[{rule}]")


def test_mutate_mode_every_rule_fires():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
         "--mutate", "--rules", "R1,R2,R3,R4,R5"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, \
        f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    assert "0 silent" in out.stdout


def test_cuda_device_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from repro_torch.analysis.__main__ import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--check", "--steps", "micro_kernel"])


def test_steps_filter_restricts_the_matrix(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--device", "cpu", "--steps", "micro_collective",
                 "--rules", "R3", "--json"]) == 0
    cases = json.loads(capsys.readouterr().out)["check"]["cases"]
    assert len(cases) == 4
    assert all(c.startswith("micro_collective/") for c in cases)
