"""Known-bad variants that prove each rule fires (port of
``repro.analysis.mutants``).

``--mutate`` seeds one deliberate violation per rule — two builds of one
signature that bake different constants (R1), an ``.item()`` in the step
and a step that returns a new cache instead of updating it in place
(R2), a group whose ``chunked_psum`` ignores the chunks (R3), a launch
whose shared memory exceeds the budget (R4), a float64 cast (R5) — and
asserts the matching rule reports it. A rule that stays silent on its
mutant is a dead rule; the gate fails on that as hard as on a dirty tree.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from repro_torch.analysis import engine
from repro_torch.analysis import registry as reg

# #5 (fused_mla_decode_attention) at a 4096-wide latent: the f32 [16, 4096]
# accumulator alone is 256 KiB, past the 227 KB a block can have
_R4_SHAPE = dict(B=8, H=16, R=4096, Dr=64, splits=32, paged=0, dtype=0)


def _x(env: reg.CaseEnv, *shape):
    import torch
    return torch.ones(shape, device=env.device)


def _m_retrace_forks(env: reg.CaseEnv) -> List[reg.Artifact]:
    """R1: two builds of the "same" plan signature bake different
    constants into the step — the moral equivalent of keying the build
    cache on a non-canonical signature."""
    def build(c):
        return lambda x: x * c

    case = reg.TraceCase(
        step="mutant", name="retrace_forks", fn=build(1.0),
        args=(_x(env, 8),),
        retrace=(("rebuild-same-signature", build(2.0), (_x(env, 8),)),))
    return [engine.trace_artifact(case, env)]


def _m_host_item(env: reg.CaseEnv) -> List[reg.Artifact]:
    """R2: an ``.item()`` smuggled into the hot step."""
    def fn(x):
        return x * x.sum().item()

    case = reg.TraceCase(step="mutant", name="host_item", fn=fn,
                         args=(_x(env, 8),))
    return [engine.trace_artifact(case, env)]


def _m_state_replaced(env: reg.CaseEnv) -> List[reg.Artifact]:
    """R2: a state buffer (argnum 1, think KV cache) declared hot, but the
    step returns a NEW tensor instead of updating it in place."""
    def fn(p, cache):
        return p, cache + 1.0

    case = reg.TraceCase(step="mutant", name="state_replaced", fn=fn,
                         args=(_x(env, 4), _x(env, 4, 8)),
                         state_argnums=(1,))
    return [engine.trace_artifact(case, env)]


def _m_chunks_ignored(env: reg.CaseEnv) -> List[reg.Artifact]:
    """R3: the controlled row projection at psum_chunks=4 on a group whose
    ``chunked_psum`` ignores the chunks (one full-width sum)."""
    from repro_torch.analysis import micro
    from repro_torch.parallel import TPGroup

    class _IgnoresChunks(TPGroup):
        def chunked_psum(self, parts, n_chunks):
            return self.psum(parts)

    good = micro._collective_cases(env)
    k4 = next(c for c in good if c.name == "proj_psum_chunks4")
    case = reg.TraceCase(
        step="mutant", name="chunks_ignored",
        fn=micro.proj_fn(4, env.device, _IgnoresChunks), args=k4.args,
        expect=k4.expect)
    return [engine.trace_artifact(case, env)]


def _m_smem_blowout(env: reg.CaseEnv) -> List[reg.Artifact]:
    """R4: #5 at a 4096-wide latent, priced without launching. On the
    card the launch records come from the launcher's own
    ``repro_mla_decode_attn_launch_config`` and the resources from the
    ptxas log, and :func:`smem.assert_fits` must raise. On the CPU there
    is no build: a literal launch of 256 KiB of dynamic shared memory
    (the f32 [16, 4096] accumulator alone), against a function that
    needs no registers or static shared memory, so only the shared
    memory can fire."""
    from repro_torch.analysis import smem
    from repro_torch.kernels import build

    if env.device == "cuda":
        s = _R4_SHAPE
        launches = build.launch_config("repro_mla_decode_attn", s["B"],
                                       s["H"], s["R"], s["Dr"], s["splits"],
                                       s["paged"], s["dtype"])
        expect = {}
        try:
            smem.assert_fits(launches)
        except smem.SmemBudgetError:
            pass
        else:
            raise AssertionError("assert_fits let the oversized launch pass")
    else:
        fn = "mla_partial_kernel<float,SlotRows>"
        launches = (build.Launch(fn, (8, 32, 1), 256, 256 * 1024),)
        expect = {"ptxas_resources": {fn: smem.FunctionResources(
            fn, 0, 0, 0, 0)}, "smem_budget": smem.Budget()}
    case = reg.TraceCase(step="mutant", name="smem_blowout",
                         fn=lambda: None, expect=expect)
    return [reg.Artifact(case=case, device=env.device, log=(
        ("launch", "fused_mla_decode_attention", tuple(launches)),))]


def _m_f64_leak(env: reg.CaseEnv) -> List[reg.Artifact]:
    """R5: an accidental float64 cast inside the step."""
    import torch

    def fn(x):
        return x.to(torch.float64) * 2.0

    case = reg.TraceCase(step="mutant", name="f64_leak", fn=fn,
                         args=(_x(env, 8),))
    return [engine.trace_artifact(case, env)]


#: rule id -> (mutant name, artifact builder)
MUTANTS: Tuple[Tuple[str, str, Callable], ...] = (
    ("R1", "retrace_forks", _m_retrace_forks),
    ("R2", "host_item", _m_host_item),
    ("R2", "state_replaced", _m_state_replaced),
    ("R3", "chunks_ignored", _m_chunks_ignored),
    ("R4", "smem_blowout", _m_smem_blowout),
    ("R5", "f64_leak", _m_f64_leak),
)


def run_mutants(env: reg.CaseEnv = None
                ) -> Dict[str, Tuple[bool, str]]:
    """Returns {mutant_name: (rule_fired, detail)}. Every entry must
    fire for the analyzer itself to be considered alive."""
    env = env or reg.CaseEnv()
    out: Dict[str, Tuple[bool, str]] = {}
    for rule_id, name, build in MUTANTS:
        try:
            arts = build(env)
        except Exception as e:                            # noqa: BLE001
            out[name] = (False, f"mutant build failed: {e!r}")
            continue
        errs = [a.error for a in arts if a.error]
        if errs:
            out[name] = (False, f"mutant run failed: {errs}")
            continue
        hits = [v for v in engine.lint(arts, [rule_id])
                if v.rule == rule_id]
        if hits:
            out[name] = (True, str(hits[0]))
        else:
            out[name] = (False,
                         f"rule {rule_id} did NOT fire on its mutant")
    return out
