"""repro_torch.analysis — the port's static invariant gate (port of
``repro.analysis``; DESIGN_ANALYSIS.md describes the reference).

Proves, on every run of ``python -m repro_torch.analysis --check
[--mutate]``, the plan-safety and hot-path rules the port assumes: R1 one
plan signature, one launch sequence; R2 no host sync in the step and hot
state updated in place; R3 exact collective counts; R4 every CUDA
kernel launch fits the SM's shared memory and registers; R5 no f64
leaks. Eager PyTorch has no jaxpr, so each case runs once at smoke
width under a recording dispatch mode (see ``engine.py``).

Importing this package is cheap (no torch); the engine and rules load
lazily on first attribute access so the registry can be populated from
library modules without dragging the analyzer in.
"""
from __future__ import annotations

_LAZY = {
    "CaseEnv": "registry", "TraceCase": "registry", "Artifact": "registry",
    "REQUIRED_STEPS": "registry", "NOT_YET_PORTED": "registry",
    "register": "registry", "load_providers": "registry",
    "RULES": "rules", "RULE_IDS": "rules", "Violation": "rules",
    "rules_by_id": "rules",
    "run_check": "engine", "lint": "engine", "trace_artifact": "engine",
    "run_mutants": "mutants",
    "SmemBudgetError": "smem", "assert_fits": "smem",
    "check_budget": "smem",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.analysis' has no "
                             f"attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"repro_torch.analysis.{mod}"),
                   name)
