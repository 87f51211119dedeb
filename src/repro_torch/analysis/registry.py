"""Step-builder registry for the port's static analyzer (port of
``repro.analysis.registry``).

Every step the port's CLIs drive registers a *case provider* here:
``launch/steps.py`` (the train step and the controlled serve-decode
step), ``launch/serve.py`` (the serve engine's base step) and
``cluster/replica.py`` (the same step through a replica handle);
``analysis/micro.py`` adds the collective and kernel probes. The engine
calls each provider with a :class:`CaseEnv` and lints the returned
:class:`TraceCase` list against R1–R5, so a driver that forgets to
register is caught by the completeness test
(``tests/test_torch_analysis.py``).

The reference traces abstractly; eager PyTorch runs. So a case's
``args`` are real tensors, and the engine runs each case on fresh copies
of them.

This module imports nothing heavy (no torch): providers import it at
module scope and do their heavy imports inside the provider.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

#: step names the port's drivers must register
#: (tests/test_torch_analysis.py asserts completeness against this)
REQUIRED_STEPS = ("train_step", "serve_decode_step", "serve_engine_step",
                  "cluster_tick", "micro_collective", "micro_kernel")

#: the reference's registered steps the port does not have yet, with the
#: ROADMAP.md item that brings each
NOT_YET_PORTED = {
    "prefill_step": "LM prefill, with LM training (ROADMAP.md, queue A.5)",
}


@dataclasses.dataclass
class CaseEnv:
    """Where the analyzer runs its cases."""
    device: str = "cuda"          # the steps' device ("cuda" or "cpu")


@dataclasses.dataclass
class TraceCase:
    """One runnable (fn, args) point of the signature matrix.

    ``args`` are tensors and trees of tensors (a model, a KV cache); every
    run gets fresh copies. ``signature``
    buckets cases for the R1 audit: cases sharing a (step, signature)
    bucket must log the same program. ``retrace`` lists alternative builds
    of the same signature — e.g. a PlanStatic spelled with the legacy
    ``mig_blocks`` field instead of ``mig_shed`` — that must log
    identically. ``state_argnums`` name hot-loop state (the KV cache) that
    must come back as the same storage, updated in place (R2);
    ``expect`` carries rule-specific expectations (R3 collective counts,
    R4 budget and ptxas-log overrides, R5 allowances)."""
    step: str
    name: str
    fn: Callable
    args: Tuple[Any, ...] = ()
    state_argnums: Tuple[int, ...] = ()
    expect: Dict[str, Any] = dataclasses.field(default_factory=dict)
    signature: str = ""
    retrace: Tuple[Tuple[str, Callable, Tuple[Any, ...]], ...] = ()

    @property
    def label(self) -> str:
        return f"{self.step}/{self.name}"


@dataclasses.dataclass
class Artifact:
    """What one case's runs produced, as the rules see them.

    ``log`` is the run's program text: one entry per aten op
    (``("op", name, inputs, outputs, scalars)``), per kernel launch
    (``("launch", wrapper, launches)``) and per collective
    (``("collective", kind, n_operands, shapes)``)."""
    case: TraceCase
    device: str = "cpu"
    log: Tuple[Tuple, ...] = ()
    log_hash: str = ""
    retrace_hashes: Tuple[Tuple[str, str], ...] = ()
    state_lost: Tuple[str, ...] = ()
    error: str = ""


Provider = Callable[[CaseEnv], List[TraceCase]]

_PROVIDERS: Dict[str, Provider] = {}


def register(step: str, provider: Provider) -> None:
    """Idempotent: re-import of a driver module re-registers in place."""
    _PROVIDERS[step] = provider


def names() -> List[str]:
    return sorted(_PROVIDERS)


def provider(step: str) -> Provider:
    return _PROVIDERS[step]


def cases_for(env: CaseEnv,
              steps: Optional[List[str]] = None) -> List[TraceCase]:
    out: List[TraceCase] = []
    for step in names():
        if steps and step not in steps:
            continue
        out.extend(_PROVIDERS[step](env))
    return out


def load_providers() -> List[str]:
    """Import every module known to register providers; returns the
    resulting registry names. New drivers: register in your module and
    add the import here (the completeness test will remind you)."""
    import repro_torch.launch.steps       # noqa: F401  train / serve-decode
    import repro_torch.launch.serve       # noqa: F401  serve_engine_step
    import repro_torch.cluster.replica    # noqa: F401  cluster_tick
    import repro_torch.analysis.micro     # noqa: F401  collective / kernel
    return names()
