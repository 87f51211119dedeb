"""The analyzer's run/record/lint driver (port of
``repro.analysis.engine``).

The reference traces each case abstractly (``jax.make_jaxpr``) and lints
the jaxpr. Eager PyTorch has no jaxpr, so here every case RUNS, on fresh
copies of its arguments, under a recording
:class:`~torch.utils._python_dispatch.TorchDispatchMode` that logs each
aten op of the step, forward and backward: its name, the shape, dtype
and device of its tensor inputs and outputs, and its non-tensor
arguments (the counterpart of jaxpr literals). The port's CUDA kernels
are ``ctypes`` calls the dispatcher never sees, so the kernel wrappers
report each launch with its configuration
(:func:`repro_torch.kernels.ops.set_launch_hook`) and the TP group each
collective (:func:`repro_torch.parallel.set_collective_hook`) into the
same log. That log is the step's program text: it is hashed twice (the
"double-trace") plus once per declared alternate build (R1), and the
R1–R5 catalog lints the batch. On the card the run is also wrapped in
``torch.cuda.set_sync_debug_mode("error")``, a second net for R2.

A case that fails to run is itself a violation (rule id ``engine``):
the matrix must stay green, not just the rules.
"""
from __future__ import annotations

import contextlib
import copy
import hashlib
from typing import Any, Iterator, List, Optional, Sequence, Tuple

from repro_torch.analysis import registry as reg
from repro_torch.analysis import rules as R

_SCALARS = (int, float, bool, str, type(None))
# what torch.cuda.set_sync_debug_mode("error") raises with
SYNC_NET_ERROR = "synchronizing CUDA operation"


def log_hash(log: Sequence[Tuple]) -> str:
    return hashlib.sha256(repr(tuple(log)).encode()).hexdigest()[:16]


def tensor_leaves(tree) -> Iterator[Any]:
    """The tensors of a tree of dicts / lists / tuples, in order."""
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from tensor_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from tensor_leaves(t)


def _meta(t) -> Tuple:
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""),
            t.device.type)


def _literal(a):
    """A non-tensor argument as it enters the log."""
    import torch
    if isinstance(a, torch.Tensor):       # an index list's tensors
        return "Tbool" if a.dtype == torch.bool else "T"
    if isinstance(a, _SCALARS):
        return a
    if isinstance(a, (list, tuple)):
        return tuple(_literal(x) for x in a)
    if isinstance(a, (torch.dtype, torch.device, torch.layout,
                      torch.memory_format)):
        return str(a)
    return type(a).__name__


class Recorder:
    """Context manager: logs every aten op, kernel launch and collective
    while it is active."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        log: List[Tuple] = []
        self.log = log

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                import torch
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                flat_in = list(args) + list(kwargs.values())
                ins = tuple(_meta(t) for t in tensor_leaves(flat_in))
                outs = tuple(_meta(t) for t in tensor_leaves(out))
                lits = tuple(_literal(a) for a in flat_in
                             if not isinstance(a, torch.Tensor))
                log.append(("op", str(func), ins, outs, lits))
                return out

        self._mode = _Mode()
        self._prev: Tuple = (None, None)

    # each record also goes on to the hook that was installed before
    def _launch(self, wrapper, launches):
        self.log.append(("launch", wrapper, tuple(launches)))
        if self._prev[0] is not None:
            self._prev[0](wrapper, launches)

    def _collective(self, kind, n, shapes):
        self.log.append(("collective", kind, n, shapes))
        if self._prev[1] is not None:
            self._prev[1](kind, n, shapes)

    def __enter__(self):
        from repro_torch import parallel
        from repro_torch.kernels import ops
        self._prev = (ops.set_launch_hook(self._launch),
                      parallel.set_collective_hook(self._collective))
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        from repro_torch import parallel
        from repro_torch.kernels import ops
        self._mode.__exit__(*exc)
        ops.set_launch_hook(self._prev[0])
        parallel.set_collective_hook(self._prev[1])
        return False


@contextlib.contextmanager
def _sync_net(device: str):
    """On the card: any synchronising call in the step raises."""
    if device != "cuda":
        yield
        return
    import torch
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _fresh(args) -> tuple:
    """Fresh copies of a case's arguments."""
    return tuple(copy.deepcopy(tuple(args)))


def _where(tb) -> str:
    """file:line of the innermost frame of a traceback outside torch and
    this module (the step's own line that synchronised)."""
    import traceback
    for fr in reversed(traceback.extract_tb(tb)):
        f = fr.filename.replace("\\", "/")
        if "/torch/" not in f and fr.filename != __file__:
            return f"{'/'.join(f.split('/')[-3:])}:{fr.lineno}"
    return "?"


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def run_once(fn, args, device: str, state_argnums: Sequence[int] = ()
             ) -> Tuple[Tuple, Tuple[str, ...]]:
    """Run ``fn`` on fresh copies of ``args`` under the recorder. Returns
    (log, state_lost): the state leaves that did not come back as the
    storage they went in as."""
    a = _fresh(args)
    state = [(i, j, _storage(t)) for i in state_argnums
             for j, t in enumerate(tensor_leaves(a[i]))]
    out = None
    with Recorder() as rec, _sync_net(device):
        try:
            out = fn(*a)
        except RuntimeError as e:
            if SYNC_NET_ERROR not in str(e):
                raise
            # the card's sync net stopped the step at a host sync (R2)
            rec.log.append(("sync", f"{str(e).splitlines()[0]} at "
                                    f"{_where(e.__traceback__)}"))
    back = {_storage(t) for t in tensor_leaves(out)}
    lost = tuple(f"argnum {i} leaf {j}" for i, j, p in state
                 if p not in back)
    return tuple(rec.log), lost


def trace_artifact(case: reg.TraceCase, env: reg.CaseEnv) -> reg.Artifact:
    try:
        log, lost = run_once(case.fn, case.args, env.device,
                             case.state_argnums)
        h = log_hash(log)
        log2, _ = run_once(case.fn, case.args, env.device)
        retr: List[Tuple[str, str]] = [("double-trace", log_hash(log2))]
        for label, fn, args in case.retrace:
            retr.append((label, log_hash(run_once(fn, args, env.device)[0])))
        return reg.Artifact(case=case, device=env.device, log=log,
                            log_hash=h, retrace_hashes=tuple(retr),
                            state_lost=lost)
    except Exception as e:                                # noqa: BLE001
        return reg.Artifact(case=case, device=env.device,
                            error=f"{type(e).__name__}: {e}")


def lint(artifacts: List[reg.Artifact],
         rule_ids: Optional[Sequence[str]] = None) -> List[R.Violation]:
    """Rules over already-run artifacts (reused by tests / mutants)."""
    violations: List[R.Violation] = []
    for a in artifacts:
        if a.error:
            violations.append(R.Violation(
                "engine", a.case.step, a.case.name,
                f"run failed: {a.error}"))
    clean = [a for a in artifacts if not a.error]
    for rule in R.rules_by_id(rule_ids):
        violations.extend(rule.check(clean))
    return violations


def run_check(env: Optional[reg.CaseEnv] = None,
              rule_ids: Optional[Sequence[str]] = None,
              steps: Optional[List[str]] = None,
              ) -> Tuple[List[R.Violation], List[reg.Artifact]]:
    """Run the whole registered matrix and lint it."""
    env = env or reg.CaseEnv()
    R.rules_by_id(rule_ids)               # unknown ids fail before any run
    reg.load_providers()
    cases = reg.cases_for(env, steps)
    artifacts = [trace_artifact(c, env) for c in cases]
    return lint(artifacts, rule_ids), artifacts
