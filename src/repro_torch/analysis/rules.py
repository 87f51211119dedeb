"""The declarative rule catalog (R1–R5) the port's analyzer lints against
(port of ``repro.analysis.rules``; same rule ids, ``Violation`` format
and ``rules_by_id`` errors).

Each rule sees the FULL artifact batch (the logged program of each
:class:`~repro_torch.analysis.registry.TraceCase`) and returns
:class:`Violation`\\ s. What each invariant protects in the port:

R1 retrace audit      — one plan signature, one program: a case's two
                        runs and its alternate builds log the same ops,
                        launches and collectives, and cases sharing a
                        (step, signature) bucket log one program. This is
                        what a CUDA graph per plan signature needs: one
                        fixed launch sequence to capture and replay.
R2 host-sync detector — the step never reads the device from the host:
                        no ``_local_scalar_dense`` (``.item()``,
                        ``int()``, ``bool()`` of a tensor), ``nonzero``,
                        ``masked_select``, ``unique*`` or indexing by a
                        boolean mask on the step's device, and no copy from the card to the CPU
                        (uploads of the step's own host inputs are
                        allowed). Declared state (the KV cache) comes back
                        as the SAME storage, updated in place — the
                        counterpart of "donated and aliased".
R3 collective audit   — ``psum_chunks = k`` gives exactly k chunk-width
                        sums and zero full-width ones (one full-width sum
                        for k = 1), and the multi-source migration
                        broadcast is ONE grouped call carrying >= 2
                        operands.
R4 launch budget      — every recorded launch fits the SM: static plus
                        dynamic shared memory within the opt-in limit,
                        registers x threads within the register file
                        (analysis/smem.py).
R5 dtype leak         — no float64 / complex128 output from any op of
                        the step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import smem as SM
from repro_torch.analysis.registry import Artifact


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    step: str
    case: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.step}/{self.case}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    title: str
    description: str
    check: Callable[[List[Artifact]], List[Violation]]


def _v(rule: str, art: Artifact, msg: str) -> Violation:
    return Violation(rule, art.case.step, art.case.name, msg)


def _entries(a: Artifact, kind: str):
    return [e for e in a.log if e[0] == kind]


# ---------------------------------------------------------------------------
# R1 — retrace audit
# ---------------------------------------------------------------------------


def _check_retrace(arts: List[Artifact]) -> List[Violation]:
    out = []
    for a in arts:
        if not a.log_hash:
            continue
        for label, h in a.retrace_hashes:
            if h != a.log_hash:
                out.append(_v("R1", a, (
                    f"retrace '{label}' logged a DIFFERENT program "
                    f"({h} != {a.log_hash}): one plan signature would "
                    "launch two sequences, and a graph captured for it "
                    "would replay the wrong one")))
    by_sig: Dict[Tuple[str, str], List[Artifact]] = {}
    for a in arts:
        if a.case.signature and a.log_hash:
            by_sig.setdefault((a.case.step, a.case.signature), []).append(a)
    for (step, sig), group in by_sig.items():
        hashes = {a.log_hash for a in group}
        if len(hashes) > 1:
            out.append(Violation("R1", step, sig, (
                f"signature bucket '{sig}' logged {len(hashes)} distinct "
                f"programs across cases {[a.case.name for a in group]} — "
                "the build cache would alias different programs")))
    return out


# ---------------------------------------------------------------------------
# R2 — host sync / state in place
# ---------------------------------------------------------------------------

#: aten ops that make the host wait for the device (by base name)
SYNC_OPS = frozenset({"_local_scalar_dense", "item", "nonzero",
                      "masked_select", "unique", "_unique", "_unique2",
                      "unique_dim", "unique_consecutive", "is_nonzero",
                      "equal"})


#: indexing ops whose output shape depends on the data when an index is
#: a boolean mask (the mask is turned into positions on the host)
MASK_INDEX_OPS = frozenset({"index", "index_put", "index_put_",
                            "_index_put_impl_"})


def _flat(lits):
    for x in lits:
        if isinstance(x, tuple):
            yield from _flat(x)
        else:
            yield x


def _base(op: str) -> str:
    return op.split("::")[-1].split(".")[1] if op.startswith("aten.") \
        else op.split(".")[0]


def host_syncs(a: Artifact) -> List[str]:
    """The ops of the step that read the device from the host."""
    bad = []
    for _, op, ins, outs, lits in _entries(a, "op"):
        on_dev = [m for m in ins if m[2] == a.device]
        base = _base(op)
        if on_dev and (base in SYNC_OPS or (
                base in MASK_INDEX_OPS and "Tbool" in _flat(lits))):
            bad.append(op)
        elif any(m[2] != "cpu" for m in ins) and any(
                m[2] == "cpu" for m in outs):
            bad.append(f"{op} (device -> cpu copy)")
    return bad


def _check_host_sync(arts: List[Artifact]) -> List[Violation]:
    out = []
    for a in arts:
        bad = host_syncs(a) + [f"sync net: {e[1]}"
                               for e in _entries(a, "sync")]
        if bad:
            out.append(_v("R2", a, (
                f"host syncs in the step: {sorted(set(bad))} — each one "
                "stalls the host on the device every call")))
        if a.state_lost:
            out.append(_v("R2", a, (
                f"state {list(a.state_lost)} did not come back as the "
                "storage it went in as (not updated in place) — the hot "
                "loop double-buffers it and adds a copy per step")))
    return out


# ---------------------------------------------------------------------------
# R3 — collective audit
# ---------------------------------------------------------------------------


def audit_chunked_psum(collectives, chunks: int, full: Tuple[int, ...],
                       chunk: Tuple[int, ...]
                       ) -> Tuple[List[str], List[Tuple[int, ...]]]:
    """The chunked-epilogue invariant: with psum_chunks=k exactly k
    chunk-width sums and ZERO full-width ones; with k=1 exactly the one
    full-width sum. ``collectives`` are ``("collective", kind, n, shapes)``
    log entries. Returns (violations, observed psum shapes)."""
    observed = [tuple(shapes[0]) for _, kind, _, shapes in collectives
                if kind == "psum"]
    full, chunk = tuple(full), tuple(chunk)
    n_full = sum(1 for s in observed if s == full)
    n_chunk = sum(1 for s in observed if s == chunk)
    msgs = []
    if chunks <= 1:
        if n_full != 1:
            msgs.append(f"expected exactly 1 full-width {list(full)} sum, "
                        f"saw {n_full} (all: {observed})")
    else:
        if n_chunk != chunks:
            msgs.append(f"psum_chunks={chunks} but saw {n_chunk} "
                        f"chunk-width {list(chunk)} sums (all: {observed})")
        if n_full != 0:
            msgs.append(f"psum_chunks={chunks} left {n_full} full-width "
                        f"{list(full)} sum(s) — the epilogue was not split "
                        f"(all: {observed})")
    return msgs, observed


def grouped_bcast_count(collectives, min_operands: int = 2) -> int:
    """Grouped broadcasts carrying >= ``min_operands`` operands in ONE
    call. The multi-source migration broadcast is exactly one such call
    over every slot's export buffers (core/migration.py); a regression to
    one call per slot shows up as a count other than 1."""
    return sum(1 for _, kind, n, _ in collectives
               if kind == "bcast_grouped" and n >= min_operands)


def _check_collectives(arts: List[Artifact]) -> List[Violation]:
    out = []
    for a in arts:
        exp = a.case.expect
        colls = _entries(a, "collective")
        ca = exp.get("chunked_psum")
        if ca:
            msgs, _ = audit_chunked_psum(colls, ca["chunks"], ca["full"],
                                         ca["chunk"])
            out.extend(_v("R3", a, m) for m in msgs)
        gb = exp.get("grouped_bcast")
        if gb:
            n = grouped_bcast_count(colls, gb.get("min_operands", 2))
            if n != gb["count"]:
                out.append(_v("R3", a, (
                    f"expected {gb['count']} grouped broadcast(s) (the one "
                    f"masked migration broadcast), saw {n}")))
    return out


# ---------------------------------------------------------------------------
# R4 — launch budget
# ---------------------------------------------------------------------------


def _check_budget(arts: List[Artifact]) -> List[Violation]:
    out = []
    for a in arts:
        launches = [ln for e in _entries(a, "launch") for ln in e[2]]
        if not launches:
            continue
        exp = a.case.expect
        res = exp.get("ptxas_resources") or SM.kernel_resources()
        budget = exp.get("smem_budget") or SM.device_budget()
        seen = set()
        for m in SM.check_budget(launches, res, budget):
            if m not in seen:
                seen.add(m)
                out.append(_v("R4", a, m))
    return out


# ---------------------------------------------------------------------------
# R5 — dtype / f64 leak
# ---------------------------------------------------------------------------

_WIDE_DTYPES = ("float64", "complex128")


def wide_dtype_ops(a: Artifact) -> List[str]:
    bad = []
    for _, op, _, outs, _ in _entries(a, "op"):
        for shape, dt, _ in outs:
            if dt in _WIDE_DTYPES:
                bad.append(f"{op} -> {dt}{list(shape)}")
                break
    return bad


def _check_dtypes(arts: List[Artifact]) -> List[Violation]:
    out = []
    for a in arts:
        if a.case.expect.get("allow_f64"):
            continue
        bad = wide_dtype_ops(a)
        if bad:
            out.append(_v("R5", a, (
                f"f64/c128 values in the step: {bad[:4]}"
                f"{' …' if len(bad) > 4 else ''}")))
    return out


# ---------------------------------------------------------------------------
# catalog
# ---------------------------------------------------------------------------

RULES: Tuple[Rule, ...] = (
    Rule("R1", "retrace audit",
         "one plan signature == one logged program (one launch sequence)",
         _check_retrace),
    Rule("R2", "host-sync detector",
         "no host reads of the device in the step; hot state updated in "
         "place", _check_host_sync),
    Rule("R3", "collective audit",
         "psum_chunks=k => k chunk-width sums, 0 full-width; migration "
         "broadcast is one grouped call", _check_collectives),
    Rule("R4", "launch budget",
         "static + dynamic shared memory and registers x threads of every "
         "launch fit the SM", _check_budget),
    Rule("R5", "dtype/f64-leak check",
         "no f64/c128 outputs in the step",
         _check_dtypes),
)

RULE_IDS = tuple(r.id for r in RULES)


def rules_by_id(ids: Optional[Sequence[str]] = None) -> Tuple[Rule, ...]:
    if not ids:
        return RULES
    wanted = {i.strip().upper() for i in ids}
    unknown = wanted - set(RULE_IDS)
    if unknown:
        raise ValueError(f"unknown rule ids {sorted(unknown)}; "
                         f"have {RULE_IDS}")
    return tuple(r for r in RULES if r.id in wanted)
