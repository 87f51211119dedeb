"""``python -m repro_torch.analysis`` — the port's static invariant gate.

--check  (default) run the full registered signature matrix once at
         smoke width and lint it against R1–R5; exit 1 on any violation.
--mutate seed the known-bad variants and assert every rule fires;
         exit 1 if any rule stays silent on its mutant.

Runs on the card (``--device cuda``, the default; raises without one),
where the kernels launch and R4 prices their real launch
configurations; ``--device cpu`` runs the same matrix through the
kernels' plain versions. The tensor-parallel group is emulated in one
process. ``--rules R2,R3`` restricts the catalog; ``--steps`` restricts
the matrix; ``--json`` emits a machine-readable report.
"""
from __future__ import annotations

import argparse
import json
import sys


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant gate of the PyTorch port (R1-R5)")
    p.add_argument("--check", action="store_true",
                   help="lint the tree across the signature matrix "
                        "(default)")
    p.add_argument("--mutate", action="store_true",
                   help="seed known-bad variants; every rule must fire")
    p.add_argument("--rules", default="",
                   help="comma-separated rule ids (default: all)")
    p.add_argument("--steps", default="",
                   help="comma-separated step names (default: all)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the steps run (cuda unless you ask for cpu)")
    p.add_argument("--json", action="store_true", dest="as_json")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    if not args.mutate:
        args.check = True

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; run the analyzer "
                           "with --device cpu to lint on the CPU")

    from repro_torch.analysis import engine, mutants
    from repro_torch.analysis.registry import CaseEnv

    rule_ids = [r for r in args.rules.split(",") if r.strip()] or None
    steps = [s for s in args.steps.split(",") if s.strip()] or None

    env = CaseEnv(device=args.device)
    report = {}
    failed = False

    if args.check:
        violations, artifacts = engine.run_check(env, rule_ids, steps)
        report["check"] = {
            "cases": [a.case.label for a in artifacts],
            "violations": [str(v) for v in violations],
        }
        if violations:
            failed = True
        if not args.as_json:
            print(f"[analysis] --check: {len(artifacts)} cases, "
                  f"{len(violations)} violation(s)")
            for v in violations:
                print(f"  FAIL {v}")

    if args.mutate:
        results = mutants.run_mutants(env)
        report["mutate"] = {name: {"fired": fired, "detail": detail}
                           for name, (fired, detail) in results.items()}
        silent = [n for n, (fired, _) in results.items() if not fired]
        if silent:
            failed = True
        if not args.as_json:
            print(f"[analysis] --mutate: {len(results)} mutants, "
                  f"{len(silent)} silent")
            for name, (fired, detail) in sorted(results.items()):
                print(f"  {'FIRED' if fired else 'SILENT'} "
                      f"{name}: {detail}")

    if args.as_json:
        print(json.dumps(report, indent=2))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
