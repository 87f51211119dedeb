"""R4: shared-memory and register budgets of the port's CUDA kernels (the
counterpart of ``repro.analysis.vmem``, which prices Pallas tiles against
a TPU core's VMEM).

On Hopper a block gets at most 232 448 bytes of shared memory (static
plus dynamic, above 48 KB only after ``cudaFuncSetAttribute``) and an SM
holds 65 536 32-bit registers. A launch past either never runs: it fails
with an opaque ``cudaErrorInvalidValue`` (or "too many resources
requested"). This module prices each launch before it happens:

* per ``__global__`` function, its registers per thread, static shared
  memory and spills, parsed from the ``-Xptxas -v`` log that
  :func:`repro_torch.kernels.build.library` keeps (``KernelLibrary.log``);
* per launch, the grid, threads and dynamic shared memory, read from the
  C launcher's own ``*_launch_config`` export
  (:func:`repro_torch.kernels.build.launch_config`), not from a Python
  copy of its formula;
* the budgets from the device's properties (H100 values by default).

:func:`check_budget` returns a message per launch that does not fit, or
that it cannot price; :func:`assert_fits` raises the named
:class:`SmemBudgetError` instead, before any launch.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, Iterable, List, Optional, Tuple

H100_SMEM_OPTIN = 232448      # bytes of shared memory a block can opt into
H100_REGS_PER_SM = 65536      # 32-bit registers of one SM


class SmemBudgetError(RuntimeError):
    """A launch's shared memory or registers do not fit the SM."""


@dataclasses.dataclass(frozen=True)
class Budget:
    smem_per_block: int = H100_SMEM_OPTIN
    regs_per_sm: int = H100_REGS_PER_SM


@dataclasses.dataclass(frozen=True)
class FunctionResources:
    """What ptxas reports for one ``__global__`` function."""
    fn: str
    registers: int
    static_smem: int
    spill_stores: int
    spill_loads: int


def device_budget(device_index: Optional[int] = None) -> Budget:
    """The budget of a CUDA device from its properties (the H100 values
    where this PyTorch does not expose a property)."""
    import torch
    p = torch.cuda.get_device_properties(
        torch.cuda.current_device() if device_index is None
        else device_index)
    return Budget(
        smem_per_block=int(getattr(p, "shared_memory_per_block_optin",
                                   H100_SMEM_OPTIN)),
        regs_per_sm=int(getattr(p, "regs_per_multiprocessor",
                                H100_REGS_PER_SM)))


# ---------------------------------------------------------------------------
# ptxas -v log
# ---------------------------------------------------------------------------

_BUILTIN = {"f": "float", "d": "double", "i": "int", "j": "unsigned int",
            "l": "long", "m": "unsigned long", "b": "bool", "c": "char",
            "h": "unsigned char", "s": "short", "t": "unsigned short",
            "x": "long long", "y": "unsigned long long", "v": "void"}


def _source_name(s: str, i: int) -> Tuple[str, int]:
    j = i
    while s[j].isdigit():
        j += 1
    n = int(s[i:j])
    return s[j:j + n], j + n


def _nested(s: str, i: int) -> Tuple[List[str], int]:
    """Components of N...E starting after the N (substitutions skipped);
    stops before a template-args I or after the closing E."""
    parts = []
    while s[i] not in "IE":
        if s[i] == "S":                  # substitution S_ / S<seq>_
            i = s.index("_", i) + 1
        else:
            name, i = _source_name(s, i)
            parts.append(name)
    return parts, i


def _template_args(s: str, i: int) -> Tuple[List[str], int]:
    """Arguments of I...E starting after the I; returns past the E."""
    args = []
    while s[i] != "E":
        c = s[i]
        if c == "L":                     # literal: L <type> <value> E
            j = s.index("E", i)
            args.append(s[i + 2:j].replace("n", "-"))
            i = j + 1
        elif c == "N":
            parts, i = _nested(s, i + 1)
            args.append(parts[-1] if parts else "?")
            i += 1                       # the nested name's E
        elif c.isdigit():
            name, i = _source_name(s, i)
            args.append(name)
        elif c == "S":
            i = s.index("_", i) + 1
            args.append("?")
        else:
            args.append(_BUILTIN.get(c, c))
            i += 1
    return args, i + 1


def demangle(sym: str) -> str:
    """``name<template arguments>`` of a mangled ``__global__`` function
    (the subset of the Itanium ABI nvcc emits for the port's kernels:
    namespaced or not, templated on types and values), the form the
    launchers' ``LaunchRec.fn`` uses. An unrecognised symbol comes back
    unchanged."""
    try:
        if not sym.startswith("_Z"):
            return sym
        i = 2
        if sym[i] == "N":
            parts, i = _nested(sym, i + 1)
            name = parts[-1]
        else:
            name, i = _source_name(sym, i)
        if sym[i] == "I":
            args, i = _template_args(sym, i + 1)
            return f"{name}<{','.join(args)}>"
        return name
    except (IndexError, ValueError):
        return sym


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def parse_ptxas_log(log: str) -> Dict[str, FunctionResources]:
    """{function: resources} of every entry function in a ``ptxas -v``
    log. A function built twice (two translation units, or a log that
    repeats) keeps the larger of each figure."""
    out: Dict[str, FunctionResources] = {}
    cur: Optional[str] = None
    vals: Dict[str, int] = {}

    def flush():
        if cur is None:
            return
        fn = demangle(cur)
        r = FunctionResources(fn, vals.get("regs", 0), vals.get("smem", 0),
                              vals.get("st", 0), vals.get("ld", 0))
        old = out.get(fn)
        if old is not None:
            r = FunctionResources(fn, *(max(a, b) for a, b in zip(
                dataclasses.astuple(old)[1:], dataclasses.astuple(r)[1:])))
        out[fn] = r

    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            flush()
            cur, vals = m.group(1), {}
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            vals["st"], vals["ld"] = int(m.group(1)), int(m.group(2))
        m = _USED.search(line)
        if m:
            vals["regs"] = int(m.group(1))
            s = _SMEM.search(line)
            vals["smem"] = int(s.group(1)) if s else 0
    flush()
    return out


@functools.lru_cache(maxsize=1)
def kernel_resources() -> Dict[str, FunctionResources]:
    """Resources of every kernel of the built library (builds it)."""
    from repro_torch.kernels import build
    return parse_ptxas_log(build.library().log)


# ---------------------------------------------------------------------------
# the budget
# ---------------------------------------------------------------------------


def check_budget(launches: Iterable, resources: Dict[str, FunctionResources],
                 budget: Budget = Budget()) -> List[str]:
    """A message for each launch (``build.Launch``) that does not fit the
    budget or that the ptxas log does not price."""
    msgs = []
    for ln in launches:
        r = resources.get(ln.fn)
        if r is None:
            msgs.append(f"launch of '{ln.fn}' is unpriced: no such entry "
                        "function in the ptxas log")
            continue
        smem = r.static_smem + ln.smem
        if smem > budget.smem_per_block:
            msgs.append(
                f"'{ln.fn}' grid={ln.grid} needs {smem} B of shared memory "
                f"({r.static_smem} static + {ln.smem} dynamic) > "
                f"{budget.smem_per_block} B a block can have")
        if r.registers * ln.threads > budget.regs_per_sm:
            msgs.append(
                f"'{ln.fn}' needs {r.registers} registers x {ln.threads} "
                f"threads = {r.registers * ln.threads} > "
                f"{budget.regs_per_sm} registers of an SM")
    return msgs


def assert_fits(launches: Iterable,
                resources: Optional[Dict[str, FunctionResources]] = None,
                budget: Optional[Budget] = None) -> None:
    """Named pre-launch gate: raise :class:`SmemBudgetError` if any of
    ``launches`` (from :func:`repro_torch.kernels.build.launch_config`)
    does not fit — use before handing a new shape to a kernel."""
    msgs = check_budget(launches,
                        kernel_resources() if resources is None
                        else resources,
                        device_budget() if budget is None else budget)
    if msgs:
        raise SmemBudgetError("; ".join(msgs))
