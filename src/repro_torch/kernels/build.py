"""Build and load the port's CUDA C++ kernels.

The sources under ``csrc/`` have a plain C interface. On first use each
``.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, the objects are linked into one shared library,
and the library is loaded with ``ctypes``. The build lands in
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import time: this module is
imported on machines without ``nvcc`` or a GPU, where only the kernels'
plain versions run.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("gqa_decode_attn.cu", "block_pruned_matmul.cu",
           "fused_pruned_ffn.cu", "pruned_grad.cu", "mla_decode_attn.cu",
           "unfused_gqa_decode_attn.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point: pointers and the stream as c_void_p,
# so ctypes never cuts a 64-bit address down to an int
SIGNATURES = {
    "repro_gqa_decode_attn": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _F, _I, _I, _I, _P),
    "repro_gqa_paged_decode_attn": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                    _I, _I, _P),
    "repro_mla_decode_attn": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _F, _I, _I, _P),
    "repro_mla_paged_decode_attn": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                                    _P),
    "repro_block_pruned_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _P),
    "repro_pruned_ffn_hidden": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P),
    "repro_pruned_ffn_hidden_tc": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _P),
    "repro_pruned_matmul_dx": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P),
    "repro_pruned_matmul_dw": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P),
    "repro_outpruned_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _P),
    "repro_outpruned_matmul_dx": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _P),
    "repro_block_pruned_matmul_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _P),
    "repro_outpruned_matmul_dw": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _P),
    "repro_unfused_gqa_decode_attn": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _F, _I, _I, _P),
}
# each launcher family's repro_<family>_launch_config: its integer
# arguments, then a LaunchRec array it fills; returns the launch count
CONFIG_SIGNATURES = {
    "repro_gqa_decode_attn": 7,           # B, Hkv, G, D, Dv, ranges, dtype
    "repro_gqa_paged_decode_attn": 7,     # B, Hkv, G, D, Dv, ranges, dtype
    "repro_mla_decode_attn": 7,           # B, H, R, Dr, splits, paged, dtype
    "repro_block_pruned_matmul": 6,       # M, N, kb, block, splits, dtype
    "repro_block_pruned_matmul_tc": 8,    # M, K, N, kb, block, x_compact,
                                          # splits, dtype
    "repro_pruned_ffn_hidden": 7,         # M, K, kb, block, gated, splits,
                                          # dtype
    "repro_pruned_ffn_hidden_tc": 7,      # M, K, kb, block, gated, splits,
                                          # dtype
    "repro_pruned_matmul_dx": 8,          # M, N, nb, kb, block, compact,
                                          # splits, dtype
    "repro_pruned_matmul_dw": 8,          # M, N, nb, kb, block, compact,
                                          # splits, dtype
    "repro_outpruned_matmul": 7,          # M, K, H, kb, block, splits, dtype
    "repro_outpruned_matmul_dx": 7,       # M, K, H, kb, block, splits,
                                          # dtype
    "repro_outpruned_matmul_dw": 7,       # M, K, nb, kb, block, splits,
                                          # dtype
    "repro_unfused_gqa_decode_attn": 7,   # B, Hkv, G, S, D, Dv, dtype
}
MAX_LAUNCHES = 4                          # kMaxLaunches in common.cuh


class LaunchRec(ctypes.Structure):
    """``LaunchRec`` of common.cuh: one kernel launch as its launcher
    makes it."""

    _fields_ = [("fn", ctypes.c_char * 96), ("grid", ctypes.c_int * 3),
                ("threads", ctypes.c_int), ("smem", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch: the ``__global__`` function as
    ``name<template arguments>``, grid, threads per block and dynamic
    shared memory in bytes."""

    fn: str
    grid: tuple
    threads: int
    smem: int


@dataclasses.dataclass
class KernelLibrary:
    """A loaded build: the ctypes handle, where it lives, how it was made."""

    lib: ctypes.CDLL
    path: Path
    built: bool          # False when an earlier build of these sources was reused
    seconds: float       # wall time of build + load
    log: str             # nvcc / ptxas output (registers, shared memory, spills)


def build_root() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built from "
        "source on the machine with the GPU (PATH or /usr/local/cuda/bin)")


def _compile(out_dir: Path) -> str:
    """Compile every source in parallel, link one shared library into
    ``out_dir``; returns the compiler output. Raises on any failure."""
    nvcc = find_nvcc()
    procs = []
    for src in SOURCES:
        obj = out_dir / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(out_dir / LIB_NAME),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"== link\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n"
                           + "\n".join(log))
    return "\n".join(log)


@functools.lru_cache(maxsize=1)
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process."""
    t0 = time.perf_counter()
    final = build_root() / source_hash()
    lib_path = final / LIB_NAME
    built, log = False, ""
    if not lib_path.exists():
        build_root().mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=build_root()))
        try:
            log = _compile(tmp)
            (tmp / "build.log").write_text(log)
            try:
                os.replace(tmp, final)
            except OSError:
                if not lib_path.exists():   # not a concurrent build's win
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        built = True
    elif (final / "build.log").exists():
        log = (final / "build.log").read_text()
    lib = ctypes.CDLL(str(lib_path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    for name, n_ints in CONFIG_SIGNATURES.items():
        fn = getattr(lib, name + "_launch_config")
        fn.argtypes = [_I] * n_ints + [ctypes.POINTER(LaunchRec)]
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=lib_path, built=built,
                         seconds=time.perf_counter() - t0, log=log)


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def launch_config(entry: str, *ints: int) -> tuple:
    """The launches ``entry`` makes for these integer arguments (its
    ``*_launch_config`` export, the function the launcher itself launches
    from), without launching anything."""
    if len(ints) != CONFIG_SIGNATURES[entry]:
        raise ValueError(f"{entry}_launch_config takes "
                         f"{CONFIG_SIGNATURES[entry]} integers, got "
                         f"{len(ints)}")
    recs = (LaunchRec * MAX_LAUNCHES)()
    n = getattr(library().lib, entry + "_launch_config")(
        *[int(v) for v in ints], recs)
    if not 0 < n <= MAX_LAUNCHES:
        raise ValueError(f"{entry}_launch_config refused {ints}")
    return tuple(Launch(r.fn.decode(), tuple(r.grid), r.threads, r.smem)
                 for r in recs[:n])
