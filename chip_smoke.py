#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line of its own; any failure exits non-zero:

1. setup    — refuse to run without CUDA; print the card's name and power
              limit (nvidia-smi); build the CUDA C++ kernels from
              ``src/repro_torch/kernels/csrc`` (one nvcc per source, all
              started together) and print the build seconds.
2. kernels  — each kernel against its plain PyTorch version on the card,
              at the shapes full-width Yi-6B and DeepSeek-V2-Lite serving
              with 8 slots give it, in float32 (max |err| <= 1e-4 * max
              |ref|) and bfloat16 (max |err| <= 2e-2 * max |ref|), plus
              block 8 at a small shape; the decode attentions (#1, #4-#7)
              write into NaN-filled outputs, #1 and #5 reading caches
              whose unattended rows are NaN and #4 and #6 pools whose
              unreferenced pages are NaN (ragged positions, one invalid
              lane, a shuffled page order, trailing -1 entries), twice,
              for the same bits; each timed with CUDA events beside its
              plain version, a one-call PyTorch yardstick where one
              exists, and its bound at 3.35 TB/s and 989 (bf16) / 67 (f32)
              TFLOP/s (the tensor-core kernels' f32 also at 3xTF32's
              495/3), the yardstick's device time beside its event time;
              #5 and #6 also at a DeepSeek-V2-Lite decode step's positions
              (8 slots attending 64-320 rows); the unfused decode
              attention (#7, the baseline of the fused one) at #1's shapes
              and positions, with a second bound for its own traffic
              (every K/V row and the f32 score matrix), and at the shapes
              and positions of the analysis phase's micro_kernel probe,
              where its launches come from; for #5-#7 in bf16 one line of
              device ms per call by launch (partial and merge; scores,
              softmax and wsum) beside the bound; #3 (the pruned FFN) in
              one line per case by stage, the hidden stage and the down
              product, each beside its bound.
   analysis — the port's static invariant gate on the card:
              ``python -m repro_torch.analysis --check --mutate`` must
              return 0 (the train, serve-decode and serve-engine steps
              at smoke width, the collective probes and every kernel
              wrapper linted against R1-R5; every mutant fires); one line
              per kernel function: registers, static and dynamic shared
              memory at the cases' shapes, spills. Its counts are the
              launches of #7.
3. reference — decode steps of two-layer, full-width models in float32
              under a resizing plan, the kernel path against the plain
              path on the same inputs: Yi-6B over the slot cache and over
              the paged pool, DeepSeek-V2-Lite (dense layer + MoE layer)
              over the slot cache and over the paged pool; then both at
              tp 4 (emulated in one process): a plan that resizes rank 1
              and migrates 2 blocks from rank 0, kernel path against
              plain path, and the lossless plan (rank 0 migrating, no
              resize) on the kernel path against the tp-1 dense step
              (DeepSeek: against its plain path, since its dense layer is
              wider than the "ffn" lists, which a source keeps alone, as
              in the JAX package).
4. serve    — the port's ServeEngine serves 16 requests at full Yi-6B
              width (32 layers, bf16, random weights from a seed) under
              ZERO-resizing with a contended simulated 8-rank group and
              both kernel switches on; every launch count is set to 0
              just before and read just after, and each must be > 0.
5. profile  — eight decode-only steps of the same engine under
              torch.profiler: wall vs device-kernel time per step and
              the device time by kernel family; #3's hidden stage, where
              a resized step runs it, only through its decode kernel
              (also in paged-profile and mla-profile).
   paged-serve — the same run over the paged pool (page 16, 96 pages):
              it must preempt, and #2, #3, #4 must launch.
   paged-profile — eight decode-only steps of the paged engine under
              torch.profiler, as phase 5 (#4 on its main path; phase 5
              must run #1's SlotRows form, this one #4's PagedRows form).
   semi-serve — the same traffic at full Yi-6B width over a TP group of
              4 ranks under SEMI (lossless β, 8 simulated ranks, at most 3
              migration sources): #1 and #3 must launch, a step must
              migrate, a step may resize only a straggler past the
              migrating prefix; host wall tokens/s, step wall p50 / p95,
              peak memory; then 8 of the requests over 4 simulated ranks
              (no fold, contention p 0.2), where a step must migrate and
              none may resize; then the uncontended tp-1 dense run of the
              same traffic, and the share of requests whose tokens agree
              (information only).
   mla-serve — the same traffic and control at full DeepSeek-V2-Lite
              width (27 layers, MLA + MoE, bf16), over the slot cache
              (#3, #5 must launch) and over a paged pool of 160 pages
              (#3, #6), which holds the traffic's peak, so both runs step
              through the same plans; the share of requests whose tokens
              agree between the two runs is printed (information only).
   mla-profile — eight decode-only steps of the paged DeepSeek engine
              under torch.profiler, as phase 5.
6. grad-kernels — the backward family (#8-#12) against its plain
              versions at the shapes the ViT-1B train run gives it
              (tp 4, 520 rows, block 8), f32 and bf16 with the same
              tolerances, every output NaN-filled before the launch so a
              skipped element shows, and a second call that must give the
              same bits; block 128 at a small shape with the compact modes
              and an unsorted keep list; each timed like phase 2 (#8, #9,
              #10, #11 and #12, on the tensor cores, also beside a 3xTF32
              bound at 495/3 TFLOP/s), plus the forward kernels at the
              train shapes (#2 at wq_r and wo_r on the tensor-core core,
              with the library's device time; #3 twice for the same bits,
              and by stage as in phase 2).
7. train-reference — one controlled step (rank 0 resized and a migration
              source) of a two-layer, full-width ViT-1B in f32 at tp 4:
              loss and every gradient, kernel path against plain path.
8. train    — the port's run_training on full-width ViT-1B (24 layers,
              f32, random weights from a seed) at tp 4 under SEMI for 12
              steps; every launch count set to 0 just before and read just
              after, and each kernel of the path must be > 0; every loss
              finite; at least one resized and one migrating step.
9. train-profile — three steps of the same model under the run's plan,
              under torch.profiler: wall vs device time, by family, and
              the block-pruned kernels by name (#2 and both stages of #3
              on the tensor-core core, #8-#12; no CUDA-core product left).
   resume   — checkpoint / resume of full-width ViT-1B cut to 4 layers
              (f32, tp 4, SEMI, measured times): 8 steps uninterrupted
              against 4 steps and a resumed run to 8; losses, plans,
              chi_hat and every parameter and moment after step 8 must be
              bit-identical; checkpoint bytes, save and load seconds. Then
              a two-layer full-width Yi-6B f32 checkpoint loaded by
              ServeEngine(ckpt_dir=...) in bf16 answers two requests.

Then one JSON line of per-kernel numbers (launches of each kernel from
the run of its path: #1-#3 phase 4, #4 paged-serve, #5 / #6 the two
mla-serve runs, #7 the analysis phase, the backward family phase 8) and,
last, the JSON line
``{"ok": true, "device": {...}}``. The engines' latencies are MODELED (a
host-CPU calibration) and are not printed as card times; the serve and
train phases print host wall-clock numbers only.
"""
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,
              # f32 products on the tensor cores as 3xTF32 (#2, #8-#12)
              "3xtf32": 495e12 / 3}
TENSOR_CORE_F32 = ("block_pruned_matmul", "pruned_matmul_dx",
                   "pruned_matmul_dw", "outpruned_matmul",
                   "outpruned_matmul_dx", "outpruned_matmul_dw")
F32_TOL, BF16_TOL = 1e-4, 2e-2
REPLACES = {
    "block_pruned_matmul": "src/repro/kernels/pruned_matmul.py:81",
    "fused_pruned_ffn": "src/repro/kernels/pruned_matmul.py:547",
    "fused_decode_attention": "src/repro/kernels/decode_attn.py:129",
    "pruned_matmul_dx": "src/repro/kernels/pruned_matmul.py:165",
    "pruned_matmul_dw": "src/repro/kernels/pruned_matmul.py:255",
    "outpruned_matmul": "src/repro/kernels/pruned_matmul.py:330",
    "outpruned_matmul_dx": "src/repro/kernels/pruned_matmul.py:388",
    "outpruned_matmul_dw": "src/repro/kernels/pruned_matmul.py:453",
    "fused_paged_decode_attention": "src/repro/kernels/decode_attn.py:444",
    "fused_mla_decode_attention": "src/repro/kernels/decode_attn.py:227",
    "fused_paged_mla_decode_attention": "src/repro/kernels/decode_attn.py:546",
    "unfused_decode_attention": "src/repro/kernels/decode_attn.py:317",
}
_GRAD_CU = "src/repro_torch/kernels/csrc/pruned_grad.cu"
SOURCES = {
    "block_pruned_matmul": "src/repro_torch/kernels/csrc/block_pruned_matmul.cu",
    "fused_pruned_ffn": "src/repro_torch/kernels/csrc/fused_pruned_ffn.cu",
    "fused_decode_attention": "src/repro_torch/kernels/csrc/gqa_decode_attn.cu",
    "pruned_matmul_dx": _GRAD_CU,
    "pruned_matmul_dw": _GRAD_CU,
    "outpruned_matmul": _GRAD_CU,
    "outpruned_matmul_dx": _GRAD_CU,
    "outpruned_matmul_dw": _GRAD_CU,
    "fused_paged_decode_attention":
        "src/repro_torch/kernels/csrc/gqa_decode_attn.cu",
    "fused_mla_decode_attention":
        "src/repro_torch/kernels/csrc/mla_decode_attn.cu",
    "fused_paged_mla_decode_attention":
        "src/repro_torch/kernels/csrc/mla_decode_attn.cu",
    "unfused_decode_attention":
        "src/repro_torch/kernels/csrc/unfused_gqa_decode_attn.cu",
}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def bound_ms(nbytes, flops, dtype_name):
    """Least time for the work: bytes over HBM rate vs flops over peak."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[dtype_name]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.config import get_config
    from repro_torch.control import ControlConfig
    from repro_torch.control import scopes as scopes_lib
    from repro_torch.core.workload import PlanStatic, keep_blocks_for_bucket
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.layers.tp_linear import ControlContext
    from repro_torch.models import lm as lm_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = kbuild.library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("setup", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; kernels built in {lib.seconds:.1f} s "
        f"(fresh build: {lib.built}) -> {lib.path.name}")
    for ln in ptxas:
        say("setup", f"ptxas: {ln}")

    # ---------------------------------------------------------------- 2
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def copies_for(nbytes):
        # rotate over enough input sets that consecutive launches find
        # their weights cold in the 50 MB L2, as the serve loop does
        return max(1, min(32, math.ceil(200e6 / max(nbytes, 1))))

    def time_ms(fn, n_sets, iters=20):
        for i in range(3):
            fn(i % n_sets)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for i in range(iters):
            fn(i % n_sets)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    from torch.profiler import ProfilerActivity, profile

    def kernel_times(prof):
        """[(kernel name, calls, device ms)] of one profiler window."""
        rows = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us > 0:
                rows.append((e.key, e.count, us / 1e3))
        return sorted(rows, key=lambda r: -r[2])

    def profiled_kernels(fn, n_sets, iters=10):
        """[(kernel name, calls, device ms)] of ``iters`` calls under the
        profiler, and the number of calls. On this card the profiler has
        dropped kernel records: device-only windows late in this script
        (phase 6) have held none, or only some, of the kernels their calls
        launched. So the window records CPU activity too, and is checked
        by name against the launches the port's wrappers report in it:
        for each of their ``__global__`` functions, at least as many
        records whose name holds it as launches of it. Records of other
        kernels (casts, memsets) count for nothing. A window that falls
        short is taken again, longer (up to three times)."""
        for attempt, n in enumerate((iters, 4 * iters, 10 * iters)):
            fn(0)
            torch.cuda.synchronize()
            want = {}

            def hook(name, launches):
                for ls in launches:
                    base = ls.fn.split("<")[0]
                    want[base] = want.get(base, 0) + 1
            prev = ops.set_launch_hook(hook)
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for i in range(n):
                        fn(i % n_sets)
                    torch.cuda.synchronize()
            finally:
                ops.set_launch_hook(prev)
            rows = kernel_times(prof)
            short = {base: (sum(c for k, c, _ in rows if base in k), w)
                     for base, w in want.items()}
            short = {b: gw for b, gw in short.items() if gw[0] < gw[1]}
            if rows and want and not short:
                return rows, n
            say("profiler", f"attempt {attempt + 1}: window of {n} calls; "
                "records / launches of the port's kernels short: " + (
                    ", ".join(f"{b} {g}/{w}" for b, (g, w) in short.items())
                    or f"{len(want)} kernels launched, {len(rows)} records"
                ) + "; taken again")
        return [], iters

    def device_ms(fn, n_sets, iters=10):
        """Device time per call (sum of its kernels, from the profiler):
        what the card spends, without the host's launch gaps. None when
        the profiler records no device activity."""
        rows, n = profiled_kernels(fn, n_sets, iters)
        total = sum(r[2] for r in rows)
        return total / n if total > 0 else None

    def library_device_ms(fn, n_sets, iters=10):
        """Device time per call of a library yardstick, from the profiler:
        it launches none of the port's kernels, so every kernel record of
        the window counts (None without a yardstick or without records)."""
        if fn is None:
            return None
        for i in range(3):
            fn(i % n_sets)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i % n_sets)
            torch.cuda.synchronize()
        total = sum(r[2] for r in kernel_times(prof))
        return total / iters if total > 0 else None

    def errs(got, ref):
        g, r = got.float(), ref.float()
        return float((g - r).abs().max()), float(r.abs().max())

    checked, failures = [], []
    per_kernel = {}

    def record(name, case, dtype, got, ref, timings, nbytes, flops,
               representative, phase="kernels", tensor_cores=False):
        e, m = errs(got, ref)
        finite = bool(torch.isfinite(got.float()).all())
        tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * m
        ok = finite and e <= tol
        dname = str(dtype).replace("torch.", "")
        b_ms, b_by = bound_ms(nbytes, flops, dname)
        checked.append(f"{name} {case} {dname}")
        t = ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else
                      f"{k} {v}" for k, v in timings.items())
        tc = ""
        if (name in TENSOR_CORE_F32 or tensor_cores) \
                and dname == "float32" and flops:
            tc_ms, tc_by = bound_ms(nbytes, flops, "3xtf32")
            tc = f"; 3xTF32 tensor-core bound {tc_ms:.4f} ms ({tc_by})"
        say(phase, f"{name} {case} {dname}: max|err| {e:.3e} "
            f"(max|ref| {m:.3e}, rel {e / max(m, 1e-30):.2e}) "
            f"{'ok' if ok else 'FAIL'}; {t}; bound {b_ms:.4f} ms "
            f"({b_by}){tc}")
        if not ok:
            failures.append(f"{name} {case} {dname}")
        if representative:
            per_kernel[name] = {"max_abs_err": e, "bound_ms": b_ms,
                                "bound_by": b_by, **timings}

    B, D_MODEL, D_FF, VOCAB = 8, 4096, 11008, 64000
    full = get_config("yi-6b")
    kv_dim = full.num_kv_heads * full.resolved_head_dim   # 512
    nb_qkv, nb_ffn, blk = D_MODEL // 128, D_FF // 128, 128
    bucket_lo, bucket_hi = 1, 7                            # γ 0.125 / 0.875

    def sorted_keep(nb, kc, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.sort(torch.randperm(nb, generator=g)[:kc]).values.to(
            torch.int32).to(dev)

    # -- block-pruned matmul ------------------------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        for wname, N in (("wq", D_MODEL), ("wk", kv_dim)):
            for bucket in (bucket_lo, bucket_hi):
                kc = keep_blocks_for_bucket(
                    (0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)[bucket],
                    nb_qkv)
                keep = sorted_keep(nb_qkv, kc, bucket)
                n_sets = copies_for(D_MODEL * N * es)
                xs = [rnd((B, D_MODEL), dtype) for _ in range(n_sets)]
                ws = [rnd((D_MODEL, N), dtype, 0.02) for _ in range(n_sets)]
                got = ops.block_pruned_matmul(xs[0], ws[0], keep, block=blk)
                ref = ops.block_pruned_matmul_plain(xs[0], ws[0], keep, blk)
                xk = [x.reshape(B, nb_qkv, blk)[:, keep.long()].reshape(B, -1)
                      for x in xs]
                wk = [w.reshape(nb_qkv, blk, N)[keep.long()].reshape(-1, N)
                      for w in ws]
                timings = {
                    "ms": time_ms(lambda i: ops.block_pruned_matmul(
                        xs[i], ws[i], keep, block=blk), n_sets),
                    "device_ms": device_ms(lambda i: ops.block_pruned_matmul(
                        xs[i], ws[i], keep, block=blk), n_sets),
                    "plain_ms": time_ms(lambda i: ops.block_pruned_matmul_plain(
                        xs[i], ws[i], keep, blk), n_sets),
                    "library_ms": time_ms(lambda i: torch.matmul(xk[i], wk[i]),
                                          n_sets),
                    "library_device_ms": library_device_ms(
                        lambda i: torch.matmul(xk[i], wk[i]), n_sets)}
                K_kept = kc * blk
                nbytes = (B * K_kept + K_kept * N + B * N) * es + kc * 4
                record("block_pruned_matmul",
                       f"{wname} x[8,4096]@[4096,{N}] keep {kc}/{nb_qkv}",
                       dtype, got, ref, timings, nbytes, 2 * B * K_kept * N,
                       dtype == torch.bfloat16 and wname == "wq"
                       and bucket == bucket_lo)
                del xs, ws, xk, wk
        # block 8 at the smoke width
        x, w = rnd((B, 256), dtype), rnd((256, 96), dtype, 0.1)
        keep = sorted_keep(32, 20, 8)
        got = ops.block_pruned_matmul(x, w, keep, block=8)
        ref = ops.block_pruned_matmul_plain(x, w, keep, 8)
        record("block_pruned_matmul", "block 8 x[8,256]@[256,96] keep 20/32",
               dtype, got, ref, {}, (B * 160 + 160 * 96 + B * 96) * es,
               2 * B * 160 * 96, False)

    # -- pruned FFN ---------------------------------------------------------
    def short_name(name):
        """A profiler record's kernel as function<template arguments>."""
        name = re.sub(r"\(anonymous namespace\)::|^void ", "", name)
        return name.split("(")[0][:70]

    def ffn_stages(phase, case, fn, n_sets, hidden_bound, down_bound,
                   tc_bounds=None):
        """One line: #3's device ms per call by stage (the profiler's, by
        __global__ function: the down product's are #2's decode kernel or
        its policy on the tensor-core core, and its split sum; the rest is
        the hidden stage), each beside its bound (and, for f32 on the
        tensor cores, its 3xTF32 bound)."""
        krows, n = profiled_kernels(fn, n_sets)
        down = sum(ms for k, _, ms in krows
                   if "bpm_decode" in k or "BpmPolicy" in k
                   or "reduce_splits" in k) / n
        hidden = sum(ms for k, _, ms in krows) / n - down
        names = sorted({short_name(k) for k, _, _ in krows})
        tc = (f"; 3xTF32 bounds {tc_bounds[0]:.4f} / {tc_bounds[1]:.4f}"
              if tc_bounds else "")
        say(phase, f"fused_pruned_ffn {case}: hidden stage {hidden:.4f} ms "
            f"(bound {hidden_bound[0]:.4f}, {hidden_bound[1]}), down product "
            f"{down:.4f} ms (bound {down_bound[0]:.4f}, {down_bound[1]})"
            f"{tc}; functions {names}")

    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        n_sets = copies_for(3 * D_MODEL * D_FF * es)
        xs = [rnd((B, D_MODEL), dtype) for _ in range(n_sets)]
        wus = [rnd((D_MODEL, D_FF), dtype, 0.02) for _ in range(n_sets)]
        wgs = [rnd((D_MODEL, D_FF), dtype, 0.02) for _ in range(n_sets)]
        wds = [rnd((D_FF, D_MODEL), dtype, 0.02) for _ in range(n_sets)]
        for bucket in (bucket_lo, bucket_hi):
            kc = keep_blocks_for_bucket(
                (0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)[bucket],
                nb_ffn)
            keep = sorted_keep(nb_ffn, kc, 100 + bucket)
            got = ops.fused_pruned_ffn(xs[0], wus[0], wds[0], keep, wgs[0],
                                       ops.silu, blk)
            ref = ops.fused_pruned_ffn_plain(xs[0], wus[0], wds[0], keep,
                                             wgs[0], ops.silu, blk)
            timings = {
                "ms": time_ms(lambda i: ops.fused_pruned_ffn(
                    xs[i], wus[i], wds[i], keep, wgs[i], ops.silu, blk),
                    n_sets),
                "device_ms": device_ms(lambda i: ops.fused_pruned_ffn(
                    xs[i], wus[i], wds[i], keep, wgs[i], ops.silu, blk),
                    n_sets),
                "plain_ms": time_ms(lambda i: ops.fused_pruned_ffn_plain(
                    xs[i], wus[i], wds[i], keep, wgs[i], ops.silu, blk),
                    n_sets),
                # no single PyTorch call computes a gated pruned FFN
                "library_ms": None}
            C = kc * blk
            nbytes = (B * D_MODEL + 3 * D_MODEL * C + B * D_MODEL) * es + kc * 4
            flops = 2 * B * D_MODEL * C * 2 + 2 * B * C * D_MODEL
            record("fused_pruned_ffn",
                   f"x[8,4096] Wup/Wgate[4096,11008] Wdown[11008,4096] silu "
                   f"keep {kc}/{nb_ffn}", dtype, got, ref, timings, nbytes,
                   flops, dtype == torch.bfloat16 and bucket == bucket_lo)
            ffn_stages(
                "kernels", f"keep {kc}/{nb_ffn} {str(dtype)[6:]}",
                lambda i: ops.fused_pruned_ffn(xs[i], wus[i], wds[i], keep,
                                               wgs[i], ops.silu, blk),
                n_sets,
                bound_ms((B * D_MODEL + 2 * D_MODEL * C + B * C) * es
                         + kc * 4, 4 * B * D_MODEL * C, str(dtype)[6:]),
                bound_ms((B * C + C * D_MODEL + B * D_MODEL) * es + kc * 4,
                         2 * B * C * D_MODEL, str(dtype)[6:]))
        del xs, wus, wgs, wds
        # block 8 at the smoke width, gated and ungated
        x = rnd((B, 256), dtype)
        wu, wg, wd = (rnd((256, 512), dtype, 0.1), rnd((256, 512), dtype, 0.1),
                      rnd((512, 256), dtype, 0.1))
        keep = sorted_keep(64, 40, 9)
        for gate, act, tag in ((wg, ops.silu, "silu"), (None, ops.gelu, "gelu")):
            got = ops.fused_pruned_ffn(x, wu, wd, keep, gate, act, 8)
            ref = ops.fused_pruned_ffn_plain(x, wu, wd, keep, gate, act, 8)
            record("fused_pruned_ffn", f"block 8 smoke {tag} keep 40/64",
                   dtype, got, ref, {}, 0, 0, False)

    def nan_out(shape, dtype):
        return torch.full(shape, float("nan"), dtype=dtype, device=dev)

    def written(got, out, name):
        if got.data_ptr() != out.data_ptr():
            raise SystemExit(f"{name}: the kernel did not write into `out`")
        return got

    def same_bits(outs, name):
        """The first of two calls' outputs, after checking they agree bit
        for bit (the merges sum in a fixed order)."""
        torch.cuda.synchronize()
        if not torch.equal(outs[0], outs[1]):
            failures.append(f"{name}: two calls differ")
            say("kernels", f"{name}: two calls differ (FAIL)")
        return outs[0]

    def launch_split(name, where, fn, n_sets, labels, bound):
        """One line: the device ms per call of each __global__ function
        of the wrapper's launches (the profiler's), beside the bound."""
        krows, n = profiled_kernels(fn, n_sets)
        say("kernels", f"{name} {where} bf16, device ms per call by "
            "launch: " + "; ".join(
                f"{next((w for w in labels if w in k), k[:40])} "
                f"{ms / n:.4f}" for k, _, ms in krows)
            + f"; bound {bound:.4f}")

    # -- fused GQA decode attention -------------------------------------------
    Hq, Hkv, S, D = full.num_heads, full.num_kv_heads, 1024, 128
    cur_np = np.asarray([0, 127, 128, S - 1, 2 ** 30, 31, 500, 777], np.int32)
    cur = torch.from_numpy(cur_np).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        n_sets = copies_for(2 * B * Hkv * S * D * es)
        qs = [rnd((B, Hq, 1, D), dtype) for _ in range(n_sets)]
        ks = [rnd((B, Hkv, S, D), dtype) for _ in range(n_sets)]
        vs = [rnd((B, Hkv, S, D), dtype) for _ in range(n_sets)]
        for window in (0, 200):
            pos = torch.arange(S, device=dev)[None, :]
            mask = pos <= cur.long()[:, None]
            if window:
                mask = mask & (pos > cur.long()[:, None] - window)
            mask = mask[:, None, None, :]
            # the check reads caches whose unattended rows are NaN (the
            # kernel must never read them) into NaN-filled outputs, twice
            unread = ~mask[:, :, 0, :, None].expand_as(ks[0])
            k_nan = ks[0].masked_fill(unread, float("nan"))
            v_nan = vs[0].masked_fill(unread, float("nan"))
            got = same_bits([written(ops.fused_decode_attention(
                qs[0], k_nan, v_nan, cur_pos=cur, window=window, out=out),
                out, "fused_decode_attention")
                for out in (nan_out((B, Hq, 1, D), dtype),
                            nan_out((B, Hq, 1, D), dtype))],
                "fused_decode_attention")
            ref = ops.gqa_decode_attn_plain(qs[0], ks[0], vs[0], cur, window)
            del k_nan, v_nan, unread

            # the yardstick: SDPA with the position mask (K/V heads
            # expanded to the query heads outside the timing when this
            # PyTorch has no enable_gqa)
            try:
                F.scaled_dot_product_attention(qs[0], ks[0], vs[0],
                                               attn_mask=mask,
                                               enable_gqa=True)
                kx, vx, gqa = ks, vs, {"enable_gqa": True}
            except TypeError:
                kx = [k.repeat_interleave(Hq // Hkv, 1) for k in ks]
                vx = [v.repeat_interleave(Hq // Hkv, 1) for v in vs]
                gqa = {}

            def sdpa(i):
                return F.scaled_dot_product_attention(
                    qs[i], kx[i], vx[i], attn_mask=mask, **gqa)
            timings = {
                "ms": time_ms(lambda i: ops.fused_decode_attention(
                    qs[i], ks[i], vs[i], cur_pos=cur, window=window), n_sets),
                "device_ms": device_ms(lambda i: ops.fused_decode_attention(
                    qs[i], ks[i], vs[i], cur_pos=cur, window=window), n_sets),
                "plain_ms": time_ms(lambda i: ops.gqa_decode_attn_plain(
                    qs[i], ks[i], vs[i], cur, window), n_sets),
                "library_ms": time_ms(sdpa, n_sets),
                "library_device_ms": library_device_ms(sdpa, n_sets)}
            rows = int(mask.sum())                 # attended rows, all slots
            nbytes = (rows * Hkv * 2 * D + 2 * B * Hq * D) * es + B * 4
            flops = rows * (Hq // Hkv) * Hkv * 2 * 2 * D
            record("fused_decode_attention",
                   f"q[8,32,1,128] kv[8,4,1024,128] window {window} cur_pos "
                   f"{cur_np.tolist()}", dtype, got, ref, timings, nbytes,
                   flops, dtype == torch.bfloat16 and window == 0)
        del qs, ks, vs

    # -- unfused GQA decode attention (#7), the baseline of #1, at #1's
    # shapes and positions, into NaN-filled outputs, twice, for the same
    # bits: three launches with the f32 score matrix [8, 4, 8, 1024] in
    # device memory and every cache row read whatever cur_pos is. Two
    # bounds: the function's (the attended rows, as #1's) and the kernel's
    # own traffic (all K/V rows, the score matrix written, read, written
    # and read again)
    G = Hq // Hkv
    mask = (torch.arange(S, device=dev)[None, :]
            <= cur.long()[:, None])[:, None, None, :]
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        n_sets = copies_for(2 * B * Hkv * S * D * es)
        qs = [rnd((B, Hq, 1, D), dtype) for _ in range(n_sets)]
        ks = [rnd((B, Hkv, S, D), dtype) for _ in range(n_sets)]
        vs = [rnd((B, Hkv, S, D), dtype) for _ in range(n_sets)]
        got = same_bits([written(ops.unfused_decode_attention(
            qs[0], ks[0], vs[0], cur_pos=cur, out=out), out,
            "unfused_decode_attention")
            for out in (nan_out((B, Hq, 1, D), dtype),
                        nan_out((B, Hq, 1, D), dtype))],
            "unfused_decode_attention")
        ref = ops.unfused_gqa_decode_attn_plain(qs[0], ks[0], vs[0], cur)
        # the yardstick: SDPA with the position mask, reading the KV heads
        # itself where this PyTorch has enable_gqa (else expanded outside
        # the timing), as #1's
        try:
            F.scaled_dot_product_attention(qs[0], ks[0], vs[0],
                                           attn_mask=mask, enable_gqa=True)
            kx, vx, gqa = ks, vs, {"enable_gqa": True}
        except TypeError:
            kx = [k.repeat_interleave(G, 1) for k in ks]
            vx = [v.repeat_interleave(G, 1) for v in vs]
            gqa = {}

        def sdpa7(i):
            return F.scaled_dot_product_attention(
                qs[i], kx[i], vx[i], attn_mask=mask, **gqa)
        timings = {
            "ms": time_ms(lambda i: ops.unfused_decode_attention(
                qs[i], ks[i], vs[i], cur_pos=cur), n_sets),
            "device_ms": device_ms(lambda i: ops.unfused_decode_attention(
                qs[i], ks[i], vs[i], cur_pos=cur), n_sets),
            "plain_ms": time_ms(lambda i: ops.unfused_gqa_decode_attn_plain(
                qs[i], ks[i], vs[i], cur), n_sets),
            "library_ms": time_ms(sdpa7, n_sets),
            "library_device_ms": library_device_ms(sdpa7, n_sets)}
        rows = int(mask.sum())
        if dtype == torch.bfloat16:
            launch_split("unfused_decode_attention", "phase 2",
                         lambda i: ops.unfused_decode_attention(
                             qs[i], ks[i], vs[i], cur_pos=cur), n_sets,
                         ("scores", "softmax", "wsum"), bound_ms(
                             (rows * Hkv * 2 * D + 2 * B * Hq * D) * es
                             + B * 4, rows * Hq * 2 * 2 * D,
                             "bfloat16")[0])
        traffic = (2 * B * Hkv * S * D * es + 2 * B * Hq * D * es + B * 4
                   + 4 * B * Hkv * G * S * 4)
        record("unfused_decode_attention",
               f"q[8,32,1,128] kv[8,4,1024,128] cur_pos {cur_np.tolist()}; "
               f"the kernel's own traffic {traffic / 1e6:.1f} MB -> "
               f"{traffic / HBM_BYTES_PER_S * 1e3:.4f} ms", dtype, got, ref,
               timings, (rows * Hkv * 2 * D + 2 * B * Hq * D) * es + B * 4,
               rows * Hq * 2 * 2 * D, dtype == torch.bfloat16)
        del qs, ks, vs, kx, vx

    # ... and at the shapes and positions the analysis phase's micro_kernel
    # probe gives it (one table, repro_torch.analysis.micro), where its
    # launch count comes from: Hkv 8, G 4, S 256, an invalid lane
    from repro_torch.analysis.micro import PROBE_CUR_POS, PROBE_KV, PROBE_Q
    pcur = torch.tensor(PROBE_CUR_POS, dtype=torch.int32, device=dev)
    pB, pHkv, pS, pD = PROBE_KV
    pmask = (torch.arange(pS, device=dev)[None, :]
             <= pcur.long()[:, None])[:, None, None, :]
    prows = int(pmask.sum())
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        q, k, v = rnd(PROBE_Q, dtype), rnd(PROBE_KV, dtype), rnd(PROBE_KV,
                                                                  dtype)
        out = torch.full(PROBE_Q, float("nan"), dtype=dtype, device=dev)
        got = ops.unfused_decode_attention(q, k, v, cur_pos=pcur, out=out)
        if got.data_ptr() != out.data_ptr():
            raise SystemExit("unfused_decode_attention did not write into "
                             "`out`")
        ref = ops.unfused_gqa_decode_attn_plain(q, k, v, pcur)
        record("unfused_decode_attention",
               f"micro_kernel probe q{list(PROBE_Q)} kv{list(PROBE_KV)} "
               f"cur_pos {list(PROBE_CUR_POS)}", dtype, got, ref, {},
               (prows * pHkv * 2 * pD + 2 * pB * PROBE_Q[1] * pD) * es
               + pB * 4, prows * PROBE_Q[1] * 2 * 2 * pD, False)
        del q, k, v

    # -- paged GQA (#4) and absorbed-MLA decode attention over the slot
    # cache (#5) and the paged pool (#6), at the shapes full-width Yi-6B
    # and DeepSeek-V2-Lite serving give them: page 16, max_len 1024 (64
    # pages per slot), a pool of 8 x 64 pages. Each slot holds shuffled
    # pages up to its cur_pos (the invalid lane all but its last two, -1);
    # every page no table references is NaN, and so is every output before
    # the launch, so a kernel that read an unallocated page or skipped an
    # output element shows it.
    PS, PPS = 16, S // 16
    N_PAGES = B * PPS

    def table_for(positions):
        """The page table of slots at these positions, and the mask of
        the pool pages it does not reference."""
        perm = np.random.default_rng(4).permutation(N_PAGES)
        table = np.full((B, PPS), -1, np.int32)
        used = 0
        for b, c in enumerate(positions):
            n = PPS - 2 if c >= S else c // PS + 1
            table[b, :n] = perm[used:used + n]
            used += n
        unref_ = torch.ones(N_PAGES, dtype=torch.bool)
        unref_[torch.from_numpy(table[table >= 0]).long()] = False
        return torch.from_numpy(table).to(dev), unref_.to(dev)

    pages, unref = table_for(cur_np)
    H_MLA, R_MLA, DR_MLA, SCALE_DIM = 16, 512, 64, 192   # DeepSeek-V2-Lite
    # a decode step of the DeepSeek-V2-Lite serve: 8 slots, 64-320 rows
    MLA_STEP_CUR = np.asarray([63, 99, 136, 172, 209, 246, 282, 319],
                              np.int32)

    def nan_pool(t, unref_):
        """The pool t, in place, with NaN in every page no table
        references."""
        t[unref_] = float("nan")
        return t

    def sdpa_yardstick(q4, k4, v4, mask4, scale=None):
        """SDPA on pre-gathered rows (heads of K/V broadcast to the query
        heads where this PyTorch has no enable_gqa), or None where SDPA
        refuses the shapes."""
        def call(k_, v_, **kw):
            return F.scaled_dot_product_attention(q4, k_, v_, attn_mask=mask4,
                                                  scale=scale, **kw)
        try:
            try:
                call(k4, v4, enable_gqa=True)
                return lambda: call(k4, v4, enable_gqa=True)
            except TypeError:
                rep_ = q4.shape[1] // k4.shape[1]
                kx = k4.repeat_interleave(rep_, 1)
                vx = v4.repeat_interleave(rep_, 1)
                call(kx, vx)
                return lambda: call(kx, vx)
        except RuntimeError as e:
            say("kernels", f"SDPA refuses q {tuple(q4.shape)} k "
                f"{tuple(k4.shape)} v {tuple(v4.shape)}: {str(e)[:120]}")
            return None

    def lib_ms(fns, n_sets):
        return (time_ms(lambda i: fns[i](), n_sets) if fns[0] is not None
                else None)

    def lib_device_ms(fns, n_sets):
        return library_device_ms(
            (lambda i: fns[i]()) if fns[0] is not None else None, n_sets)

    from repro_torch.layers.attention import (gather_paged_kv,
                                              gather_paged_rows)
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        n_sets = copies_for(2 * N_PAGES * Hkv * PS * D * es)
        qs = [rnd((B, Hq, 1, D), dtype) for _ in range(n_sets)]
        kps = [nan_pool(rnd((N_PAGES, Hkv, PS, D), dtype), unref)
               for _ in range(n_sets)]
        vps = [nan_pool(rnd((N_PAGES, Hkv, PS, D), dtype), unref)
               for _ in range(n_sets)]
        for window in (0, 200):
            got = same_bits([written(ops.fused_paged_decode_attention(
                qs[0], kps[0], vps[0], pages=pages, cur_pos=cur,
                window=window, out=out), out, "fused_paged_decode_attention")
                for out in (nan_out((B, Hq, 1, D), dtype),
                            nan_out((B, Hq, 1, D), dtype))],
                "fused_paged_decode_attention")
            ref = ops.gqa_paged_decode_attn_plain(qs[0], kps[0], vps[0],
                                                  pages, cur, window)
            ok_rows = ops.paged_attended_rows(pages, PS, N_PAGES, cur, window)
            kg = [gather_paged_kv(k, pages) for k in kps]
            vg = [gather_paged_kv(v, pages) for v in vps]
            lib_fns = [sdpa_yardstick(qs[i], kg[i], vg[i],
                                      ok_rows[:, None, None, :])
                       for i in range(n_sets)]
            timings = {
                "ms": time_ms(lambda i: ops.fused_paged_decode_attention(
                    qs[i], kps[i], vps[i], pages=pages, cur_pos=cur,
                    window=window), n_sets),
                "device_ms": device_ms(
                    lambda i: ops.fused_paged_decode_attention(
                        qs[i], kps[i], vps[i], pages=pages, cur_pos=cur,
                        window=window), n_sets),
                "plain_ms": time_ms(lambda i: ops.gqa_paged_decode_attn_plain(
                    qs[i], kps[i], vps[i], pages, cur, window), n_sets),
                "library_ms": lib_ms(lib_fns, n_sets),
                "library_device_ms": lib_device_ms(lib_fns, n_sets)}
            rows = int(ok_rows.sum())
            nbytes = ((rows * Hkv * 2 * D + 2 * B * Hq * D) * es + B * 4
                      + B * PPS * 4)
            flops = rows * Hq * 2 * 2 * D
            record("fused_paged_decode_attention",
                   f"q[8,32,1,128] pools[{N_PAGES},4,16,128] pages[8,64] "
                   f"window {window}", dtype, got, ref, timings, nbytes,
                   flops, dtype == torch.bfloat16 and window == 0)
            del kg, vg, lib_fns
        del qs, kps, vps

        # absorbed MLA, #5 over the slot cache and #6 over the paged pool
        # (one kernel body, two row policies): f32 output [8, 16, 512]
        # from bf16 / f32 inputs, at phase 2's positions and at a decode
        # step's of the DeepSeek-V2-Lite serve (8 slots attending 64-320
        # rows: its prompts of 64-256 tokens and 64 new ones). #5 reads a
        # cache whose unattended rows are NaN and #6 pools whose
        # unreferenced pages are NaN, each into NaN-filled outputs, twice,
        # for the same bits
        n_sets = copies_for(B * S * (R_MLA + DR_MLA) * es)
        qas = [rnd((B, H_MLA, R_MLA), dtype) for _ in range(n_sets)]
        qrs = [rnd((B, H_MLA, DR_MLA), dtype) for _ in range(n_sets)]
        lats = [rnd((B, S, R_MLA), dtype) for _ in range(n_sets)]
        ropes = [rnd((B, S, DR_MLA), dtype) for _ in range(n_sets)]
        for where, mcur_np in (("phase 2", cur_np), ("decode step",
                                                     MLA_STEP_CUR)):
            mcur = torch.from_numpy(mcur_np).to(dev)
            mpages, munref = table_for(mcur_np)
            first = where == "phase 2"
            ok_rows = ops.attended_rows(S, mcur, device=dev)
            unread = ~ok_rows[:, :, None]
            lat_nan = lats[0].masked_fill(unread, float("nan"))
            rope_nan = ropes[0].masked_fill(unread, float("nan"))
            got = same_bits([written(ops.fused_mla_decode_attention(
                qas[0], qrs[0], lat_nan, rope_nan, cur_pos=mcur,
                head_dim_for_scale=SCALE_DIM, out=out), out,
                "fused_mla_decode_attention")
                for out in (nan_out((B, H_MLA, R_MLA), torch.float32),
                            nan_out((B, H_MLA, R_MLA), torch.float32))],
                "fused_mla_decode_attention")
            del lat_nan, rope_nan, unread
            ref = ops.mla_decode_attn_plain(qas[0], qrs[0], lats[0],
                                            ropes[0], mcur, SCALE_DIM)
            lib_fns = [sdpa_yardstick(
                torch.cat([qas[i], qrs[i]], -1)[:, :, None, :],
                torch.cat([lats[i], ropes[i]], -1)[:, None],
                lats[i][:, None], ok_rows[:, None, None, :],
                scale=1.0 / math.sqrt(SCALE_DIM)) for i in range(n_sets)]

            def slot_call(i, c=mcur):
                return ops.fused_mla_decode_attention(
                    qas[i], qrs[i], lats[i], ropes[i], cur_pos=c,
                    head_dim_for_scale=SCALE_DIM)
            timings = {
                "ms": time_ms(slot_call, n_sets),
                "device_ms": device_ms(slot_call, n_sets),
                "plain_ms": time_ms(lambda i: ops.mla_decode_attn_plain(
                    qas[i], qrs[i], lats[i], ropes[i], mcur, SCALE_DIM),
                    n_sets),
                "library_ms": lib_ms(lib_fns, n_sets),
                "library_device_ms": lib_device_ms(lib_fns, n_sets)}
            rows = int(ok_rows.sum())
            mla_bytes = (rows * (R_MLA + DR_MLA) * es
                         + B * H_MLA * (R_MLA + DR_MLA) * es
                         + B * H_MLA * R_MLA * 4 + B * 4)
            mla_flops = rows * H_MLA * (2 * (R_MLA + DR_MLA) + 2 * R_MLA)
            if dtype == torch.bfloat16:
                launch_split("fused_mla_decode_attention", where, slot_call,
                             n_sets, ("partial", "merge"),
                             bound_ms(mla_bytes, mla_flops, "bfloat16")[0])
            record("fused_mla_decode_attention",
                   f"{where} q_abs[8,16,512] q_rope[8,16,64] "
                   f"latent[8,1024,512] rope[8,1024,64] scale 1/sqrt(192) "
                   f"cur_pos {mcur_np.tolist()}", dtype, got, ref, timings,
                   mla_bytes, mla_flops, first and dtype == torch.bfloat16)
            del lib_fns

            lps = [nan_pool(lat.reshape(N_PAGES, PS, R_MLA).clone(), munref)
                   for lat in lats]
            rps = [nan_pool(rope.reshape(N_PAGES, PS, DR_MLA).clone(),
                            munref) for rope in ropes]
            got = same_bits([written(ops.fused_paged_mla_decode_attention(
                qas[0], qrs[0], lps[0], rps[0], pages=mpages, cur_pos=mcur,
                head_dim_for_scale=SCALE_DIM, out=out), out,
                "fused_paged_mla_decode_attention")
                for out in (nan_out((B, H_MLA, R_MLA), torch.float32),
                            nan_out((B, H_MLA, R_MLA), torch.float32))],
                "fused_paged_mla_decode_attention")
            ref = ops.mla_paged_decode_attn_plain(
                qas[0], qrs[0], lps[0], rps[0], mpages, mcur, SCALE_DIM)
            ok_rows = ops.paged_attended_rows(mpages, PS, N_PAGES, mcur)
            lib_fns = [sdpa_yardstick(
                torch.cat([qas[i], qrs[i]], -1)[:, :, None, :],
                torch.cat([gather_paged_rows(lps[i], mpages),
                           gather_paged_rows(rps[i], mpages)], -1)[:, None],
                gather_paged_rows(lps[i], mpages)[:, None],
                ok_rows[:, None, None, :], scale=1.0 / math.sqrt(SCALE_DIM))
                for i in range(n_sets)]

            def paged_call(i, c=mcur, p=mpages):
                return ops.fused_paged_mla_decode_attention(
                    qas[i], qrs[i], lps[i], rps[i], pages=p, cur_pos=c,
                    head_dim_for_scale=SCALE_DIM)
            timings = {
                "ms": time_ms(paged_call, n_sets),
                "device_ms": device_ms(paged_call, n_sets),
                "plain_ms": time_ms(
                    lambda i: ops.mla_paged_decode_attn_plain(
                        qas[i], qrs[i], lps[i], rps[i], mpages, mcur,
                        SCALE_DIM), n_sets),
                "library_ms": lib_ms(lib_fns, n_sets),
                "library_device_ms": lib_device_ms(lib_fns, n_sets)}
            rows = int(ok_rows.sum())
            mla_bytes = (rows * (R_MLA + DR_MLA) * es
                         + B * H_MLA * (R_MLA + DR_MLA) * es
                         + B * H_MLA * R_MLA * 4 + B * 4 + B * PPS * 4)
            mla_flops = rows * H_MLA * (2 * (R_MLA + DR_MLA) + 2 * R_MLA)
            if dtype == torch.bfloat16:
                launch_split("fused_paged_mla_decode_attention", where,
                             paged_call, n_sets, ("partial", "merge"),
                             bound_ms(mla_bytes, mla_flops, "bfloat16")[0])
            record("fused_paged_mla_decode_attention",
                   f"{where} q_abs[8,16,512] q_rope[8,16,64] "
                   f"pools[{N_PAGES},16,512] / [{N_PAGES},16,64] "
                   f"pages[8,64] cur_pos {mcur_np.tolist()}", dtype, got,
                   ref, timings, mla_bytes, mla_flops,
                   first and dtype == torch.bfloat16)
            del lps, rps, lib_fns
        del qas, qrs, lats, ropes
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")
    say("kernels", f"all {len(checked)} kernel checks within "
        "tolerance")

    # ------------------------------------------------------------ analysis
    # the port's static invariant gate on the card: the full signature
    # matrix (train, serve-decode and serve-engine steps at smoke width,
    # the collective probes, every kernel wrapper at its probe shapes) run
    # once under the recorder and linted against R1-R5, then every mutant.
    # R4 prices each launch from the C launcher's own launch config and
    # ptxas's log; its micro_kernel run is the path of #7
    from repro_torch.analysis import smem as an_smem
    from repro_torch.analysis.__main__ import main as analysis_main
    seen = {}

    def collect(name, launches_):
        for ln in launches_:
            d = seen.setdefault(ln.fn, {"smem": 0, "threads": set(),
                                        "by": set()})
            d["smem"] = max(d["smem"], ln.smem)
            d["threads"].add(ln.threads)
            d["by"].add(name)
    prev_hook = ops.set_launch_hook(collect)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = analysis_main(["--check", "--mutate"])
    finally:
        ops.set_launch_hook(prev_hook)
    an_launches = ops.launch_counts()
    budget = an_smem.device_budget()
    say("analysis", f"--check --mutate returned {rc} in "
        f"{time.perf_counter() - t0:.1f} s; budget: {budget.smem_per_block} "
        f"B shared memory per block, {budget.regs_per_sm} registers per SM; "
        f"launches {an_launches}")
    for fn, r in sorted(an_smem.kernel_resources().items()):
        d = seen.get(fn)
        say("analysis", f"{fn}: {r.registers} registers/thread, static smem "
            f"{r.static_smem} B, dynamic smem "
            f"{'-' if d is None else d['smem']} B (largest at the cases' "
            f"shapes), threads {'-' if d is None else sorted(d['threads'])}"
            f", spills {r.spill_stores}/{r.spill_loads} B; launched by "
            f"{'-' if d is None else sorted(d['by'])}")
    idle = [k for k, n in an_launches.items() if n <= 0]
    if rc != 0 or idle:
        raise SystemExit(f"analysis failed: rc {rc}, never launched {idle}")

    # ---------------------------------------------------------------- 3
    # full width, two layers, f32: the kernel path against the plain path
    import dataclasses
    cfg2 = dataclasses.replace(full, num_layers=2, name="yi-6b-2layer")
    g2 = torch.Generator(device=dev).manual_seed(1)
    params2 = lm_lib.init(g2, cfg2, torch.float32, dev)
    static = PlanStatic(block_size=128, tp_size=1)
    static = dataclasses.replace(
        static, scope_blocks=scopes_lib.scope_block_table(cfg2, static))
    scopes = scopes_lib.control_scopes(cfg2, static)
    # shuffled keep-first lists (at tp=1 every scope's global list is [nb])
    pri = scopes_lib.plan_pri_arrays(
        scopes, {n: np.random.default_rng(5).permutation(nb)
                 for n, nb in scopes.items()}, 1, device=dev)
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, VOCAB, (B,)).astype(np.int32)).to(dev)
    logits = {}
    for use_kernel in (True, False):
        ctx = ControlContext(static=static,
                             bucket_by_rank=torch.tensor([3], dtype=torch.int32),
                             pri=pri, use_kernel=use_kernel)
        cache = lm_lib.init_cache(cfg2, B, 64, torch.float32, dev)
        c2 = dataclasses.replace(cfg2, fused_decode_attn=use_kernel)
        with torch.no_grad():
            for t in range(3):        # three positions, the last one ragged
                pos = torch.full((B,), t, dtype=torch.int32, device=dev)
                pos[-1] = 2 ** 30 if t == 2 else t
                out, cache = lm_lib.decode_step(params2, c2, cache, tok, pos,
                                                ctx=ctx)
        logits[use_kernel] = out[:-1].float()
    e, m = errs(logits[True], logits[False])
    agree = float((logits[True].argmax(-1) == logits[False].argmax(-1))
                  .float().mean())
    ok = bool(torch.isfinite(logits[True]).all()) and e <= F32_TOL * m
    say("reference", f"yi-6b width, 2 layers, f32, bucket 3: kernel path vs "
        f"plain path logits max|err| {e:.3e} (max|ref| {m:.3e}); greedy "
        f"agreement {agree:.3f} {'ok' if ok else 'FAIL'}")
    del params2, cache, logits
    if not ok:
        raise SystemExit("reference check failed")

    # the paged pool and MLA + MoE at full width, two layers, f32: three
    # decode steps from a cache of random rows at ragged positions (the
    # last lane invalid in the last step), through shuffled page tables;
    # the kernel path against the plain path, and every kernel of the
    # path launched
    from repro_torch.core import paging as paging_lib

    def tree_map(fn, tree):
        if isinstance(tree, dict):
            return {k: tree_map(fn, v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(tree_map(fn, v) for v in tree)
        return fn(tree)

    def path_check(tag, cfg, seed, block, kernels, page_size=0):
        params = lm_lib.init(torch.Generator(device=dev).manual_seed(seed),
                             cfg, torch.float32, dev)
        st = PlanStatic(block_size=block, tp_size=1)
        st = dataclasses.replace(
            st, scope_blocks=scopes_lib.scope_block_table(cfg, st))
        sc = scopes_lib.control_scopes(cfg, st)
        pr = scopes_lib.plan_pri_arrays(
            sc, {n: np.random.default_rng(5).permutation(nb)
                 for n, nb in sc.items()}, 1, device=dev)
        start = np.asarray([16, 40, 100, 200, 500, 31, 63, 700], np.int32)
        lay, pages = None, None
        if page_size:
            lay = paging_lib.paged_layout(1024, page_size, B)
            pperm = np.random.default_rng(seed).permutation(lay.num_pages)
            tab = np.full((B, lay.pages_per_slot), -1, np.int32)
            n_used = 0
            for b in range(B):
                n = (int(start[b]) + 2) // page_size + 1
                tab[b, :n] = pperm[n_used:n_used + n]
                n_used += n
            pages = torch.from_numpy(tab).to(dev)
        gc = torch.Generator(device=dev).manual_seed(seed + 1)
        cache0 = tree_map(
            lambda t: torch.randn(t.shape, generator=gc, device=dev) * 0.5,
            lm_lib.init_cache(cfg, B, 1024, torch.float32, dev, paging=lay))
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (B,)).astype(np.int32)).to(dev)
        res = {}
        for use_kernel in (True, False):
            cache = tree_map(lambda t: t.clone(), cache0)
            ctx = ControlContext(
                static=st, bucket_by_rank=torch.tensor([3], dtype=torch.int32),
                pri=pr, use_kernel=use_kernel)
            ck = dataclasses.replace(cfg, fused_decode_attn=use_kernel)
            ops.reset_launch_counts()
            with torch.no_grad():
                for t in range(3):
                    pos = torch.from_numpy(start + t).to(dev)
                    if t == 2:
                        pos[-1] = 2 ** 30
                    out, cache = lm_lib.decode_step(params, ck, cache, toks,
                                                    pos, ctx=ctx, pages=pages)
            torch.cuda.synchronize()
            res[use_kernel] = (out[:-1].float(), ops.launch_counts())
        (lk, counts), (lp, _) = res[True], res[False]
        e, m = errs(lk, lp)
        ok = (bool(torch.isfinite(lk).all()) and e <= F32_TOL * m
              and all(counts[k] > 0 for k in kernels))
        say("reference", f"{tag}, 2 layers, f32, bucket 3 (block {block}): "
            f"kernel path vs plain path logits max|err| {e:.3e} (max|ref| "
            f"{m:.3e}); launches {({k: counts[k] for k in kernels})} "
            f"{'ok' if ok else 'FAIL'}")
        del params, cache0, res
        if not ok:
            raise SystemExit(f"reference check failed: {tag}")

    ds_full = get_config("deepseek-v2-lite-16b")
    ds2 = dataclasses.replace(ds_full, num_layers=2,
                              name="deepseek-v2-lite-2layer")
    path_check("yi-6b width, paged (page 16)", cfg2, 11, 128,
               ("block_pruned_matmul", "fused_pruned_ffn",
                "fused_paged_decode_attention"), page_size=16)
    path_check("deepseek-v2-lite width (dense layer + MoE layer), slot "
               "cache", ds2, 12, 64,
               ("fused_pruned_ffn", "fused_mla_decode_attention"))
    path_check("deepseek-v2-lite width (dense layer + MoE layer), paged "
               "(page 16)", ds2, 13, 64,
               ("fused_pruned_ffn", "fused_paged_mla_decode_attention"),
               page_size=16)
    torch.cuda.empty_cache()

    # tp 4 (the group emulated in one process), full width, two layers,
    # f32, three decode steps from a cache of random rows as above: (a)
    # rank 1 resized to bucket 3 (#2 launches) and rank 0 the source of a
    # 2-block migration (#3 runs on it), the kernel path against the plain
    # path; (b) the lossless plan (every rank at bucket 0, rank 0
    # migrating) on the kernel path against the tp-1 dense step on the
    # plain path (``lossless``; else against the same plan's plain path,
    # the distance to the dense step printed). DeepSeek's routed experts
    # are expert-parallel: the single-group function. Blocks: Yi's FFN is
    # 2752 = 64 x 43 wide a rank; DeepSeek's shared experts 704 = 16 x 44
    def tp4_check(tag, cfg, seed, block, kernels, lossless=True):
        params = lm_lib.init(torch.Generator(device=dev).manual_seed(seed),
                             cfg, torch.float32, dev)
        st = PlanStatic(block_size=block, tp_size=4, mig_shed=(2,))
        st = dataclasses.replace(
            st, scope_blocks=scopes_lib.scope_block_table(cfg, st))
        sc = scopes_lib.control_scopes(cfg, st)
        prng_ = np.random.default_rng(5)
        pr = scopes_lib.plan_pri_arrays(
            sc, {n: prng_.permutation(nb * (1 if scopes_lib.SCOPE_LAYOUT[n]
                                            == "col" else 4))
                 for n, nb in sc.items()}, 4, device=dev)
        start = np.asarray([16, 40, 100, 200, 500, 31, 63, 700], np.int32)
        gc_ = torch.Generator(device=dev).manual_seed(seed + 1)
        cache0 = tree_map(
            lambda t: torch.randn(t.shape, generator=gc_, device=dev) * 0.5,
            lm_lib.init_cache(cfg, B, 1024, torch.float32, dev))
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (B,)).astype(np.int32)).to(dev)

        def run(buckets, use_kernel, tp):
            cache = tree_map(lambda t: t.clone(), cache0)
            ctx = (ControlContext(static=st, bucket_by_rank=buckets,
                                  pri=pr, use_kernel=use_kernel,
                                  mig_src=[0]) if tp == 4 else None)
            ck = dataclasses.replace(cfg, fused_decode_attn=use_kernel)
            ops.reset_launch_counts()
            with torch.no_grad():
                for t in range(3):
                    pos = torch.from_numpy(start + t).to(dev)
                    if t == 2:
                        pos[-1] = 2 ** 30
                    out, cache = lm_lib.decode_step(params, ck, cache, toks,
                                                    pos, ctx=ctx)
            torch.cuda.synchronize()
            return out[:-1].float(), ops.launch_counts()

        (lk, counts), (lp, _) = (run([0, 3, 0, 0], True, 4),
                                 run([0, 3, 0, 0], False, 4))
        (ll, _), (ld, _) = run([0, 0, 0, 0], True, 4), run(None, False, 1)
        e, m = errs(lk, lp)
        e2, m2 = errs(ll, ld)
        if lossless:
            held = (f"lossless plan (buckets 0, source 0) on the kernel path "
                    f"vs the tp-1 dense step max|err| {e2:.3e} (max|ref| "
                    f"{m2:.3e})")
        else:
            (lq, _) = run([0, 0, 0, 0], False, 4)
            held = (f"plan with buckets 0 and source 0, kernel path vs "
                    f"plain path max|err| {errs(ll, lq)[0]:.3e}; vs the "
                    f"tp-1 dense step {e2:.3e} (information only)")
            e2, m2 = errs(ll, lq)
        ok = (bool(torch.isfinite(lk).all()) and bool(
            torch.isfinite(ll).all()) and e <= F32_TOL * m
            and e2 <= F32_TOL * m2 and all(counts[k] > 0 for k in kernels))
        say("reference", f"{tag}, 2 layers, f32, tp 4 (block {block}): "
            f"buckets [0,3,0,0] + source 0 shedding 2 blocks, kernel path "
            f"vs plain path logits max|err| {e:.3e} (max|ref| {m:.3e}); "
            f"{held}; launches {({k: counts[k] for k in kernels})} "
            f"{'ok' if ok else 'FAIL'}")
        del params, cache0
        if not ok:
            raise SystemExit(f"reference check failed: {tag} at tp 4")

    tp4_check("yi-6b width, slot cache", cfg2, 14, 64,
              ("block_pruned_matmul", "fused_pruned_ffn",
               "fused_decode_attention"))
    # DeepSeek: the MLA projections are no controlled scope, so #2 has no
    # call of its own there; its dense layer (171 blocks a rank) is wider
    # than the "ffn" scope's 44-block lists, so a source keeps the lists'
    # ids of it and exports the lists' last ids (layers/tp_linear.py), as
    # the JAX package does: no plan with a source is lossless there
    tp4_check("deepseek-v2-lite width (dense layer + MoE layer), slot "
              "cache", ds2, 15, 16,
              ("fused_pruned_ffn", "fused_mla_decode_attention"),
              lossless=False)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 4
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    control = ControlConfig(mode="zero", hetero_kind="contention", chi=4.0,
                            sim_ranks=8, block_size=128, fused_attention=True,
                            use_kernel=True, seed=0)
    eng = ServeEngine("yi-6b", model_cfg=full, num_slots=8, max_len=1024,
                      param_dtype="bfloat16", control=control,
                      prefill_chunk=16, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, VOCAB, (int(rng.integers(64, 257)),))
                    .astype(np.int32),
                    max_new_tokens=64, arrival_step=3 * i)
            for i in range(16)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    eng.close()
    n_tok = sum(len(c.tokens) for c in comps)
    walls = np.asarray([h["wall_s"] for h in eng.history if "wall_s" in h])
    resized = sum(1 for h in eng.history if h.get("max_bucket", 0) > 0)
    problems = []
    if sorted(c.uid for c in comps) != list(range(16)):
        problems.append("not every request completed")
    if any(len(c.tokens) != 64 for c in comps):
        problems.append("a request stopped short of 64 tokens")
    if any(((c.tokens < 0) | (c.tokens >= VOCAB)).any() for c in comps):
        problems.append("a token outside the vocabulary")
    if len({tuple(c.tokens.tolist()) for c in comps}) < 2:
        problems.append("every request generated the same tokens")
    serve_kernels = ("block_pruned_matmul", "fused_pruned_ffn",
                     "fused_decode_attention")
    if min(launches[k] for k in serve_kernels) <= 0:
        problems.append(f"a kernel never launched: {launches}")
    if resized == 0:
        problems.append("no step ran a resized plan")
    say("serve", f"16 requests, {n_tok} tokens, {len(eng.history)} steps in "
        f"{wall:.2f} s wall (engine built in {t_init:.1f} s): "
        f"{n_tok / wall:.1f} tokens/s wall; step wall p50 "
        f"{np.percentile(walls, 50) * 1e3:.2f} ms, p95 "
        f"{np.percentile(walls, 95) * 1e3:.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {resized} "
        f"steps ran a resized plan; launches {launches}")
    if problems:
        raise SystemExit(f"serve check failed: {problems}")

    # ---------------------------------------------------------------- 5
    # where a decode step's time goes: 8 fresh requests on the same
    # engine, 8 decode-only steps under the profiler (device activity)
    n_prof = 8

    def decode_profile(e, vocab, uid0):
        """Eight fresh requests on engine ``e``, four steps to admit and
        prefill them, then n_prof decode-only steps under the profiler:
        wall ms per step, device ms per step, [(kernel, calls, ms)]."""
        for i in range(8):
            e.submit(Request(uid=uid0 + i, prompt=rng.integers(
                0, vocab, (16,)).astype(np.int32), max_new_tokens=24,
                arrival_step=e.step_count))
        for _ in range(4):              # admit + prefill + first decodes
            e.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof_:
            t0_ = time.perf_counter()
            for _ in range(n_prof):
                e.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0_) * 1e3 / n_prof
        rows_ = kernel_times(prof_)
        return wall_ms, sum(r[2] for r in rows_) / n_prof, rows_

    def family(name):
        # #1 and #4 are one kernel: told apart by the row policy
        if "gqa_decode" in name:
            return ("fused_paged_decode_attention" if "PagedRows" in name
                    else "fused_decode_attention")
        for key, fam in (("FfnPolicy", "fused_pruned_ffn hidden stage"),
                         ("FfnGatedPolicy", "fused_pruned_ffn hidden stage"),
                         ("bpm_", "block-pruned products (proj + FFN down)"),
                         ("BpmPolicy",
                          "block-pruned products (proj + FFN down)"),
                         ("ffn_hidden", "fused_pruned_ffn hidden stage"),
                         ("reduce_splits", "split reductions")):
            if key in name:
                return fam
        low = name.lower()
        if any(t in low for t in ("gemm", "gemv", "cutlass", "nvjet",
                                  "cublas")):
            return "library matmul (dense products, LM head)"
        return "elementwise / indexing / other"

    def report(tag, what, wall_ms, dev_ms, rows_, fam_of):
        """Wall and device time per step, the device time by family and
        the eight largest kernels."""
        fams_ = {}
        for name, calls, ms in rows_:
            f = fams_.setdefault(fam_of(name), [0, 0.0])
            f[0] += calls
            f[1] += ms
        say(tag, f"{what}: wall {wall_ms:.2f} ms/step, device kernels "
            f"{dev_ms:.2f} ms/step, device busy {dev_ms / wall_ms:.1%} "
            f"(idle {1 - dev_ms / wall_ms:.1%})")
        for fam, (calls, ms) in sorted(fams_.items(), key=lambda kv: -kv[1][1]):
            say(tag, f"  {fam}: {ms / n_prof:.3f} ms/step, "
                f"{calls / n_prof:.0f} kernels/step")
        for name, calls, ms in rows_[:8]:
            say(tag, f"  top: {ms / n_prof:.3f} ms/step, "
                f"{calls / n_prof:.0f}/step  {name[:90]}")

    def ffn_route_check(tag, rows_, want):
        """#3's hidden stage ran through ``want`` (the decode kernel at
        the decode steps' 8 rows) wherever it ran in the window (only a
        resized step runs it), and never through another function."""
        ran = sorted({short_name(n) for n, _, _ in rows_
                      if "ffn_hidden" in n or "FfnPolicy" in n
                      or "FfnGatedPolicy" in n})
        if any(want not in n and "ffn_hidden_act_kernel" not in n
               for n in ran):
            raise SystemExit(f"{tag}: #3's hidden stage ran {ran}, not "
                             f"only {want}")
        say(tag, "#3's hidden stage in the window: "
            + (", ".join(ran) if ran else "no resized step, not launched"))

    def gqa_policy_check(tag, rows_, policy):
        """The step ran the GQA kernel with this row policy, and no GQA
        kernel without one (the two-file design is gone)."""
        names = [name for name, _, _ in rows_]
        bad = [n for n in names if "gqa_paged" in n or (
            "gqa_decode" in n and "Rows" not in n)]
        if bad or not any("gqa_decode_partial_kernel" in n and policy in n
                          for n in names):
            raise SystemExit(f"{tag}: no gqa_decode_partial_kernel<{policy}"
                             f"...> in the step, or an old kernel: {bad}")

    pwall_ms, dev_step_ms, rows = decode_profile(eng, VOCAB, 1000)
    if not any("bpm_decode_kernel" in name for name, _, _ in rows):
        raise SystemExit("profile: the decode step launched no "
                         "bpm_decode_kernel (#2 at 8 slots)")
    gqa_policy_check("profile", rows, "SlotRows")
    ffn_route_check("profile", rows, "ffn_hidden_decode_kernel")
    report("profile", "decode-only step, 8 active slots", pwall_ms,
           dev_step_ms, rows, family)
    yi_tokens = {c.uid: c.tokens.tolist() for c in comps}

    def free():
        # an engine is a reference cycle (its control plane keeps a
        # closure over it): collect it before the next model is built
        gc.collect()
        torch.cuda.empty_cache()
    del eng
    free()

    # ------------------------------------------------------ paged serving
    # the same engine, traffic and control over the block-paged pool (page
    # 16). 60% of 8 x 64 pages would never run dry here (a request holds
    # at most (256 + 64) / 16 = 20 pages, 8 slots at most 160), so the pool
    # is 96 pages, 60% of that peak: the engine must preempt
    def serve_run(tag, arch, model_cfg, control, path_kernels,
                  expect_resize=True, n_req=16, **kw):
        """Serve the first ``n_req`` of the 16 requests; every launch count is set to 0 just
        before the run and read just after, and each kernel of the path
        must have launched (and, with ``expect_resize``, some step must
        have run a resized plan)."""
        free()
        torch.cuda.reset_peak_memory_stats()
        t_init = time.perf_counter()
        e = ServeEngine(arch, model_cfg=model_cfg, num_slots=8, max_len=1024,
                        param_dtype="bfloat16", control=control,
                        prefill_chunk=16, device="cuda", **kw)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t_init
        rq = np.random.default_rng(0)
        rs = [Request(uid=i, prompt=rq.integers(
                  0, model_cfg.vocab_size, (int(rq.integers(64, 257)),))
                  .astype(np.int32), max_new_tokens=64, arrival_step=3 * i)
              for i in range(16)][:n_req]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        cs = e.run(rs)
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0
        counts = ops.launch_counts()
        e.close()
        n_tok_ = sum(len(c.tokens) for c in cs)
        walls_ = np.asarray([h["wall_s"] for h in e.history])
        resized_ = sum(1 for h in e.history if h.get("max_bucket", 0) > 0)
        probs = []
        if sorted(c.uid for c in cs) != list(range(n_req)):
            probs.append("not every request completed")
        if any(len(c.tokens) != 64 for c in cs):
            probs.append("a request stopped short of 64 tokens")
        if any(((c.tokens < 0) | (c.tokens >= model_cfg.vocab_size)).any()
               for c in cs):
            probs.append("a token outside the vocabulary")
        if len({tuple(c.tokens.tolist()) for c in cs}) < 2:
            probs.append("every request generated the same tokens")
        for k in path_kernels:
            if counts[k] <= 0:
                probs.append(f"{k} never launched")
        if expect_resize and resized_ == 0:
            probs.append("no step ran a resized plan")
        say(tag, f"{n_req} requests, {n_tok_} tokens, {len(e.history)} steps in "
            f"{wall_:.2f} s wall (engine built in {t_init:.1f} s): "
            f"{n_tok_ / wall_:.1f} tokens/s wall; step wall p50 "
            f"{np.percentile(walls_, 50) * 1e3:.2f} ms, p95 "
            f"{np.percentile(walls_, 95) * 1e3:.2f} ms; preemptions "
            f"{e.preemptions}; kv cache {e.kv_cache_bytes() / 2**20:.1f} "
            f"MiB; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"{resized_} steps ran a resized plan; launches "
            f"{({k: v for k, v in counts.items() if v})}")
        return e, {c.uid: c.tokens.tolist() for c in cs}, counts, probs

    def agreement(a, b):
        return sum(a[u] == b[u] for u in a) / len(a)

    eng, paged_tokens, paged_launches, problems = serve_run(
        "paged-serve", "yi-6b", full, control,
        ("block_pruned_matmul", "fused_pruned_ffn",
         "fused_paged_decode_attention"), page_size=16, num_pages=96)
    if eng.preemptions < 1:
        problems.append("the paged run never preempted")
    say("paged-serve", f"requests whose tokens agree with the slot-cache "
        f"run: {agreement(paged_tokens, yi_tokens):.3f} (bf16 on the card; "
        "information only)")
    if problems:
        raise SystemExit(f"paged serve check failed: {problems}")

    # ------------------------------------------------------ paged profile
    # where a paged Yi-6B decode step's time goes (#4 on its main path):
    # 8 fresh requests on the paged engine, 8 decode-only steps, as phase 5
    gwall_ms, gdev_ms, grows = decode_profile(eng, VOCAB, 3000)
    gqa_policy_check("paged-profile", grows, "PagedRows")
    ffn_route_check("paged-profile", grows, "ffn_hidden_decode_kernel")
    report("paged-profile", "yi-6b decode-only step (paged, page 16), 8 "
           "active slots", gwall_ms, gdev_ms, grows, family)
    del eng
    free()

    # ------------------------------------------------------ SEMI serving
    # the same traffic at full Yi-6B width over a TP group of 4 ranks
    # (emulated in one process) under SEMI with the lossless β-policy: up
    # to 3 of the 8 simulated ranks' stragglers migrate their FFN blocks
    # to the helpers (folded onto the 4 real ranks), so #3 runs on each
    # source rank. A straggler past the migrating prefix resizes by design
    # (Eq. 3, capped at max_sources): with 8 simulated ranks at p 0.15
    # four straggle at once every ~50 steps; such a step must have more
    # stragglers than sources. Block 64: the FFN is 2752 = 64 x 43 wide a
    # rank. Then the same traffic through the uncontended tp-1 dense
    # engine, for the share of requests whose tokens agree (bf16 sums in
    # another order: information only; exactness is the CPU tests')
    control_semi = ControlConfig(
        mode="semi", hetero_kind="contention", chi=4.0, sim_ranks=8,
        max_sources=3, beta_policy="lossless", block_size=64,
        fused_attention=True, use_kernel=True, seed=0)
    eng, semi_tokens, semi_launches, problems = serve_run(
        "semi-serve", "yi-6b", full, control_semi,
        ("fused_decode_attention", "fused_pruned_ffn"),
        expect_resize=False, tp=4)
    migrating = [h for h in eng.history if h.get("mig_srcs")]
    resized_semi = [h for h in eng.history if h.get("max_bucket", 0) > 0]
    past_prefix = [h for h in resized_semi
                   if len(h["stragglers"])
                   > len(h.get("planned_mig_srcs", ()))]
    if not migrating:
        problems.append("no step executed a migration")
    if len(past_prefix) != len(resized_semi):
        problems.append("a step resized a straggler it could have migrated")
    if any(max(h["mig_shed"]) <= 0 for h in migrating):
        problems.append("an executed migration shed no block")
    say("semi-serve", f"tp 4, SEMI lossless, sim_ranks 8, max_sources 3: "
        f"{len(migrating)} of {len(eng.history)} steps migrated (sources "
        f"{sorted({s for h in migrating for s in h['mig_srcs']})}, sheds "
        f"{sorted({m for h in migrating for m in h['mig_shed']})}); "
        f"{len(resized_semi)} steps resized, each with more stragglers "
        f"than migrating sources; trace counts {eng.trace_counts()}")
    del eng
    free()
    if problems:
        raise SystemExit(f"SEMI serve check failed: {problems}")
    # over 4 simulated ranks (no fold, as the CPU tests' scenario) at most
    # 3 straggle while one helps: every straggler migrates, no step may
    # resize. The first 8 requests
    eng, _, _, problems = serve_run(
        "semi-serve", "yi-6b", full,
        dataclasses.replace(control_semi, sim_ranks=4, contention_p=0.2),
        ("fused_decode_attention", "fused_pruned_ffn"),
        expect_resize=False, n_req=8, tp=4)
    migrating = [h for h in eng.history if h.get("mig_srcs")]
    resized_semi = [h for h in eng.history if h.get("max_bucket", 0) > 0]
    if not migrating:
        problems.append("no step executed a migration")
    if resized_semi:
        problems.append(f"{len(resized_semi)} steps resized")
    say("semi-serve", f"tp 4, SEMI lossless, sim_ranks 4, max_sources 3, "
        f"contention p 0.2: {len(migrating)} of {len(eng.history)} steps "
        f"migrated, {len(resized_semi)} resized")
    del eng
    free()
    if problems:
        raise SystemExit(f"SEMI serve check (4 simulated ranks) failed: "
                         f"{problems}")
    eng, dense_tokens, _, problems = serve_run(
        "semi-serve", "yi-6b", full, ControlConfig(fused_attention=True),
        ("fused_decode_attention",), expect_resize=False)
    prefix = [next((j for j, (a, b) in enumerate(zip(
        semi_tokens[u], dense_tokens[u])) if a != b), 64)
        for u in semi_tokens]
    say("semi-serve", f"requests whose tokens agree with the uncontended "
        f"tp-1 dense run: {agreement(semi_tokens, dense_tokens):.3f}; tokens "
        f"before the first difference, per request: {prefix} (bf16 on the "
        "card; information only)")
    del eng
    free()
    if problems:
        raise SystemExit(f"dense tp-1 serve check failed: {problems}")

    # ------------------------------------------------------ MLA + MoE
    # full-width DeepSeek-V2-Lite (27 layers: a dense first layer, 26 MoE
    # layers of 64 routed experts top-6 + 2 shared; MLA with a 512-wide
    # latent; bf16, random weights from the seed), the same traffic and
    # control, over the slot cache (#5) and over the paged pool (#6). The
    # pool holds the traffic's peak of 8 x 20 pages, so the paged run
    # never preempts and both runs step through the same plans: their
    # tokens compare #5 with #6 (one body, rows split alike). The controlled
    # block is 64: the dense layer's 10944-wide FFN has no 128-wide
    # blocks (10944 = 64 x 171)
    control_ds = ControlConfig(mode="zero", hetero_kind="contention",
                               chi=4.0, sim_ranks=8, block_size=64,
                               fused_attention=True, use_kernel=True, seed=0)
    eng, ds_fixed_tokens, mla_launches, problems = serve_run(
        "mla-serve", "deepseek-v2-lite-16b", ds_full, control_ds,
        ("fused_pruned_ffn", "fused_mla_decode_attention"))
    if problems:
        raise SystemExit(f"MLA serve (slot cache) check failed: {problems}")
    del eng
    free()
    eng, ds_paged_tokens, mla_paged_launches, problems = serve_run(
        "mla-serve", "deepseek-v2-lite-16b", ds_full, control_ds,
        ("fused_pruned_ffn", "fused_paged_mla_decode_attention"),
        page_size=16, num_pages=160)
    say("mla-serve", f"requests whose tokens agree between the slot-cache "
        f"and the paged run: {agreement(ds_paged_tokens, ds_fixed_tokens):.3f}"
        " (information only)")
    if problems:
        raise SystemExit(f"MLA serve (paged) check failed: {problems}")

    # ------------------------------------------------------ MLA profile
    # where a DeepSeek decode step's time goes: 8 fresh requests on the
    # paged engine, 8 decode-only steps under the profiler
    mwall_ms, mdev_ms, mrows = decode_profile(eng, ds_full.vocab_size, 2000)

    def mla_family(name):
        if "mla_partial" in name or "mla_merge" in name:
            return "fused_paged_mla_decode_attention (#6)"
        return family(name)
    ffn_route_check("mla-profile", mrows, "ffn_hidden_decode_kernel")
    report("mla-profile", "deepseek-v2-lite decode-only step (paged), 8 "
           "active slots", mwall_ms, mdev_ms, mrows, mla_family)
    del eng
    free()

    # ---------------------------------------------------------------- 6
    # the backward family (#8-#12) at the shapes the ViT-1B train run
    # gives it (tp = 4, batch 8 x 65 tokens = 520 rows, block 8), with
    # the keep counts of its straggler (bucket 7 of 8): 32/256 qkv
    # blocks, 8/64 attn_out blocks, 32 - 2 (shed) = 30/256 FFN blocks
    M_T, D_V, B8 = 520, 2048, 8
    ATT_LOC = 512                       # 16 heads x 128 / tp 4
    FF_LOC = 2048                       # 8192 / tp 4

    def kept_sorted(nb, kc, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.sort(torch.randperm(nb, generator=g)[:kc]).values.to(
            torch.int32).to(dev)

    def rows_of(w, keep, block):
        return w.reshape(-1, block, w.shape[1])[keep.long()].reshape(
            -1, w.shape[1])

    def grad_case(name, case, dtype, make, kernel, plain, library, out_shape,
                  nbytes, flops, rep, timed=True):
        """One kernel check: its output starts as NaN (a skipped element
        shows), a second call into a fresh NaN buffer must give the same
        bits, then the timings when ``timed``."""
        n_sets = copies_for(nbytes) if timed else 1
        sets = [make() for _ in range(n_sets)]
        out = torch.full(out_shape, float("nan"), dtype=dtype, device=dev)
        got = kernel(sets[0], out)
        again = kernel(sets[0], torch.full_like(out, float("nan")))
        torch.cuda.synchronize()
        if got.data_ptr() != out.data_ptr():
            raise SystemExit(f"{name}: the kernel did not write into `out`")
        if not torch.equal(got, again):
            failures.append(f"{name} {case} {dtype}: two runs differ")
            say("grad-kernels", f"{name} {case}: two runs differ (FAIL)")
        ref = plain(sets[0])
        timings = {}
        if timed:
            timings = {
                "ms": time_ms(lambda i: kernel(sets[i], None), n_sets),
                "device_ms": device_ms(lambda i: kernel(sets[i], None),
                                       n_sets),
                "plain_ms": time_ms(lambda i: plain(sets[i]), n_sets),
                "library_ms": (time_ms(lambda i: library(sets[i]), n_sets)
                               if library is not None else None)}
        record(name, case, dtype, got, ref, timings, nbytes, flops, rep,
               "grad-kernels")

    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        f32 = dtype == torch.float32
        for wname, N, nb, kb in (("wq", ATT_LOC, D_V // B8, 32),
                                 ("wo", D_V, ATT_LOC // B8, 8)):
            keep = kept_sorted(nb, kb, 11 + kb)
            order = ops.inverse_order(keep, nb)
            K = nb * B8

            def make_dx(N=N, K=K, keep=keep):
                dy, w = rnd((M_T, N), dtype), rnd((K, N), dtype, 0.02)
                return dy, w, rows_of(w, keep, B8)
            grad_case(
                "pruned_matmul_dx", f"{wname} dy[520,{N}] . w[{K},{N}]^T "
                f"keep {kb}/{nb}", dtype, make_dx,
                lambda s, out, order=order, kb=kb: ops.pruned_matmul_dx(
                    s[0], s[1], order, kb=kb, block=B8, out=out),
                lambda s, order=order, kb=kb: ops.pruned_matmul_dx_plain(
                    s[0], s[1], order, kb, B8),
                lambda s: torch.matmul(s[0], s[2].t()), (M_T, K),
                (M_T * N + kb * B8 * N + M_T * K) * es + nb * 4,
                2 * M_T * N * kb * B8, f32 and wname == "wq")

            def make_dw(N=N, K=K, keep=keep):
                x, dy = rnd((M_T, K), dtype), rnd((M_T, N), dtype)
                xk = x.reshape(M_T, -1, B8)[:, keep.long()].reshape(M_T, -1)
                return x, dy, xk.t().contiguous()
            grad_case(
                "pruned_matmul_dw", f"{wname} x[520,{K}]^T . dy[520,{N}] "
                f"keep {kb}/{nb}", dtype, make_dw,
                lambda s, out, order=order, kb=kb: ops.pruned_matmul_dw(
                    s[0], s[1], order, kb=kb, block=B8, out=out),
                lambda s, order=order, kb=kb: ops.pruned_matmul_dw_plain(
                    s[0], s[1], order, kb, B8),
                lambda s: torch.matmul(s[2], s[1]), (K, N),
                (M_T * kb * B8 + M_T * N + K * N) * es + nb * 4,
                2 * M_T * N * kb * B8, f32 and wname == "wq")

        # the FFN's backward: 30 kept blocks of the 256 of w_up_r / w_down_r
        nb, kb = FF_LOC // B8, 30
        C = kb * B8
        keep = kept_sorted(nb, kb, 13)
        order = ops.inverse_order(keep, nb)

        def make_ffn():
            x, dy = rnd((M_T, D_V), dtype), rnd((M_T, D_V), dtype)
            w_up = rnd((D_V, FF_LOC), dtype, 0.02)
            w_down = rnd((FF_LOC, D_V), dtype, 0.02)
            dyc = rnd((M_T, C), dtype)
            up_k = w_up.reshape(D_V, nb, B8)[:, keep.long()].reshape(D_V, C)
            return {"x": x, "dy": dy, "w_up": w_up, "w_down": w_down,
                    "dyc": dyc, "up_k": up_k, "up_kt": up_k.t().contiguous(),
                    "down_k": rows_of(w_down, keep, B8),
                    "xt": x.t().contiguous()}
        ffn_bytes = 3 * D_V * FF_LOC * es
        grad_case(
            "pruned_matmul_dx", f"FFN dh: dy[520,2048] . w_down[2048,2048]^T "
            f"compact keep {kb}/{nb}", dtype, make_ffn,
            lambda s, out: ops.pruned_matmul_dx(
                s["dy"], s["w_down"], keep, kb=kb, block=B8,
                compact_out=True, out=out),
            lambda s: ops.pruned_matmul_dx_plain(s["dy"], s["w_down"], keep,
                                                 kb, B8, True),
            lambda s: torch.matmul(s["dy"], s["down_k"].t()), (M_T, C),
            (M_T * D_V + C * D_V + M_T * C) * es + kb * 4,
            2 * M_T * D_V * C, False)
        grad_case(
            "pruned_matmul_dw", f"FFN dW_down: h[520,{C}]^T . dy[520,2048] "
            f"x_compact keep {kb}/{nb}", dtype, make_ffn,
            lambda s, out: ops.pruned_matmul_dw(
                s["dyc"], s["dy"], order, kb=kb, block=B8, x_compact=True,
                out=out),
            lambda s: ops.pruned_matmul_dw_plain(s["dyc"], s["dy"], order,
                                                 kb, B8, True),
            lambda s: torch.matmul(s["dyc"].t(), s["dy"]), (FF_LOC, D_V),
            (M_T * C + M_T * D_V + FF_LOC * D_V) * es + nb * 4,
            2 * M_T * D_V * C, False)
        grad_case(
            "outpruned_matmul", f"FFN recompute: x[520,2048] . "
            f"w_up[:, keep {kb}/{nb}]", dtype, make_ffn,
            lambda s, out: ops.outpruned_matmul(s["x"], s["w_up"], keep,
                                                block=B8, out=out),
            lambda s: ops.outpruned_matmul_plain(s["x"], s["w_up"], keep, B8),
            lambda s: torch.matmul(s["x"], s["up_k"]), (M_T, C),
            (M_T * D_V + D_V * C + M_T * C) * es + kb * 4,
            2 * M_T * D_V * C, f32)
        grad_case(
            "outpruned_matmul_dx", f"FFN dx: dpre[520,{C}] . "
            f"w_up[:, keep {kb}/{nb}]^T", dtype, make_ffn,
            lambda s, out: ops.outpruned_matmul_dx(s["dyc"], s["w_up"], keep,
                                                   block=B8, out=out),
            lambda s: ops.outpruned_matmul_dx_plain(s["dyc"], s["w_up"],
                                                    keep, B8),
            lambda s: torch.matmul(s["dyc"], s["up_kt"]), (M_T, D_V),
            (M_T * C + D_V * C + M_T * D_V) * es + kb * 4,
            2 * M_T * D_V * C, f32)
        grad_case(
            "outpruned_matmul_dw", f"FFN dW_up: x[520,2048]^T . "
            f"dpre[520,{C}] keep {kb}/{nb}", dtype, make_ffn,
            lambda s, out: ops.outpruned_matmul_dw(s["x"], s["dyc"], order,
                                                   kb=kb, block=B8, out=out),
            lambda s: ops.outpruned_matmul_dw_plain(s["x"], s["dyc"], order,
                                                    kb, B8),
            lambda s: torch.matmul(s["xt"], s["dyc"]), (D_V, FF_LOC),
            (M_T * D_V + M_T * C + D_V * FF_LOC) * es + nb * 4,
            2 * M_T * D_V * C, f32)
        del make_ffn

        # the forward kernels at the train shapes: #2 on the tensor-core
        # core (M = 520 is above the decode kernel's rows) at wq_r and
        # wo_r, with the straggler's keep counts
        for wname, K, N, nb, kb in (("wq_r", D_V, ATT_LOC, 256, 32),
                                    ("wo_r", ATT_LOC, D_V, 64, 8)):
            keep = kept_sorted(nb, kb, 43)
            n_sets = copies_for(K * N * es)
            xs = [rnd((M_T, K), dtype) for _ in range(n_sets)]
            ws = [rnd((K, N), dtype, 0.02) for _ in range(n_sets)]
            xk = [x.reshape(M_T, nb, B8)[:, keep.long()].reshape(M_T, -1)
                  for x in xs]
            wk = [rows_of(w, keep, B8) for w in ws]
            got = ops.block_pruned_matmul(xs[0], ws[0], keep, block=B8)
            again = ops.block_pruned_matmul(xs[0], ws[0], keep, block=B8)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                failures.append(f"block_pruned_matmul {wname} {dtype}: two "
                                "runs differ")
            ref = ops.block_pruned_matmul_plain(xs[0], ws[0], keep, B8)
            timings = {
                "ms": time_ms(lambda i: ops.block_pruned_matmul(
                    xs[i], ws[i], keep, block=B8), n_sets),
                "device_ms": device_ms(lambda i: ops.block_pruned_matmul(
                    xs[i], ws[i], keep, block=B8), n_sets),
                "plain_ms": time_ms(lambda i: ops.block_pruned_matmul_plain(
                    xs[i], ws[i], keep, B8), n_sets),
                "library_ms": time_ms(lambda i: torch.matmul(xk[i], wk[i]),
                                      n_sets),
                "library_device_ms": library_device_ms(
                    lambda i: torch.matmul(xk[i], wk[i]), n_sets)}
            Kk = kb * B8
            record("block_pruned_matmul", f"train shape {wname} "
                   f"x[520,{K}] @ w[{K},{N}] block 8 keep {kb}/{nb}", dtype,
                   got, ref, timings, (M_T * Kk + Kk * N + M_T * N) * es
                   + kb * 4, 2 * M_T * Kk * N, False, "grad-kernels")
            del xs, ws, xk, wk
        keep = kept_sorted(FF_LOC // B8, 30, 44)
        n_sets = copies_for(2 * D_V * FF_LOC * es)
        xs = [rnd((M_T, D_V), dtype) for _ in range(n_sets)]
        wus = [rnd((D_V, FF_LOC), dtype, 0.02) for _ in range(n_sets)]
        wds = [rnd((FF_LOC, D_V), dtype, 0.02) for _ in range(n_sets)]
        got = ops.fused_pruned_ffn(xs[0], wus[0], wds[0], keep, None,
                                   ops.gelu, B8)
        ref = ops.fused_pruned_ffn_plain(xs[0], wus[0], wds[0], keep, None,
                                         ops.gelu, B8)
        timings = {
            "ms": time_ms(lambda i: ops.fused_pruned_ffn(
                xs[i], wus[i], wds[i], keep, None, ops.gelu, B8), n_sets),
            "device_ms": device_ms(lambda i: ops.fused_pruned_ffn(
                xs[i], wus[i], wds[i], keep, None, ops.gelu, B8), n_sets),
            "plain_ms": time_ms(lambda i: ops.fused_pruned_ffn_plain(
                xs[i], wus[i], wds[i], keep, None, ops.gelu, B8), n_sets),
            "library_ms": None}
        again = ops.fused_pruned_ffn(xs[0], wus[0], wds[0], keep, None,
                                     ops.gelu, B8)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            failures.append(f"fused_pruned_ffn train shape {dtype}: two "
                            "runs differ")
        record("fused_pruned_ffn", "train shape x[520,2048] w_up_r/w_down_r "
               "[2048,2048] gelu block 8 keep 30/256", dtype, got, ref,
               timings, (2 * M_T * D_V + 2 * D_V * C) * es,
               2 * 2 * M_T * D_V * C, False, "grad-kernels",
               tensor_cores=True)      # both stages above 16 rows
        stage_bytes = (M_T * D_V + D_V * C + M_T * C) * es
        ffn_stages(
            "grad-kernels", f"train shape {str(dtype)[6:]}",
            lambda i: ops.fused_pruned_ffn(xs[i], wus[i], wds[i], keep, None,
                                           ops.gelu, B8), n_sets,
            bound_ms(stage_bytes, 2 * M_T * D_V * C, str(dtype)[6:]),
            bound_ms(stage_bytes, 2 * M_T * D_V * C, str(dtype)[6:]),
            (bound_ms(stage_bytes, 2 * M_T * D_V * C, "3xtf32")[0],) * 2
            if f32 else None)
        del xs, wus, wds

    # block 128 at a small shape: compact modes and an unsorted keep list
    # (compact slot k pairs with block keep[k]), outputs NaN-filled
    for dtype in (torch.float32, torch.bfloat16):
        nb, M, N, blk128 = 6, 70, 96, 128
        keep = torch.tensor([4, 0, 3], dtype=torch.int32, device=dev)
        kb, K = 3, nb * blk128
        order = ops.inverse_order(keep, nb)
        s = {"dy": rnd((M, N), dtype), "w": rnd((K, N), dtype),
             "x": rnd((M, K), dtype), "xc": rnd((M, kb * blk128), dtype),
             "wo": rnd((N, K), dtype), "dyc": rnd((M, kb * blk128), dtype)}
        small = [
            ("pruned_matmul_dx", "block 128 compact_out unsorted keep",
             lambda s, out: ops.pruned_matmul_dx(
                 s["dy"], s["w"], keep, kb=kb, block=blk128,
                 compact_out=True, out=out),
             lambda s: ops.pruned_matmul_dx_plain(s["dy"], s["w"], keep, kb,
                                                  blk128, True),
             (M, kb * blk128)),
            ("pruned_matmul_dx", "block 128 scattered unsorted keep",
             lambda s, out: ops.pruned_matmul_dx(
                 s["dy"], s["w"], order, kb=kb, block=blk128, out=out),
             lambda s: ops.pruned_matmul_dx_plain(s["dy"], s["w"], order, kb,
                                                  blk128), (M, K)),
            ("pruned_matmul_dw", "block 128 x_compact unsorted keep",
             lambda s, out: ops.pruned_matmul_dw(
                 s["xc"], s["dy"], order, kb=kb, block=blk128,
                 x_compact=True, out=out),
             lambda s: ops.pruned_matmul_dw_plain(s["xc"], s["dy"], order,
                                                  kb, blk128, True), (K, N)),
            ("outpruned_matmul", "block 128 unsorted keep",
             lambda s, out: ops.outpruned_matmul(s["dy"], s["wo"], keep,
                                                 block=blk128, out=out),
             lambda s: ops.outpruned_matmul_plain(s["dy"], s["wo"], keep,
                                                  blk128), (M, kb * blk128)),
            ("outpruned_matmul_dx", "block 128 unsorted keep",
             lambda s, out: ops.outpruned_matmul_dx(s["dyc"], s["wo"], keep,
                                                    block=blk128, out=out),
             lambda s: ops.outpruned_matmul_dx_plain(s["dyc"], s["wo"], keep,
                                                     blk128), (M, N)),
            ("outpruned_matmul_dw", "block 128 unsorted keep",
             lambda s, out: ops.outpruned_matmul_dw(
                 s["dy"], s["dyc"], order, kb=kb, block=blk128, out=out),
             lambda s: ops.outpruned_matmul_dw_plain(s["dy"], s["dyc"], order,
                                                     kb, blk128), (N, K)),
        ]
        for name, case, kernel, plain, shape in small:
            grad_case(name, case, dtype, lambda s=s: s, kernel, plain, None,
                      shape, 0, 0, False, timed=False)
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"grad kernel checks failed: {failures}")
    say("grad-kernels", f"all {len(checked)} kernel checks (phases 2 and 6) "
        "within tolerance; the backward family's outputs bit-identical "
        "between two runs")

    # ---------------------------------------------------------------- 7
    # one controlled step of a two-layer, full-width ViT-1B in f32 at
    # tp = 4: rank 0 resized (bucket 7) and the source of a 2-block shed;
    # the kernel path against the plain path on the same inputs
    from repro_torch.config import TrainConfig
    from repro_torch.data.pipeline import PatternImageStream, patchify
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import run_training
    from repro_torch.models import vit as vit_lib
    from repro_torch.optim import adamw

    vit_full = get_config("vit-1b")
    vit2 = dataclasses.replace(vit_full, num_layers=2, name="vit-1b-2layer")
    st4 = PlanStatic(block_size=8, tp_size=4, mig_shed=(2,))
    st4 = dataclasses.replace(
        st4, scope_blocks=scopes_lib.scope_block_table(vit2, st4))
    vscopes = scopes_lib.control_scopes(vit2, st4)
    prng = np.random.default_rng(7)
    vpri = scopes_lib.plan_pri_arrays(
        vscopes, {n: prng.permutation(nb * (1 if scopes_lib.SCOPE_LAYOUT[n]
                                            == "col" else 4))
                  for n, nb in vscopes.items()}, 4, device=dev)
    img = next(iter(PatternImageStream(batch_size=8, seed=3)))
    vbatch = {"patches": torch.from_numpy(patchify(img["images"])).to(dev),
              "labels": torch.from_numpy(img["labels"]).to(dev)}
    res = {}
    for use_kernel in (True, False):
        m2 = vit_lib.init(torch.Generator(device=dev).manual_seed(2), vit2,
                          torch.float32, dev)
        ctx = ControlContext(static=st4, bucket_by_rank=[7, 0, 0, 0],
                             pri=vpri, use_kernel=use_kernel, mig_src=[0])
        ops.reset_launch_counts()
        loss, _ = vit_lib.loss_fn(m2, vit2, vbatch, ctx=ctx)
        loss.backward()
        torch.cuda.synchronize()
        res[use_kernel] = (float(loss.detach()), {n: p.grad.float() for n, p in
                                         m2.named_parameters()},
                           ops.launch_counts())
        del m2
    (lk, gk, ck), (lp, gp, _) = res[True], res[False]
    worst, worst_name = 0.0, ""
    for n, ref in gp.items():
        rel = float((gk[n] - ref).abs().max()) / max(
            float(ref.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    path_kernels = ("block_pruned_matmul", "fused_pruned_ffn",
                    "pruned_matmul_dx", "pruned_matmul_dw",
                    "outpruned_matmul", "outpruned_matmul_dx",
                    "outpruned_matmul_dw")
    ok = (math.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)
          and worst <= F32_TOL and all(ck[k] > 0 for k in path_kernels))
    say("train-reference", f"vit-1b width, 2 layers, f32, tp 4, buckets "
        f"[7,0,0,0], source rank 0 shedding 2 blocks: loss kernel {lk:.7f} "
        f"vs plain {lp:.7f}; {len(gp)} gradients, worst max|err|/max|ref| "
        f"{worst:.2e} ({worst_name}); launches {ck} "
        f"{'ok' if ok else 'FAIL'}")
    del res, gk, gp
    if not ok:
        raise SystemExit("train reference check failed")

    # ---------------------------------------------------------------- 8
    # the port's run_training on full-width ViT-1B (24 layers, f32,
    # random weights from the seed) at tp = 4 under SEMI. The learning
    # rate is 1e-4: the trainer's default 3e-3 is the smoke width's, and
    # at full width Adam's first steps at that rate throw the loss from
    # 2.4 to ~20 (finite, but no training curve)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_steps, lr_full = 12, 1e-4
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = run_training("vit-1b", model_cfg=vit_full, steps=n_steps, tp=4,
                        control_mode="semi", hetero_kind="round_robin",
                        chi=4.0, mig_blocks=2, use_kernel=True, batch=8,
                        lr=lr_full, seed=0, quiet=True, device="cuda")
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    train_launches = ops.launch_counts()
    twalls = np.asarray(hist["wall_s"])
    resized = sum(1 for b in hist["buckets"] if max(b) > 0)
    migrating = sum(1 for srcs, _ in hist["mig_shed"] if srcs)
    problems = []
    if len(hist["loss"]) != n_steps or not all(
            math.isfinite(v) for v in hist["loss"]):
        problems.append(f"a loss is not finite: {hist['loss']}")
    for k in path_kernels:
        if train_launches[k] <= 0:
            problems.append(f"{k} never launched")
    if resized == 0 or migrating == 0:
        problems.append(f"{resized} resized and {migrating} migrating steps")
    say("train", f"vit-1b full width (24 layers, d 2048, d_ff 8192, f32), "
        f"tp 4 SEMI round_robin chi 4, mig_blocks 2, batch 8, lr "
        f"{lr_full}: {n_steps} "
        f"steps in {t_run:.2f} s ({twalls.sum():.2f} s in steps): "
        f"{8 * n_steps / twalls.sum():.2f} images/s wall; step wall p50 "
        f"{np.percentile(twalls, 50) * 1e3:.1f} ms, max "
        f"{twalls.max() * 1e3:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {resized} "
        f"steps resized, {migrating} migrating; signatures "
        f"{sorted(set(hist['signatures']))}; plan builds "
        f"{hist['plan_compiles']}, hits {hist['plan_cache_hits']}")
    say("train", f"loss {[round(v, 4) for v in hist['loss']]}")
    say("train", f"launches {train_launches}")
    if problems:
        raise SystemExit(f"train check failed: {problems}")
    del hist

    # ---------------------------------------------------------------- 9
    # where a train step's time goes: three steps of the same model under
    # the run's typical plan, under the profiler
    torch.cuda.empty_cache()
    st_run = PlanStatic(block_size=8, tp_size=4, mig_shed=(2,))
    tstep = steps_lib.build_train_step(
        vit_full, TrainConfig(learning_rate=lr_full, steps=4), st_run,
        total_steps=4, use_kernel=True)
    mfull = vit_lib.init(torch.Generator(device=dev).manual_seed(0), vit_full,
                         torch.float32, dev)
    opt = adamw.init(dict(mfull.named_parameters()))
    run_scopes = scopes_lib.control_scopes(vit_full, st_run)
    plan = {"bucket_by_rank": np.asarray([7, 0, 0, 0], np.int32),
            "mig_src": np.asarray([0], np.int32),
            "pri": scopes_lib.plan_pri_arrays(run_scopes, {}, 4, device=dev)}
    opt, _ = tstep(mfull, opt, vbatch, plan)            # warm-up
    torch.cuda.synchronize()
    n_prof = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            opt, met = tstep(mfull, opt, vbatch, plan)
        torch.cuda.synchronize()
        twall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    trows = kernel_times(prof)
    tdev_ms = sum(r[2] for r in trows) / n_prof

    def train_family(name):
        # #2 and #3's down product share the tensor-core core with #8-#12:
        # by policy first
        for key, fam in (("FfnPolicy", "pruned-FFN hidden stage #3"),
                         ("FfnGatedPolicy", "pruned-FFN hidden stage #3"),
                         ("BpmPolicy", "block-pruned forward #2 (+ FFN down)"),
                         ("pruned_gemm", "backward family #8-#12"),
                         ("bpm_", "block-pruned forward #2 (+ FFN down)"),
                         ("ffn_hidden", "pruned-FFN hidden stage #3"),
                         ("reduce_splits", "split reductions")):
            if key in name:
                return fam
        low = name.lower()
        if any(t in low for t in ("gemm", "gemv", "cutlass", "nvjet",
                                  "cublas", "sm90", "xmma")):
            return "library matmul (dense ranks, attention, head)"
        if "foreach" in low or "multi_tensor" in low:
            return "AdamW (foreach)"
        return "elementwise / indexing / copies / other"
    tfams = {}
    for name, calls, ms in trows:
        f = tfams.setdefault(train_family(name), [0, 0.0])
        f[0] += calls
        f[1] += ms
    tnames = [name for name, _, _ in trows]
    missing = [k for k in ("BpmPolicy", "OpDxPolicy", "FfnPolicy")
               if not any(k in n for n in tnames)]
    if missing or any("pruned_gemm_kernel" in n
                      or "ffn_hidden_partial_kernel" in n for n in tnames):
        raise SystemExit(f"train-profile: tensor-core policies {missing} "
                         "never launched, or a CUDA-core product "
                         "(pruned_gemm_kernel, ffn_hidden_partial_kernel) "
                         "did")
    say("train-profile", f"full-width step, plan [7,0,0,0] + source 0: wall "
        f"{twall_ms:.1f} ms/step, device kernels {tdev_ms:.1f} ms/step, "
        f"device busy {tdev_ms / twall_ms:.1%} (idle "
        f"{1 - tdev_ms / twall_ms:.1%})")
    for fam, (calls, ms) in sorted(tfams.items(), key=lambda kv: -kv[1][1]):
        say("train-profile", f"  {fam}: {ms / n_prof:.2f} ms/step, "
            f"{calls / n_prof:.0f} kernels/step")
    for name, calls, ms in trows:
        if train_family(name) in ("backward family #8-#12",
                                  "block-pruned forward #2 (+ FFN down)",
                                  "pruned-FFN hidden stage #3",
                                  "split reductions"):
            say("train-profile", f"  kernel: {ms / n_prof:.2f} ms/step, "
                f"{calls / n_prof:.0f}/step  {name[:110]}")
    for name, calls, ms in trows[:10]:
        say("train-profile", f"  top: {ms / n_prof:.2f} ms/step, "
            f"{calls / n_prof:.0f}/step  {name[:90]}")
    del mfull, opt

    # ------------------------------------------------------------- resume
    # checkpoint / resume at full ViT-1B width (d 2048, d_ff 8192, 16
    # heads; f32; tp 4; SEMI with a static χ 4 straggler; times="measured",
    # so the estimator's window rides in the checkpoint), depth cut to 4 of
    # 24 layers so that three full-state saves (about 2.4 GB each: params
    # and both AdamW moments) fit the disk: N steps uninterrupted against
    # k steps, a "crash", and a fresh run_training(..., resume=True) up to
    # N. Losses, signatures, buckets, mig_shed and chi_hat must be
    # bit-identical, and so must every parameter and moment after step N
    # (the two runs' final checkpoints). Then the serve engine's warm load:
    # a two-layer, full-width Yi-6B written by store.save in f32, loaded
    # through ServeEngine(ckpt_dir=...) in bf16, answers two requests
    import shutil
    from repro_torch import bridge
    from repro_torch.checkpoint import store as ckpt_store
    free()
    ck_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck_root, ignore_errors=True)
    vit_cut = dataclasses.replace(vit_full, num_layers=4,
                                  name="vit-1b-4layer")
    n_res, k_res = 8, 4
    kw_res = dict(model_cfg=vit_cut, tp=4, control_mode="semi",
                  hetero_kind="static", chi=4.0, mig_blocks=2,
                  times="measured", use_kernel=True, batch=8, lr=lr_full,
                  seed=0, quiet=True, device="cuda", ckpt_every=1000)
    t0 = time.perf_counter()
    h_full = run_training("vit-1b", steps=n_res,
                          ckpt_dir=str(ck_root / "full"), **kw_res)
    t_full = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_first = run_training("vit-1b", steps=k_res,
                           ckpt_dir=str(ck_root / "cut"), **kw_res)
    t_first = time.perf_counter() - t0
    ck_bytes = sum(f.stat().st_size for f in (ck_root / "cut").iterdir())
    # the save alone: the state of step k written once more, timed
    saved = ckpt_store.load_arrays(str(ck_root / "cut"), k_res)
    t0 = time.perf_counter()
    ckpt_store.save(str(ck_root / "again"), k_res, saved)
    t_save = time.perf_counter() - t0
    del saved
    shutil.rmtree(ck_root / "again")
    t0 = time.perf_counter()
    model_like = vit_lib.init(None, vit_cut, torch.float32, dev)
    bridge.load_vit_params(model_like, ckpt_store.restore(
        str(ck_root / "cut"), k_res, bridge.vit_params_to_numpy(model_like),
        prefix="params"))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    del model_like
    t0 = time.perf_counter()
    h_res = run_training("vit-1b", steps=n_res, resume=True,
                         ckpt_dir=str(ck_root / "cut"), **kw_res)
    t_res = time.perf_counter() - t0
    problems = []
    for key in ("loss", "signatures", "buckets", "mig_shed"):
        if h_first[key] + h_res[key] != h_full[key]:
            problems.append(f"{key} differs after the resume")
    if h_res["chi_hat"] != h_full["chi_hat"]:
        problems.append("chi_hat differs after the resume")
    if not any(srcs for srcs, _ in h_full["mig_shed"]):
        problems.append("no step migrated")
    end_full = ckpt_store.load_arrays(str(ck_root / "full"), n_res)
    end_res = ckpt_store.load_arrays(str(ck_root / "cut"), n_res)

    def leaves(t, p=""):
        if isinstance(t, dict):
            for k_, v in t.items():
                yield from leaves(v, f"{p}/{k_}")
        else:
            yield p, t
    lf, lr_ = dict(leaves(end_full)), dict(leaves(end_res))
    differ = [k_ for k_ in lf if k_ not in lr_
              or lf[k_].tobytes() != lr_[k_].tobytes()]
    if differ or lf.keys() != lr_.keys():
        problems.append(f"{len(differ)} of {len(lf)} leaves differ after "
                        f"step {n_res}: {differ[:4]}")
    say("resume", f"vit-1b full width, depth 4 of 24 (d 2048, d_ff 8192, "
        f"f32), tp 4 SEMI static chi 4, measured: {n_res} steps "
        f"uninterrupted ({t_full:.2f} s) vs {k_res} ({t_first:.2f} s) + "
        f"resume to {n_res} ({t_res:.2f} s); checkpoint {ck_bytes} bytes "
        f"({ck_bytes / 2**30:.2f} GiB), save {t_save:.2f} s, params load "
        f"{t_load:.2f} s; losses, signatures, buckets, mig_shed, chi_hat "
        f"and {len(lf)} leaves after step {n_res} "
        f"{'bit-identical' if not problems else 'DIFFER'}; migrating "
        f"steps {sum(1 for srcs, _ in h_full['mig_shed'] if srcs)}")
    del end_full, end_res, lf, lr_
    shutil.rmtree(ck_root, ignore_errors=True)
    if problems:
        raise SystemExit(f"resume check failed: {problems}")

    # the warm load: two-layer, full-width Yi-6B in f32 through the store
    src = lm_lib.init(torch.Generator(device=dev).manual_seed(21), cfg2,
                      torch.float32, dev)
    t0 = time.perf_counter()
    ckpt_store.save(str(ck_root / "yi"), 1, bridge.params_to_numpy(src))
    t_save = time.perf_counter() - t0
    yi_bytes = sum(f.stat().st_size for f in (ck_root / "yi").iterdir())
    t0 = time.perf_counter()
    eng = ServeEngine("yi-6b", model_cfg=cfg2, num_slots=2, max_len=64,
                      param_dtype="bfloat16", ckpt_dir=str(ck_root / "yi"),
                      control=ControlConfig(fused_attention=True),
                      device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    same = all(torch.equal(a, b.to(a.dtype)) for a, b in zip(
        eng.params.parameters(), src.parameters()))
    rq = np.random.default_rng(4)
    cs = eng.run([Request(uid=i, prompt=rq.integers(0, VOCAB, (8,)).astype(
        np.int32), max_new_tokens=8) for i in range(2)])
    eng.close()
    ok = (same and len(cs) == 2 and all(len(c.tokens) == 8 for c in cs)
          and all(((c.tokens >= 0) & (c.tokens < VOCAB)).all() for c in cs))
    say("resume", f"warm load: yi-6b full width, 2 layers, f32 checkpoint "
        f"{yi_bytes} bytes ({yi_bytes / 2**30:.2f} GiB) saved in "
        f"{t_save:.2f} s; ServeEngine(ckpt_dir=...) built and loaded in bf16 "
        f"in {t_load:.2f} s; params equal the saved ones cast to bf16: "
        f"{same}; 2 requests answered: {[c.tokens.tolist() for c in cs]} "
        f"{'ok' if ok else 'FAIL'}")
    del eng, src
    shutil.rmtree(ck_root, ignore_errors=True)
    free()
    if not ok:
        raise SystemExit("warm load check failed")

    # ---------------------------------------------------------------- out
    # launches: the serving kernels from the serve run (phase 4), the
    # backward family from the train run (phase 8)
    kernels = []
    # launches of each kernel from the run of its path: #1-#3 the Yi-6B
    # slot-cache serve (phase 4), #4 the paged Yi-6B serve, #5 / #6 the
    # DeepSeek slot-cache / paged serves, #7 the analysis phase (its
    # micro_kernel cases), #8-#12 the train run (phase 8)
    launch_source = {"fused_paged_decode_attention": paged_launches,
                     "fused_mla_decode_attention": mla_launches,
                     "fused_paged_mla_decode_attention": mla_paged_launches,
                     "unfused_decode_attention": an_launches}
    for name in ("fused_decode_attention", "block_pruned_matmul",
                 "fused_pruned_ffn", "fused_paged_decode_attention",
                 "fused_mla_decode_attention",
                 "fused_paged_mla_decode_attention", "pruned_matmul_dx",
                 "pruned_matmul_dw", "outpruned_matmul",
                 "outpruned_matmul_dx", "outpruned_matmul_dw",
                 "unfused_decode_attention"):
        k = per_kernel[name]
        n_launch = launch_source.get(
            name, launches if name in serve_kernels else train_launches)[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": int(n_launch),
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"],
                        "library_ms": k["library_ms"]})
    say("done", f"every phase passed in {time.perf_counter() - t_start:.1f}"
        " s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
