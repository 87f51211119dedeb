#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line of its own; any failure exits non-zero:

1. setup    — refuse to run without CUDA; print the card's name and power
              limit (nvidia-smi); build the CUDA C++ kernels from
              ``src/repro_torch/kernels/csrc`` (one nvcc per source, all
              started together) and print the build seconds.
2. kernels  — each kernel against its plain PyTorch version on the card,
              at the shapes full-width Yi-6B serving with 8 slots gives it,
              in float32 (max |err| <= 1e-4 * max |ref|) and bfloat16
              (max |err| <= 2e-2 * max |ref|), plus block 8 at a small
              shape; each timed with CUDA events beside its plain version,
              a one-call PyTorch yardstick where one exists, and its bound
              at 3.35 TB/s and 989 (bf16) / 67 (f32) TFLOP/s.
3. reference — one decode step of a two-layer, full-width Yi-6B in float32
              under a resizing plan: the kernel path against the plain
              path, on the same inputs.
4. serve    — the port's ServeEngine serves 16 requests at full Yi-6B
              width (32 layers, bf16, random weights from a seed) under
              ZERO-resizing with a contended simulated 8-rank group and
              both kernel switches on; every launch count is set to 0
              just before and read just after, and each must be > 0.
5. profile  — eight decode-only steps of the same engine under
              torch.profiler: wall vs device-kernel time per step and
              the device time by kernel family.

Then one JSON line of per-kernel numbers and, last, the JSON line
``{"ok": true, "device": {...}}``. The engine's latencies are MODELED (a
host-CPU calibration) and are not printed as card times; the serve phase
prints host wall-clock numbers only.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
F32_TOL, BF16_TOL = 1e-4, 2e-2
REPLACES = {
    "block_pruned_matmul": "src/repro/kernels/pruned_matmul.py:81",
    "fused_pruned_ffn": "src/repro/kernels/pruned_matmul.py:547",
    "fused_decode_attention": "src/repro/kernels/decode_attn.py:129",
}
SOURCES = {
    "block_pruned_matmul": "src/repro_torch/kernels/csrc/block_pruned_matmul.cu",
    "fused_pruned_ffn": "src/repro_torch/kernels/csrc/fused_pruned_ffn.cu",
    "fused_decode_attention": "src/repro_torch/kernels/csrc/gqa_decode_attn.cu",
}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def bound_ms(nbytes, flops, dtype_name):
    """Least time for the work: bytes over HBM rate vs flops over peak."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[dtype_name]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def main():
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

    def device_ms(fn, n_sets, iters=10):
        """Device time per call (sum of its kernels, from the profiler):
        what the card spends, without the host's launch gaps. None when
        the profiler records no device activity."""
        fn(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
               representative):
        e, m = errs(got, ref)
        finite = bool(torch.isfinite(got.float()).all())
        tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * m
        ok = finite and e <= tol
        dname = str(dtype).replace("torch.", "")
        b_ms, b_by = bound_ms(nbytes, flops, dname)
        checked.append(f"{name} {case} {dname}")
        t = ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else
                      f"{k} {v}" for k, v in timings.items())
        say("kernels", f"{name} {case} {dname}: max|err| {e:.3e} "
            f"(max|ref| {m:.3e}, rel {e / max(m, 1e-30):.2e}) "
            f"{'ok' if ok else 'FAIL'}; {t}; bound {b_ms:.4f} ms "
            f"({b_by})")
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
                                          n_sets)}
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
            got = ops.fused_decode_attention(qs[0], ks[0], vs[0], cur_pos=cur,
                                             window=window)
            ref = ops.gqa_decode_attn_plain(qs[0], ks[0], vs[0], cur, window)
            pos = torch.arange(S, device=dev)[None, :]
            mask = pos <= cur.long()[:, None]
            if window:
                mask = mask & (pos > cur.long()[:, None] - window)
            mask = mask[:, None, None, :]

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
                "library_ms": time_ms(sdpa, n_sets)}
            rows = int(mask.sum())                 # attended rows, all slots
            nbytes = (rows * Hkv * 2 * D + 2 * B * Hq * D) * es + B * 4
            flops = rows * (Hq // Hkv) * Hkv * 2 * 2 * D
            record("fused_decode_attention",
                   f"q[8,32,1,128] kv[8,4,1024,128] window {window} cur_pos "
                   f"{cur_np.tolist()}", dtype, got, ref, timings, nbytes,
                   flops, dtype == torch.bfloat16 and window == 0)
        del qs, ks, vs
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")
    say("kernels", f"all {len(checked)} kernel checks within "
        "tolerance")

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
    if min(launches.values()) <= 0:
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
    for i in range(8):
        eng.submit(Request(uid=1000 + i, prompt=rng.integers(
            0, VOCAB, (16,)).astype(np.int32), max_new_tokens=24,
            arrival_step=eng.step_count))
    for _ in range(4):                  # admit + prefill + first decodes
        eng.step()
    torch.cuda.synchronize()
    n_prof = 8
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            eng.step()
        torch.cuda.synchronize()
        pwall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    rows = kernel_times(prof)
    dev_step_ms = sum(r[2] for r in rows) / n_prof

    def family(name):
        for key, fam in (("bpm_", "block-pruned products (proj + FFN down)"),
                         ("ffn_hidden", "fused_pruned_ffn hidden stage"),
                         ("gqa_decode", "fused_decode_attention"),
                         ("reduce_splits", "split reductions")):
            if key in name:
                return fam
        low = name.lower()
        if any(t in low for t in ("gemm", "gemv", "cutlass", "nvjet",
                                  "cublas")):
            return "library matmul (dense products, LM head)"
        return "elementwise / indexing / other"
    fams = {}
    for name, calls, ms in rows:
        f = fams.setdefault(family(name), [0, 0.0])
        f[0] += calls
        f[1] += ms
    say("profile", f"decode-only step, 8 active slots: wall {pwall_ms:.2f} "
        f"ms/step, device kernels {dev_step_ms:.2f} ms/step, device busy "
        f"{dev_step_ms / pwall_ms:.1%} (idle {1 - dev_step_ms / pwall_ms:.1%})")
    for fam, (calls, ms) in sorted(fams.items(), key=lambda kv: -kv[1][1]):
        say("profile", f"  {fam}: {ms / n_prof:.3f} ms/step, "
            f"{calls / n_prof:.0f} kernels/step")
    for name, calls, ms in rows[:8]:
        say("profile", f"  top: {ms / n_prof:.3f} ms/step, {calls / n_prof:.0f}"
            f"/step  {name[:90]}")

    # ---------------------------------------------------------------- out
    kernels = []
    for name in ("fused_decode_attention", "block_pruned_matmul",
                 "fused_pruned_ffn"):
        k = per_kernel[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": int(launches[name]),
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"],
                        "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
