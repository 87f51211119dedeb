"""Device time of the port's decode attentions at the shapes of its main
paths, for an A/B of two checkouts on one card: #1
(``fused_decode_attention``) and #4 (``fused_paged_decode_attention``) at
the smoke run's phase-2 shapes and positions (full-width Yi-6B at 8 slots:
q [8, 32, 1, 128], a 1024-row cache or 64 pages of 16 per slot, cur_pos
0, 127, 128, 1023, 2**30, 31, 500, 777; windows 0 and 200) and at a decode
step's positions (8 slots attending 64 to 320 rows); #5 / #6 (the MLA
decode attentions, full-width DeepSeek-V2-Lite: q_abs [8, 16, 512], q_rope
[8, 16, 64], a 1024-row latent / rope cache or 64 pages of 16 per slot
through a shuffled page table) at the same two sets of positions; #7 (the
unfused baseline, three launches) at #1's shapes and the same positions;
each in float32 and bfloat16. It calls only the wrappers that every
checkout of the port has, so the same file times any of them:

    PYTHONPATH=<checkout>/src python <this file>
    PYTHONPATH=src python <this file> --only decode    # cases naming it
    PYTHONPATH=src python <this file> --rows-sweep     # #1 / #4 by kRows
    PYTHONPATH=src python <this file> --mla-rows-sweep # #5 / #6 by kRows

Prints the card's name and power limit (nvidia-smi), then one JSON line
per case: the device time per call (the profiler's kernel time, inputs
rotated past the 50 MB L2) and its share by ``__global__`` function (#7:
scores, softmax, wsum; #5 / #6: partial and merge), the host time per
call (50 calls enqueued without a synchronise), the device time of one
``scaled_dot_product_attention`` call on the same rows (masked; paged
rows gathered beforehand; MLA as one KV head of [latent | rope] keys and
latent values), and the bound: the bytes the function must move (each
attended row, q and the output once) over 3.35 TB/s (#7 also its own
traffic: every K/V row and the f32 score matrix written, read, written
and read). ``--rows-sweep`` builds ``csrc/gqa_decode_attn.cu`` once per
rows-per-block value (``-DGQA_ROWS_PER_BLOCK``) and ``--mla-rows-sweep``
``csrc/mla_decode_attn.cu`` (``-DMLA_ROWS_PER_BLOCK``), one nvcc each, all
started together, and time #1 and #4 (#5 and #6) in bf16 through each
build. Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import time
import types

HBM_BYTES_PER_S = 3.35e12
PHASE2_CUR = (0, 127, 128, 1023, 2 ** 30, 31, 500, 777)
STEP_CUR = (63, 99, 136, 172, 209, 246, 282, 319)   # 64..320 rows
SWEEP_ROWS = (32, 64, 128, 256)
MLA_SWEEP_ROWS = (32, 64, 128)
# one sweep: (source, -D macro, entry points, the wrapper's rows constant)
SWEEPS = {
    "gqa": ("gqa_decode_attn.cu", "GQA_ROWS_PER_BLOCK",
            ("repro_gqa_decode_attn", "repro_gqa_paged_decode_attn"),
            "GQA_ROWS"),
    "mla": ("mla_decode_attn.cu", "MLA_ROWS_PER_BLOCK",
            ("repro_mla_decode_attn", "repro_mla_paged_decode_attn"),
            "MLA_ROWS"),
}


def _sweep_builds(kind, rows_list):
    """{rows: ctypes library} of the sweep's source built with kRows =
    rows, under build/attn_sweep/ of this checkout."""
    from repro_torch.kernels import build

    source, macro, entries, _ = SWEEPS[kind]
    out_root = build.build_root().parent / "attn_sweep"
    out_root.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for rows in rows_list:
        so = out_root / f"{kind}_rows{rows}.so"
        procs[rows] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, f"-D{macro}={rows}", "-shared", "-o",
             str(so), str(build.CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for rows, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc (kRows {rows}) failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for name in entries:
            fn = getattr(lib, name)
            fn.argtypes = list(build.SIGNATURES[name])
            fn.restype = ctypes.c_int
        libs[rows] = lib
    return libs


def main(argv=None) -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        print("attn_timing: needs a CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:] if argv is None else argv
    rows_sweep = "--rows-sweep" in args
    mla_rows_sweep = "--mla-rows-sweep" in args
    only = args[args.index("--only") + 1] if "--only" in args else None
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, Hq, Hkv, S, D, PS = 8, 32, 4, 1024, 128, 16
    PPS, N_PAGES = S // PS, B * S // PS

    def device_ms(fn, n_sets, iters=20):
        for i in range(3):
            fn(i % n_sets)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i % n_sets)
            torch.cuda.synchronize()
        by_fn = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", 0.0)
            if us > 0:
                key = e.key.replace("(anonymous namespace)::", "")
                name = re.search(r"(\w*kernel\w*(<[^>(]*>)?)", key)
                name = name[1] if name else key[:60]
                by_fn[name] = by_fn.get(name, 0.0) + us / 1e3 / iters
        return sum(by_fn.values()), by_fn

    def host_us(fn, n=50):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(0)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def n_sets_for(nbytes):
        return max(1, min(32, math.ceil(200e6 / max(nbytes, 1))))

    def page_table(cur):
        perm = np.random.default_rng(4).permutation(N_PAGES)
        table = np.full((B, PPS), -1, np.int32)
        used = 0
        for b, c in enumerate(cur):
            n = PPS - 2 if c >= S else c // PS + 1
            table[b, :n] = perm[used:used + n]
            used += n
        return torch.from_numpy(table).to(dev)

    try:                       # SDPA reads the KV heads itself, or not
        F.scaled_dot_product_attention(
            torch.zeros((1, 2, 1, 8), device=dev),
            torch.zeros((1, 1, 4, 8), device=dev),
            torch.zeros((1, 1, 4, 8), device=dev), enable_gqa=True)
        gqa_kw = {"enable_gqa": True}
    except TypeError:
        gqa_kw = None

    def heads(kv):
        """K / V as SDPA reads them: the KV heads broadcast to the query
        heads beforehand where this PyTorch has no enable_gqa."""
        return kv if gqa_kw else [x.repeat_interleave(Hq // Hkv, 1)
                                  for x in kv]

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              **(gqa_kw or {}))

    def gqa_cases(dtype):
        """(kernel, case, sets, call, library call, bound ms)."""
        es = torch.finfo(dtype).bits // 8
        n_sets = n_sets_for(2 * B * Hkv * S * D * es)
        qs = [rnd((B, Hq, 1, D), dtype) for _ in range(n_sets)]
        ks = [rnd((B, Hkv, S, D), dtype) for _ in range(n_sets)]
        vs = [rnd((B, Hkv, S, D), dtype) for _ in range(n_sets)]
        kps = [k.reshape(B, Hkv, PPS, PS, D).transpose(1, 2).reshape(
            N_PAGES, Hkv, PS, D) for k in ks]
        vps = [v.reshape(B, Hkv, PPS, PS, D).transpose(1, 2).reshape(
            N_PAGES, Hkv, PS, D) for v in vs]
        kx, vx = heads(ks), heads(vs)
        out = []
        for where, cur_l in (("phase 2", PHASE2_CUR), ("decode step",
                                                        STEP_CUR)):
            cur = torch.tensor(cur_l, dtype=torch.int32, device=dev)
            pages = page_table(cur_l)
            for window in ((0, 200) if where == "phase 2" else (0,)):
                ok = ops.attended_rows(S, cur, window, dev)
                rows = int(ok.sum())
                nbytes = (rows * Hkv * 2 * D + 2 * B * Hq * D) * es + B * 4
                mask = ok[:, None, None, :]
                out.append((
                    "fused_decode_attention",
                    f"{where} cur_pos {list(cur_l)} window {window}",
                    n_sets,
                    lambda i, c=cur, w=window: ops.fused_decode_attention(
                        qs[i], ks[i], vs[i], cur_pos=c, window=w),
                    lambda i, m=mask: sdpa(qs[i], kx[i], vx[i], m),
                    nbytes / HBM_BYTES_PER_S * 1e3))
                pok = ops.paged_attended_rows(pages, PS, N_PAGES, cur,
                                              window)
                prow = int(pok.sum())
                pbytes = ((prow * Hkv * 2 * D + 2 * B * Hq * D) * es
                          + B * 4 + B * PPS * 4)
                # the yardstick reads the slot's rows gathered beforehand
                out.append((
                    "fused_paged_decode_attention",
                    f"{where} cur_pos {list(cur_l)} window {window} "
                    f"pools[{N_PAGES},4,16,128]",
                    n_sets,
                    lambda i, c=cur, w=window, p=pages:
                    ops.fused_paged_decode_attention(
                        qs[i], kps[i], vps[i], pages=p, cur_pos=c, window=w),
                    lambda i, m=pok[:, None, None, :]: sdpa(
                        qs[i], kx[i], vx[i], m),
                    pbytes / HBM_BYTES_PER_S * 1e3))
        return out

    def mla_cases(dtype):
        """#5 / #6 at full DeepSeek-V2-Lite width, phase 2's and a decode
        step's positions."""
        es = torch.finfo(dtype).bits // 8
        H, R, DR = 16, 512, 64
        n_sets = n_sets_for(B * S * (R + DR) * es)
        qa = [rnd((B, H, R), dtype) for _ in range(n_sets)]
        qr = [rnd((B, H, DR), dtype) for _ in range(n_sets)]
        lat = [rnd((B, S, R), dtype) for _ in range(n_sets)]
        rope = [rnd((B, S, DR), dtype) for _ in range(n_sets)]
        # the yardstick: one KV head of keys [latent | rope], values latent
        qk = [torch.cat([a, r], -1)[:, :, None, :] for a, r in zip(qa, qr)]
        kk = [torch.cat([a, r], -1)[:, None] for a, r in zip(lat, rope)]
        vv = [x[:, None] for x in lat]
        kk, vv = ((kk, vv) if gqa_kw else
                  ([x.expand(B, H, S, R + DR) for x in kk],
                   [x.expand(B, H, S, R) for x in vv]))
        out = []
        for where, cur_l in (("phase 2", PHASE2_CUR), ("decode step",
                                                        STEP_CUR)):
            cur = torch.tensor(cur_l, dtype=torch.int32, device=dev)
            pages = page_table(cur_l)
            # the pools hold each slot's rows at its table's pages
            present = pages >= 0
            ids = pages[present].long()
            lp, rp = [], []
            for la, ro in zip(lat, rope):
                lpool = torch.zeros((N_PAGES, PS, R), dtype=dtype, device=dev)
                rpool = torch.zeros((N_PAGES, PS, DR), dtype=dtype,
                                    device=dev)
                lpool[ids] = la.reshape(B, PPS, PS, R)[present]
                rpool[ids] = ro.reshape(B, PPS, PS, DR)[present]
                lp.append(lpool)
                rp.append(rpool)
            for paged in (False, True):
                ok = (ops.paged_attended_rows(pages, PS, N_PAGES, cur)
                      if paged else ops.attended_rows(S, cur, 0, dev))
                rows = int(ok.sum())
                nbytes = ((rows * (R + DR) + B * H * (R + DR)) * es
                          + B * H * R * 4 + B * 4
                          + (B * PPS * 4 if paged else 0))
                if paged:
                    name = "fused_paged_mla_decode_attention"
                    call = (lambda i, c=cur, p=pages:
                            ops.fused_paged_mla_decode_attention(
                                qa[i], qr[i], lp[i], rp[i], pages=p,
                                cur_pos=c, head_dim_for_scale=192))
                else:
                    name = "fused_mla_decode_attention"
                    call = (lambda i, c=cur: ops.fused_mla_decode_attention(
                        qa[i], qr[i], lat[i], rope[i], cur_pos=c,
                        head_dim_for_scale=192))
                out.append((
                    name, f"{where} cur_pos {list(cur_l)}"
                    + (f" pools[{N_PAGES},16,512]" if paged else ""),
                    n_sets, call,
                    lambda i, m=ok[:, None, None, :]:
                    F.scaled_dot_product_attention(
                        qk[i], kk[i], vv[i], attn_mask=m,
                        scale=1 / math.sqrt(192), **(gqa_kw or {})),
                    nbytes / HBM_BYTES_PER_S * 1e3))
        return out

    def unfused_cases(dtype):
        """#7 at #1's shapes (full Yi-6B width), phase 2's and a decode
        step's positions: the function's bound (the attended rows) and,
        in the case's name, the bound of the kernel's own traffic."""
        es = torch.finfo(dtype).bits // 8
        n_sets = n_sets_for(2 * B * Hkv * S * D * es)
        qs = [rnd((B, Hq, 1, D), dtype) for _ in range(n_sets)]
        ks = [rnd((B, Hkv, S, D), dtype) for _ in range(n_sets)]
        vs = [rnd((B, Hkv, S, D), dtype) for _ in range(n_sets)]
        kx, vx = heads(ks), heads(vs)
        G = Hq // Hkv
        own = (2 * B * Hkv * S * D * es + 2 * B * Hq * D * es + B * 4
               + 4 * B * Hkv * G * S * 4)
        out = []
        for where, cur_l in (("phase 2", PHASE2_CUR), ("decode step",
                                                        STEP_CUR)):
            cur = torch.tensor(cur_l, dtype=torch.int32, device=dev)
            ok = ops.attended_rows(S, cur, 0, dev)
            rows = int(ok.sum())
            out.append((
                "unfused_decode_attention",
                f"{where} cur_pos {list(cur_l)} kv[8,4,1024,128]; own "
                f"traffic {own / HBM_BYTES_PER_S * 1e3:.4f} ms", n_sets,
                lambda i, c=cur: ops.unfused_decode_attention(
                    qs[i], ks[i], vs[i], cur_pos=c),
                lambda i, m=ok[:, None, None, :]: sdpa(qs[i], kx[i], vx[i],
                                                        m),
                ((rows * Hkv * 2 * D + 2 * B * Hq * D) * es + B * 4)
                / HBM_BYTES_PER_S * 1e3))
        return out

    def emit(name, case, dname, n_sets, call, library, bound, **extra):
        ms, fns = device_ms(call, n_sets)
        row = {"kernel": name, "case": case, "dtype": dname, **extra,
               "device_ms": ms, "functions": fns, "host_us": host_us(call),
               "library_device_ms": (device_ms(library, n_sets)[0]
                                     if library is not None else None),
               "bound_ms": bound}
        print(json.dumps(row), flush=True)

    for kind, on, rows_list, make in (
            ("gqa", rows_sweep, SWEEP_ROWS, gqa_cases),
            ("mla", mla_rows_sweep, MLA_SWEEP_ROWS, mla_cases)):
        if not on:
            continue
        libs = _sweep_builds(kind, rows_list)
        const = SWEEPS[kind][3]
        keep_lib, keep_rows = ops._build.library, getattr(ops, const)
        try:
            for dtype in (torch.bfloat16,):
                dname = str(dtype).replace("torch.", "")
                cases = make(dtype)
                for rows, lib in libs.items():
                    ops._build.library = (
                        lambda lib=lib: types.SimpleNamespace(lib=lib))
                    setattr(ops, const, rows)
                    for name, case, n_sets, call, _, bound in cases:
                        if only is None or only in f"{name} {case}":
                            emit(name, case, dname, n_sets, call, None,
                                 bound, rows_per_block=rows)
                del cases
                torch.cuda.empty_cache()
        finally:
            ops._build.library = keep_lib
            setattr(ops, const, keep_rows)
    if rows_sweep or mla_rows_sweep:
        return 0

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for make in (gqa_cases, mla_cases, unfused_cases):
            for name, case, n_sets, call, library, bound in make(dtype):
                if only is None or only in f"{name} {case}":
                    emit(name, case, dname, n_sets, call, library, bound)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
