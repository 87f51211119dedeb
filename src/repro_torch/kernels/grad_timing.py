"""Device time of the block-pruned products at the shapes of the port's
main paths, for an A/B of two checkouts on one card: the backward family
(#8-#12) and #2 at the ViT-1B train run's shapes (tp 4, 520 rows, block 8,
the keep counts of its straggler, as ``chip_smoke.py`` phase 6 times
them), #2 at the Yi-6B decode shapes (8 slots, block 128: `wq`,
`wk`, the FFN's down product with x_compact), and #3 (the pruned FFN)
at its two shapes: the ViT-1B train run's (520 rows, gelu, block 8,
keep 30/256: its hidden stage on the tensor-core core) and the Yi-6B
serving path's (8 slots, gated silu, block 128, keep 75/86: the decode
design), each in float32 and bfloat16. #3's line splits its device time
into its two stages, the hidden stage and the down product, by the
``__global__`` functions each launches. It calls only the wrappers that
every checkout of the port has, so the same file times any of them:

    PYTHONPATH=<checkout>/src python <this file>
    PYTHONPATH=src python <this file> --sweep       # #9 and #12's splits
    PYTHONPATH=src python <this file> --bpm-sweep   # #2's route by rows
    PYTHONPATH=src python <this file> --ffn-sweep   # #3's route and ranges
    PYTHONPATH=src python <this file> --only wq     # cases naming "wq"

Prints the card's name and power limit (nvidia-smi), then one JSON line
per case: the device time per call (the profiler's kernel time, inputs
rotated past the 50 MB L2) and its share by ``__global__`` function; the
host time per call (50 calls enqueued without a synchronise); and the
device time of one ``torch.matmul`` on the gathered operands, the
yardstick ``chip_smoke.py`` times with CUDA events (none for #3: no one
PyTorch call computes it). A function of the tensor-core core is named
with its policy (``pruned_gemm_tc_kernel<BpmPolicy>``). ``--sweep`` times #9
and #12 instead at each split count of their contraction (the wrapper's
own choice replaced, then rounded to whole ranges of stages as the
wrapper does). ``--bpm-sweep`` times #2 at M = 1, 8, 16, 32, 64, 128 and
520 rows through each of its two kernels (the decode kernel and the
tensor-core core, the route forced by ``ops.BPM_DECODE_MAX_ROWS``) at
Yi-6B's `wq` and ViT-1B's `wq_r`: the sweep behind that threshold.
``--ffn-sweep`` times #3 by stage the same way at its two shapes (both
stages route on that threshold), then its decode kernel at the serving
shape at each count of K ranges (``ops._ffn_decode_splits`` replaced).
Needs a CUDA device.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        print("grad_timing: needs a CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:] if argv is None else argv
    sweep = "--sweep" in args
    bpm_sweep = "--bpm-sweep" in args
    ffn_sweep = "--ffn-sweep" in args
    only = args[args.index("--only") + 1] if "--only" in args else None
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    M, D, ATT, FF, B = 520, 2048, 512, 2048, 8

    def keep_of(nb, kb, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.sort(torch.randperm(nb, generator=g)[:kb]).values.to(
            torch.int32).to(dev)

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
                name = re.search(r"(\w*kernel\w*)", e.key)
                name = name[1] if name else e.key[:40]
                policy = re.search(r"(\w+Policy)", e.key)
                if policy:
                    name += f"<{policy[1]}>"
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

    def rows(w, keep):
        return w.reshape(-1, B, w.shape[1])[keep.long()].reshape(
            -1, w.shape[1])

    def cols(x, keep):
        return x.reshape(x.shape[0], -1, B)[:, keep.long()].reshape(
            x.shape[0], -1)

    def cases(dtype):
        """(kernel, case, make, call, library) at the train shapes, and
        #2 at the decode shapes; make returns a tuple of operands, the
        gathered ones last."""
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev)
                    * scale).to(dtype)
        out = []
        for wname, N, nb, kb in (("wq", ATT, D // B, 32),
                                 ("wo", D, ATT // B, 8)):
            keep = keep_of(nb, kb, 11 + kb)
            order = ops.inverse_order(keep, nb)
            K = nb * B
            out.append((
                "pruned_matmul_dx", f"{wname} keep {kb}/{nb}",
                lambda N=N, K=K, keep=keep: (
                    rnd(M, N), w := rnd(K, N, scale=0.02), rows(w, keep).t()),
                lambda s, o=order, k=kb: ops.pruned_matmul_dx(
                    s[0], s[1], o, kb=k, block=B),
                lambda s: torch.matmul(s[0], s[2])))
            out.append((
                "pruned_matmul_dw", f"{wname} keep {kb}/{nb}",
                lambda N=N, K=K, keep=keep: (
                    x := rnd(M, K), rnd(M, N), cols(x, keep).t().contiguous()),
                lambda s, o=order, k=kb: ops.pruned_matmul_dw(
                    s[0], s[1], o, kb=k, block=B),
                lambda s: torch.matmul(s[2], s[1])))
        nb, kb = FF // B, 30
        keep = keep_of(nb, kb, 13)
        order = ops.inverse_order(keep, nb)
        C = kb * B
        out += [
            ("pruned_matmul_dx", "FFN dh compact",
             lambda: (rnd(M, D), w := rnd(FF, D, scale=0.02),
                      rows(w, keep).t()),
             lambda s: ops.pruned_matmul_dx(s[0], s[1], keep, kb=kb, block=B,
                                            compact_out=True),
             lambda s: torch.matmul(s[0], s[2])),
            ("pruned_matmul_dw", "FFN dW_down x_compact",
             lambda: (rnd(M, C), rnd(M, D)),
             lambda s: ops.pruned_matmul_dw(s[0], s[1], order, kb=kb,
                                            block=B, x_compact=True),
             lambda s: torch.matmul(s[0].t(), s[1])),
            ("outpruned_matmul", "FFN recompute",
             lambda: (rnd(M, D), w := rnd(D, FF, scale=0.02),
                      w.reshape(D, nb, B)[:, keep.long()].reshape(D, C)),
             lambda s: ops.outpruned_matmul(s[0], s[1], keep, block=B),
             lambda s: torch.matmul(s[0], s[2])),
            ("outpruned_matmul_dx", "FFN dx",
             lambda: (rnd(M, C), w := rnd(D, FF, scale=0.02),
                      cols(w, keep).t().contiguous()),
             lambda s: ops.outpruned_matmul_dx(s[0], s[1], keep, block=B),
             lambda s: torch.matmul(s[0], s[2])),
            ("outpruned_matmul_dw", "FFN dW_up",
             lambda: (x := rnd(M, D), rnd(M, C), x.t().contiguous()),
             lambda s: ops.outpruned_matmul_dw(s[0], s[1], order, kb=kb,
                                               block=B),
             lambda s: torch.matmul(s[2], s[1])),
        ]
        # #2: the ViT-1B train shapes, then Yi-6B decode at 8 slots (names
        # of their own: the FFN cases above read nb, kb and keep late)
        for wname, K2, N2, blk, nb2, kb2, xc, rows_ in (
                ("wq_r", D, ATT, B, D // B, 32, False, M),
                ("wo_r", ATT, D, B, ATT // B, 8, False, M),
                ("FFN down", FF, D, B, FF // B, 30, True, M),
                ("Yi wq", 4096, 4096, 128, 32, 28, False, 8),
                ("Yi wq", 4096, 4096, 128, 32, 4, False, 8),
                ("Yi wk", 4096, 512, 128, 32, 28, False, 8),
                ("Yi FFN down", 11008, 4096, 128, 86, 75, True, 8)):
            keep2 = keep_of(nb2, kb2, 17 + kb2)
            out.append((
                "block_pruned_matmul",
                f"{wname} x[{rows_},{kb2 * blk if xc else K2}] @ "
                f"w[{K2},{N2}] keep {kb2}/{nb2}" + (" x_compact" if xc
                                                     else ""),
                lambda rows_=rows_, K=K2, N=N2, blk=blk, kb=kb2, xc=xc,
                keep=keep2: (
                    x := rnd(rows_, kb * blk if xc else K),
                    w := rnd(K, N, scale=0.02),
                    x if xc else x.reshape(rows_, -1, blk)[
                        :, keep.long()].reshape(rows_, -1),
                    w.reshape(-1, blk, N)[keep.long()].reshape(-1, N)),
                bpm_call(keep2, blk, xc, K2, dtype),
                lambda s: torch.matmul(s[2], s[3])))
        return out

    def ffn_cases(dtype):
        """#3 at the train shape (tp 4, gelu, ungated, block 8) and the
        serving shape (8 slots, gated silu, block 128): (kernel, case,
        make, call, library); make returns x, w_up, w_down[, w_gate]."""
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev)
                    * scale).to(dtype)
        out = []
        for tag, rows_, K, H, blk, kb, gated in (
                ("ViT train", M, D, FF, B, 30, False),
                ("Yi serve", 8, 4096, 11008, 128, 75, True)):
            keep = keep_of(H // blk, kb, 23 + kb)
            act = ops.silu if gated else ops.gelu
            out.append((
                "fused_pruned_ffn",
                f"{tag} x[{rows_},{K}] w_up[{K},{H}] "
                f"{'gated silu' if gated else 'gelu'} block {blk} keep "
                f"{kb}/{H // blk}",
                lambda rows_=rows_, K=K, H=H, gated=gated: (
                    rnd(rows_, K), rnd(K, H, scale=0.02),
                    rnd(H, K, scale=0.02))
                + ((rnd(K, H, scale=0.02),) if gated else ()),
                lambda s, keep=keep, blk=blk, act=act: ops.fused_pruned_ffn(
                    s[0], s[1], s[2], keep, s[3] if len(s) > 3 else None,
                    act, blk),
                None))
        return out

    def ffn_stages(fns):
        """#3's device ms by stage: the down product's functions (#2's
        decode kernel or its policy on the tensor-core core, and its split
        sum), and the rest: the hidden stage."""
        down = sum(ms for fn, ms in fns.items()
                   if fn.startswith(("bpm_decode", "reduce_splits"))
                   or "BpmPolicy" in fn)
        return {"hidden": sum(fns.values()) - down, "down": down}

    def bpm_call(keep, blk, xc, K, dtype):
        """#2 through the public wrapper, or (x_compact, the FFN's down
        product) through the launcher the FFN wrapper calls."""
        code = 0 if dtype == torch.float32 else 1
        if xc:
            return lambda s: ops._launch_block_pruned(
                s[0], s[1], keep, blk, code, x_compact=True, K=K)
        return lambda s: ops.block_pruned_matmul(s[0], s[1], keep, block=blk)

    if bpm_sweep:
        if not hasattr(ops, "BPM_DECODE_MAX_ROWS"):
            print("grad_timing: this checkout has one route for #2",
                  file=sys.stderr)
            return 2
        limit = ops.BPM_DECODE_MAX_ROWS
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            for wname, K, N, blk, nb, kb in (
                    ("Yi wq", 4096, 4096, 128, 32, 28),
                    ("ViT wq_r", D, ATT, B, D // B, 32)):
                keep = keep_of(nb, kb, 19)
                for rows_ in (1, 8, 16, 32, 64, 128, 520):
                    n_sets = max(1, min(32, int(200e6 // (
                        K * N * dtype.itemsize))))
                    sets = [(torch.randn((rows_, K), generator=gen,
                                         device=dev).to(dtype),
                             (torch.randn((K, N), generator=gen, device=dev)
                              * 0.02).to(dtype)) for _ in range(n_sets)]
                    row = {}
                    for route, rmax in (("decode", 1 << 30), ("tc", 0)):
                        ops.BPM_DECODE_MAX_ROWS = rmax
                        row[route] = device_ms(
                            lambda i: ops.block_pruned_matmul(
                                sets[i][0], sets[i][1], keep, block=blk),
                            n_sets)[0]
                    ops.BPM_DECODE_MAX_ROWS = limit
                    print(json.dumps({
                        "kernel": "block_pruned_matmul", "case":
                        f"{wname} x[{rows_},{K}] @ w[{K},{N}] keep {kb}/{nb}",
                        "dtype": dname, "rows": rows_,
                        "decode_device_ms": row["decode"],
                        "tc_device_ms": row["tc"],
                        "route": "decode" if rows_ <= limit else "tc"}),
                        flush=True)
                    del sets
                    torch.cuda.empty_cache()
        return 0

    if ffn_sweep:
        limit = ops.BPM_DECODE_MAX_ROWS
        ffn_splits = ops._ffn_decode_splits
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            for tag, K, H, blk, kb, gated in (
                    ("Yi serve", 4096, 11008, 128, 75, True),
                    ("ViT train", D, FF, B, 30, False)):
                keep = keep_of(H // blk, kb, 29)
                act = ops.silu if gated else ops.gelu

                def rnd(*shape, scale=1.0):
                    return (torch.randn(shape, generator=gen, device=dev)
                            * scale).to(dtype)
                ws = (rnd(K, H, scale=0.02), rnd(H, K, scale=0.02),
                      rnd(K, H, scale=0.02) if gated else None)
                for rows_ in (1, 8, 16, 32, 64, 128, 520):
                    x = rnd(rows_, K)
                    row = {}
                    for route, rmax in (("decode", 1 << 30), ("tc", 0)):
                        ops.BPM_DECODE_MAX_ROWS = rmax
                        row[route] = ffn_stages(device_ms(
                            lambda i: ops.fused_pruned_ffn(
                                x, ws[0], ws[1], keep, ws[2], act, blk),
                            1)[1])
                    ops.BPM_DECODE_MAX_ROWS = limit
                    print(json.dumps({
                        "kernel": "fused_pruned_ffn", "case":
                        f"{tag} x[{rows_},{K}] w_up[{K},{H}] keep "
                        f"{kb}/{H // blk}", "dtype": dname, "rows": rows_,
                        "decode_stages": row["decode"],
                        "tc_stages": row["tc"],
                        "route": "decode" if rows_ <= limit else "tc"}),
                        flush=True)
                if gated:
                    x = rnd(8, K)
                    for splits in range(1, 17):
                        ops._ffn_decode_splits = (
                            lambda *a, s=splits: s)
                        print(json.dumps({
                            "kernel": "fused_pruned_ffn", "case":
                            f"{tag} x[8,{K}] keep {kb}/{H // blk}",
                            "dtype": dname, "splits": splits,
                            "wrapper_splits": ffn_splits(
                                8, K, kb * blk, dev),
                            "stages": ffn_stages(device_ms(
                                lambda i: ops.fused_pruned_ffn(
                                    x, ws[0], ws[1], keep, ws[2], act, blk),
                                1)[1])}), flush=True)
                    ops._ffn_decode_splits = ffn_splits
                del ws
                torch.cuda.empty_cache()
        return 0

    dw_partials = getattr(ops, "_dw_partials", None)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for name, case, make, call, library in cases(dtype) + ffn_cases(
                dtype):
            if sweep and not name.endswith("_dw"):
                continue
            if only is not None and only not in f"{name} {case}":
                continue
            first = make()
            n_sets = max(1, min(32, int(200e6 // sum(
                t.numel() * t.element_size() for t in first))))
            sets = [first] + [make() for _ in range(n_sets - 1)]
            if sweep:
                for splits in range(1, -(-M // ops.TC_DEPTH) + 1):
                    ops._dw_partials = (
                        lambda r, c, d, dv, s=splits: dw_partials(
                            r, c, d, dv, splits=s))
                    ms, fns = device_ms(lambda i: call(sets[i]), n_sets)
                    print(json.dumps({"kernel": name, "case": case,
                                      "dtype": dname, "splits": splits,
                                      "device_ms": ms, "functions": fns}),
                          flush=True)
                ops._dw_partials = dw_partials
            else:
                ms, fns = device_ms(lambda i: call(sets[i]), n_sets)
                row = {"kernel": name, "case": case, "dtype": dname,
                       "device_ms": ms, "functions": fns}
                if name == "fused_pruned_ffn":
                    row["stages"] = ffn_stages(fns)
                row["host_us"] = host_us(lambda i: call(sets[i]))
                row["library_device_ms"] = (
                    device_ms(lambda i: library(sets[i]), n_sets)[0]
                    if library is not None else None)
                print(json.dumps(row), flush=True)
            del sets, first
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
