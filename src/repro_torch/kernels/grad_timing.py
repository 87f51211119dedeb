"""Device time of the backward family's kernels (#8-#12) at the shapes the
ViT-1B train run gives them (tp 4, 520 rows, block 8, float32 and
bfloat16; the keep counts of its straggler, as ``chip_smoke.py`` phase 6
times them), for an A/B of two checkouts on one card. It calls only the
public wrappers, so the same file times any checkout of the port:

    PYTHONPATH=<checkout>/src python <this file>
    PYTHONPATH=src python <this file> --sweep     # #9 and #12's splits

Prints the card's name and power limit (nvidia-smi), then one JSON line
per case: the device time per call (the profiler's kernel time, inputs
rotated past the 50 MB L2) and its share by ``__global__`` function; the
host time per call (50 calls enqueued without a synchronise); and the
device time of one ``torch.matmul`` on the gathered operands, the
yardstick ``chip_smoke.py`` times with CUDA events. ``--sweep``
times #9 and #12 instead at each split count of their contraction (the
wrapper's own choice replaced, then rounded to whole ranges of stages
as the wrapper does). Needs a CUDA device.
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
    sweep = "--sweep" in (sys.argv[1:] if argv is None else argv)
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
        """(kernel, case, make, call, library) at the train shapes; make
        returns a tuple of operands, the gathered ones last."""
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
        return out

    dw_partials = getattr(ops, "_dw_partials", None)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for name, case, make, call, library in cases(dtype):
            if sweep and not name.endswith("_dw"):
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
                print(json.dumps({
                    "kernel": name, "case": case, "dtype": dname,
                    "device_ms": ms, "functions": fns,
                    "host_us": host_us(lambda i: call(sets[i])),
                    "library_device_ms": device_ms(
                        lambda i: library(sets[i]), n_sets)[0]}),
                    flush=True)
            del sets, first
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
