"""Device time of the backward family's kernels (#8-#12) at the shapes the
ViT-1B train run gives them (tp 4, 520 rows, block 8, float32; the keep
counts of its straggler, as ``chip_smoke.py`` phase 6 times them), for an
A/B of two checkouts on one card. It calls only the public wrappers, so
the same file times any checkout of the port:

    PYTHONPATH=<checkout>/src python <this file>

Prints the card's name and power limit (nvidia-smi), then one JSON line
per case: the device time per call (the profiler's kernel time, inputs
rotated past the 50 MB L2) and the ``__global__`` functions the call
ran; the host time per call (50 calls enqueued without a synchronise);
and for #8 and #10 the device time of ``torch.matmul`` on the gathered
operands, the yardstick ``chip_smoke.py`` times with CUDA events. Needs
a CUDA device.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        print("grad_timing: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    M, D, ATT, FF, B = 520, 2048, 512, 2048, 8

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

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
        ms, names = 0.0, set()
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", 0.0)
            if us > 0:
                ms += us / 1e3
                name = re.search(r"(\w*kernel\w*)", e.key)
                names.add(name[1] if name else e.key[:40])
        return ms / iters, sorted(names)

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

    cases = []
    for wname, N, nb, kb in (("wq", ATT, D // B, 32), ("wo", D, ATT // B, 8)):
        keep = keep_of(nb, kb, 11 + kb)
        order = ops.inverse_order(keep, nb)
        K = nb * B
        cases.append(("pruned_matmul_dx", f"{wname} keep {kb}/{nb}",
                      lambda N=N, K=K, keep=keep: (
                          rnd(M, N), w := rnd(K, N, scale=0.02),
                          rows(w, keep).t()),
                      lambda s, o=order, k=kb: ops.pruned_matmul_dx(
                          s[0], s[1], o, kb=k, block=B)))
        cases.append(("pruned_matmul_dw", f"{wname} keep {kb}/{nb}",
                      lambda N=N, K=K: (rnd(M, K), rnd(M, N)),
                      lambda s, o=order, k=kb: ops.pruned_matmul_dw(
                          s[0], s[1], o, kb=k, block=B)))
    nb, kb = FF // B, 30
    keep = keep_of(nb, kb, 13)
    order = ops.inverse_order(keep, nb)
    C = kb * B
    ffn = [
        ("pruned_matmul_dx", "FFN dh compact",
         lambda: (rnd(M, D), w := rnd(FF, D, scale=0.02), rows(w, keep).t()),
         lambda s: ops.pruned_matmul_dx(s[0], s[1], keep, kb=kb, block=B,
                                        compact_out=True)),
        ("pruned_matmul_dw", "FFN dW_down x_compact",
         lambda: (rnd(M, C), rnd(M, D)),
         lambda s: ops.pruned_matmul_dw(s[0], s[1], order, kb=kb, block=B,
                                        x_compact=True)),
        ("outpruned_matmul", "FFN recompute",
         lambda: (rnd(M, D), w := rnd(D, FF, scale=0.02),
                  w.reshape(D, nb, B)[:, keep.long()].reshape(D, C)),
         lambda s: ops.outpruned_matmul(s[0], s[1], keep, block=B)),
        ("outpruned_matmul_dx", "FFN dx",
         lambda: (rnd(M, C), rnd(D, FF, scale=0.02)),
         lambda s: ops.outpruned_matmul_dx(s[0], s[1], keep, block=B)),
        ("outpruned_matmul_dw", "FFN dW_up",
         lambda: (rnd(M, D), rnd(M, C)),
         lambda s: ops.outpruned_matmul_dw(s[0], s[1], order, kb=kb,
                                           block=B)),
    ]
    for name, case, make, call in cases + ffn:
        first = make()
        n_sets = max(1, min(32, int(200e6 // sum(
            t.numel() * t.element_size() for t in first))))
        sets = [first] + [make() for _ in range(n_sets - 1)]
        ms, fns = device_ms(lambda i: call(sets[i]), n_sets)
        out = {"kernel": name, "case": case, "device_ms": ms,
               "functions": fns,
               "host_us": host_us(lambda i: call(sets[i]))}
        if len(first) == 3:        # the gathered operand: the yardstick
            out["library_device_ms"] = device_ms(
                lambda i: torch.matmul(sets[i][0], sets[i][2]), n_sets)[0]
        print(json.dumps(out), flush=True)
        del sets, first
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
