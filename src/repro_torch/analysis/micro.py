"""Analyzer-owned micro step cases (port of ``repro.analysis.micro``): the
collective (R3) and kernel (R4) probes that belong to no one CLI driver.

``micro_collective`` runs the controlled row projection with
``psum_chunks`` in {1, 4} on an emulated group of 8, and the migrating
controlled FFN with one source (rank 5) and with two, and attaches the R3
expectations (chunk counts; one grouped migration broadcast).

``micro_kernel`` calls every kernel wrapper of ``kernels/ops.py`` at
small default shapes, in float32 and in bfloat16, so that on the card R4
prices every kernel function of all twelve kernels each run, not just
whichever ones a step happened to take.
On CPU tensors the wrappers run their plain versions and launch nothing.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis import registry as reg

_E, _B, _S, _D, _N, _BLOCK = 8, 2, 8, 128, 256, 8
_H = 256

#: the decode-attention probe of ``micro_kernel`` (the reference's
#: micro.py:118-123): q and K/V shapes and the positions, the last an
#: invalid lane. chip_smoke.py holds #7 against its plain version at
#: exactly these, since the analysis run is where #7's launches come from.
PROBE_Q = (4, 32, 1, 128)
PROBE_KV = (4, 8, 256, 128)
PROBE_CUR_POS = (0, 100, 255, 2 ** 30)


def proj_fn(chunks: int, device, group_cls=None):
    """The controlled row projection on an emulated group of 8 at
    ``psum_chunks=chunks`` (every rank at bucket 0), on ``group_cls``."""
    import numpy as np
    import torch

    from repro_torch.core.workload import PlanStatic
    from repro_torch.layers.tp_linear import ControlContext, controlled_proj
    from repro_torch.parallel import TPGroup

    st = PlanStatic(buckets=(0.0, 0.25, 0.5), block_size=_BLOCK, tp_size=_E)
    nb_loc = (_D // _E) // _BLOCK
    pri = torch.arange(nb_loc, dtype=torch.int32, device=device)[
        None].repeat(_E, 1)

    def fn(x, w):
        ctx = ControlContext(static=st, bucket_by_rank=np.zeros(_E, int),
                             pri={"proj": pri}, psum_chunks=chunks,
                             group=(group_cls or TPGroup)(_E))
        return controlled_proj(x, w, ctx, "proj", split="row")
    return fn


def _collective_cases(env: reg.CaseEnv) -> List[reg.TraceCase]:
    import numpy as np
    import torch

    from repro_torch.core.workload import PlanStatic
    from repro_torch.layers.tp_linear import ControlContext, controlled_ffn

    dev = torch.device(env.device)
    g = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev)

    e = _E

    x, w = rnd(_B, _S, _D), rnd(_D, _N)
    full, chunk4 = (_B, _S, _N), (_B, _S, _N // 4)
    cases = [
        reg.TraceCase(
            step="micro_collective", name="proj_psum_chunks1",
            fn=proj_fn(1, dev), args=(x, w),
            expect={"chunked_psum": {"chunks": 1, "full": full,
                                     "chunk": chunk4}}),
        reg.TraceCase(
            step="micro_collective", name="proj_psum_chunks4",
            fn=proj_fn(4, dev), args=(x, w),
            expect={"chunked_psum": {"chunks": 4, "full": full,
                                     "chunk": chunk4}}),
    ]

    # migration: SEMI sheds 2 blocks from rank 5 (and, in the second
    # case, 2 more from rank 2); the helpers' broadcast of every slot's
    # export must stay ONE grouped masked psum (R3)
    xh, wu, wd = rnd(_B, _S, 64), rnd(64, _H), rnd(_H, 64)
    nb_loc = (_H // e) // _BLOCK
    pri = torch.arange(nb_loc, dtype=torch.int32, device=dev)[None].repeat(
        e, 1)
    for name, sheds, srcs in (("ffn_migration_broadcast", (2,), (5,)),
                              ("ffn_migration_broadcast_2src", (2, 2),
                               (5, 2))):
        st = PlanStatic(buckets=(0.0, 0.25, 0.5), block_size=_BLOCK,
                        mig_shed=sheds, tp_size=e)

        def fn(x_, wu_, wd_, st=st, srcs=srcs):
            ctx = ControlContext(static=st, bucket_by_rank=np.zeros(e, int),
                                 pri={"ffn": pri}, mig_src=srcs)
            return controlled_ffn(x_, wu_, wd_, ctx, "ffn",
                                  torch.nn.functional.silu)
        cases.append(reg.TraceCase(
            step="micro_collective", name=name, fn=fn, args=(xh, wu, wd),
            expect={"grouped_bcast": {"count": 1}}))
    return cases


def _kernel_cases(env: reg.CaseEnv) -> List[reg.TraceCase]:
    import torch

    from repro_torch.kernels import ops

    dev = torch.device(env.device)
    g = torch.Generator(device="cpu").manual_seed(1)

    def ids(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    cur = ids(*PROBE_CUR_POS)
    # a pool of 32 pages of 16 rows; each slot's 16 table entries in order
    pages = torch.arange(64, dtype=torch.int32, device=dev).reshape(
        4, 16) % 32
    keep4 = ids(0, 2, 5, 7)
    order8 = ops.inverse_order(keep4, 8)
    cases = []
    # float32 and bfloat16: each dtype is a kernel function of its own
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=g) * scale).to(dev, dtype)

        def case(name, fn, *args):
            cases.append(reg.TraceCase(step="micro_kernel", name=name + sfx,
                                       fn=fn, args=args))

        q, kv = rnd(*PROBE_Q), rnd(*PROBE_KV)
        pools = rnd(32, 8, 16, 128)
        qa, qr = rnd(4, 16, 512), rnd(4, 16, 64)
        lat, rope = rnd(4, 256, 512), rnd(4, 256, 64)
        lpool, rpool = rnd(32, 16, 512), rnd(32, 16, 64)
        case("block_pruned_matmul_default_tiles",
             lambda x, w, k: ops.block_pruned_matmul(x, w, k),
             rnd(512, 1024), rnd(1024, 1024, scale=0.03), keep4)
        # 8 rows (the serving slots): #2's decode kernel
        case("block_pruned_matmul_decode",
             lambda x, w, k: ops.block_pruned_matmul(x, w, k),
             rnd(8, 1024), rnd(1024, 1024, scale=0.03), keep4)
        case("fused_pruned_ffn_default_tiles",
             lambda x, wu, wd, k: ops.fused_pruned_ffn(
                 x, wu, wd, k, None, ops.silu),
             rnd(256, 512), rnd(512, 1024, scale=0.04),
             rnd(1024, 512, scale=0.03), ids(1, 6))
        case("fused_decode_attention",
             lambda q_, k, v, p: ops.fused_decode_attention(
                 q_, k, v, cur_pos=p), q, kv, kv, cur)
        case("unfused_decode_attention",
             lambda q_, k, v, p: ops.unfused_decode_attention(
                 q_, k, v, cur_pos=p), q, kv, kv, cur)
        case("fused_paged_decode_attention",
             lambda q_, k, v, pg, p: ops.fused_paged_decode_attention(
                 q_, k, v, pages=pg, cur_pos=p), q, pools, pools, pages,
             cur)
        case("fused_mla_decode_attention",
             lambda a, r, la, ro, p: ops.fused_mla_decode_attention(
                 a, r, la, ro, cur_pos=p, head_dim_for_scale=192),
             qa, qr, lat, rope, cur)
        case("fused_paged_mla_decode_attention",
             lambda a, r, la, ro, pg, p:
             ops.fused_paged_mla_decode_attention(
                 a, r, la, ro, pages=pg, cur_pos=p, head_dim_for_scale=192),
             qa, qr, lpool, rpool, pages, cur)
        case("pruned_matmul_dx",
             lambda dy, w, o: ops.pruned_matmul_dx(dy, w, o, kb=4, block=128),
             rnd(256, 512), rnd(1024, 512), order8)
        case("pruned_matmul_dw",
             lambda x, dy, o: ops.pruned_matmul_dw(x, dy, o, kb=4, block=128),
             rnd(256, 1024), rnd(256, 512), order8)
        case("outpruned_matmul",
             lambda x, w, k: ops.outpruned_matmul(x, w, k, block=128),
             rnd(256, 512), rnd(512, 1024), keep4)
        case("outpruned_matmul_dx",
             lambda dyc, w, k: ops.outpruned_matmul_dx(dyc, w, k, block=128),
             rnd(256, 512), rnd(512, 1024), keep4)
        case("outpruned_matmul_dw",
             lambda x, dyc, o: ops.outpruned_matmul_dw(x, dyc, o, kb=4,
                                                       block=128),
             rnd(256, 512), rnd(256, 512), order8)
    return cases


reg.register("micro_collective", _collective_cases)
reg.register("micro_kernel", _kernel_cases)
