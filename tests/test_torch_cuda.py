"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests carry the ``cuda`` marker and skip without a CUDA device: the
kernels have no CPU mode. The file imports neither ``jax`` nor ``repro``,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 max |err| <= 1e-4 * max |ref| (the kernels and the
plain versions both accumulate in f32; only the summation order
differs); bfloat16 max |err| <= 2e-2 * max |ref| (the output, and the
FFN's hidden, are rounded to bf16 once).
"""
import pytest
import torch

from repro_torch.kernels import ops as tops

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, dtype):
    got, ref = got.float().cpu(), ref.float().cpu()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [8, 128])
def test_cuda_kernels_match_plain(cuda_device, dtype, block):
    g = torch.Generator(device=cuda_device).manual_seed(block)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda_device)
                * scale).to(dtype)

    tops.reset_launch_counts()
    K, N, H = 4 * block, 96, 8 * block
    x, w = rnd(8, K), rnd(K, N)
    keep = torch.tensor([0, 2, 3], dtype=torch.int32, device=cuda_device)
    _close(tops.block_pruned_matmul(x, w, keep, block=block),
           tops.block_pruned_matmul_plain(x, w, keep, block), dtype)
    w_up, w_gate, w_down = rnd(K, H, scale=0.1), rnd(K, H, scale=0.1), \
        rnd(H, N, scale=0.1)
    keep_h = torch.tensor([1, 4, 6], dtype=torch.int32, device=cuda_device)
    for gate, act in ((w_gate, tops.silu), (None, tops.gelu)):
        _close(tops.fused_pruned_ffn(x, w_up, w_down, keep_h, gate, act,
                                     block),
               tops.fused_pruned_ffn_plain(x, w_up, w_down, keep_h, gate,
                                           act, block), dtype)
    q, k, v = rnd(4, 8, 1, 64), rnd(4, 2, 200, 64), rnd(4, 2, 200, 64)
    cur = torch.tensor([0, 31, 199, 2 ** 30], dtype=torch.int32,
                       device=cuda_device)
    for window in (0, 40):
        _close(tops.fused_decode_attention(q, k, v, cur_pos=cur,
                                           window=window),
               tops.gqa_decode_attn_plain(q, k, v, cur, window), dtype)
    torch.cuda.synchronize()
    # the FFN's down product runs the block-pruned kernel without counting
    # as a call of the block-pruned wrapper
    counts = tops.launch_counts()
    assert {k: counts[k] for k in ("block_pruned_matmul", "fused_pruned_ffn",
                                   "fused_decode_attention")} == {
        "block_pruned_matmul": 1, "fused_pruned_ffn": 2,
        "fused_decode_attention": 2}
    # no backward ran: the backward kernels did not launch
    assert sum(counts.values()) == 5


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    """A CUDA tensor the kernels do not take raises; nothing quietly runs
    the plain version instead."""
    tops.reset_launch_counts()
    x = torch.ones((4, 64), dtype=torch.float16, device=cuda_device)
    keep = torch.tensor([0, 3], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tops.block_pruned_matmul(x, x.t().contiguous(), keep, block=8)
    xf = x.float()
    with pytest.raises(ValueError, match="lies on"):
        tops.block_pruned_matmul(xf, xf.t().contiguous(), keep.cpu(), block=8)
    w_up = torch.ones((64, 32), device=cuda_device)
    w_down = torch.ones((32, 64), device=cuda_device)
    with pytest.raises(ValueError, match="no kernel code"):
        tops.fused_pruned_ffn(xf, w_up, w_down, keep, None, torch.relu, 8)
    assert set(tops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the backward family (#8-#12) and a controlled training step
# ---------------------------------------------------------------------------


def _nan(shape, dtype, device):
    return torch.full(shape, float("nan"), dtype=dtype, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [8, 128])
def test_cuda_grad_kernels_match_plain(cuda_device, dtype, block):
    """Every output element is written by the kernel: the outputs start
    as NaN, so a skipped (pruned) element would show. The keep list is
    unsorted, which pins compact slot k to block keep[k]."""
    g = torch.Generator(device=cuda_device).manual_seed(block + 1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    tops.reset_launch_counts()
    nb, M, N = 6, 70, 96                    # M, N off the 64-wide tiles
    keep = torch.tensor([4, 0, 3], dtype=torch.int32, device=cuda_device)
    kb = keep.shape[0]
    order = tops.inverse_order(keep, nb)
    K = nb * block
    dy, w = rnd(M, N), rnd(K, N)
    x, xc = rnd(M, K), rnd(M, kb * block)
    wo, dyc = rnd(N, K), rnd(M, kb * block)
    cases = [
        ("dx", lambda out: tops.pruned_matmul_dx(dy, w, order, kb=kb,
                                                  block=block, out=out),
         tops.pruned_matmul_dx_plain(dy, w, order, kb, block), (M, K)),
        ("dx compact", lambda out: tops.pruned_matmul_dx(
            dy, w, keep, kb=kb, block=block, compact_out=True, out=out),
         tops.pruned_matmul_dx_plain(dy, w, keep, kb, block, True),
         (M, kb * block)),
        ("dw", lambda out: tops.pruned_matmul_dw(x, dy, order, kb=kb,
                                                  block=block, out=out),
         tops.pruned_matmul_dw_plain(x, dy, order, kb, block), (K, N)),
        ("dw x_compact", lambda out: tops.pruned_matmul_dw(
            xc, dy, order, kb=kb, block=block, x_compact=True, out=out),
         tops.pruned_matmul_dw_plain(xc, dy, order, kb, block, True),
         (K, N)),
        ("outpruned", lambda out: tops.outpruned_matmul(
            dy, wo, keep, block=block, out=out),
         tops.outpruned_matmul_plain(dy, wo, keep, block), (M, kb * block)),
        ("outpruned dx", lambda out: tops.outpruned_matmul_dx(
            dyc, wo, keep, block=block, out=out),
         tops.outpruned_matmul_dx_plain(dyc, wo, keep, block), (M, N)),
        ("outpruned dw", lambda out: tops.outpruned_matmul_dw(
            dy, dyc, order, kb=kb, block=block, out=out),
         tops.outpruned_matmul_dw_plain(dy, dyc, order, kb, block), (N, K)),
    ]
    for name, run, ref, shape in cases:
        out = _nan(shape, dtype, cuda_device)
        got = run(out)
        torch.cuda.synchronize()
        assert got.data_ptr() == out.data_ptr(), name
        assert bool(torch.isfinite(got.float()).all()), name
        _close(got, ref, dtype)
    counts = tops.launch_counts()
    assert counts["pruned_matmul_dx"] == 2
    assert counts["pruned_matmul_dw"] == 2
    assert counts["outpruned_matmul"] == 1
    assert counts["outpruned_matmul_dx"] == 1
    assert counts["outpruned_matmul_dw"] == 1


@pytest.mark.cuda
def test_cuda_controlled_train_step_kernel_vs_plain(cuda_device):
    """One controlled step of ViT smoke at tp=4 (a resized straggler that
    also migrates, a second resized rank): the kernel path's loss and
    every parameter gradient against the plain path's, f32, max |err| <=
    1e-4 * max |ref| per parameter; every kernel of the path launched."""
    import dataclasses

    import numpy as np

    from repro_torch.config import get_config, smoke_variant
    from repro_torch.control import scopes as scopes_lib
    from repro_torch.core.workload import PlanStatic
    from repro_torch.data.pipeline import PatternImageStream, patchify
    from repro_torch.layers.tp_linear import ControlContext
    from repro_torch.models import vit

    cfg = smoke_variant(get_config("vit-1b"))
    st = PlanStatic(block_size=8, tp_size=4, mig_shed=(2,))
    st = dataclasses.replace(
        st, scope_blocks=scopes_lib.scope_block_table(cfg, st))
    scopes = scopes_lib.control_scopes(cfg, st)
    rng = np.random.default_rng(1)
    pri = scopes_lib.plan_pri_arrays(
        scopes, {n: rng.permutation(nb * (1 if scopes_lib.SCOPE_LAYOUT[n]
                                          == "col" else 4))
                 for n, nb in scopes.items()}, 4, device=cuda_device)
    img = next(iter(PatternImageStream(batch_size=8, seed=2)))
    batch = {"patches": torch.from_numpy(patchify(img["images"])).to(
                 cuda_device),
             "labels": torch.from_numpy(img["labels"]).to(cuda_device)}
    out = {}
    for use_kernel in (True, False):
        model = vit.init(torch.Generator(device=cuda_device).manual_seed(0),
                         cfg, torch.float32, cuda_device)
        ctx = ControlContext(static=st, bucket_by_rank=[5, 0, 2, 0],
                             pri=pri, use_kernel=use_kernel, mig_src=[0])
        tops.reset_launch_counts()
        loss, _ = vit.loss_fn(model, cfg, batch, ctx=ctx)
        loss.backward()
        torch.cuda.synchronize()
        out[use_kernel] = (float(loss.detach()), {n: p.grad.float().cpu() for n, p
                                         in model.named_parameters()},
                           tops.launch_counts())
    (lk, gk, counts), (lp, gp, plain_counts) = out[True], out[False]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for n, ref in gp.items():
        assert float((gk[n] - ref).abs().max()) <= \
            1e-4 * float(ref.abs().max()), n
    for name in ("block_pruned_matmul", "fused_pruned_ffn",
                 "pruned_matmul_dx", "pruned_matmul_dw", "outpruned_matmul",
                 "outpruned_matmul_dx", "outpruned_matmul_dw"):
        assert counts[name] > 0, name
    assert set(plain_counts.values()) == {0}


# ---------------------------------------------------------------------------
# the paged and MLA decode attentions (#4-#6)
# ---------------------------------------------------------------------------


def _paged_case(g, device, cur, ps, pps, num_pages):
    """A shuffled page table holding each slot's pages up to its cur_pos
    (two trailing -1 entries for a lane past the table), and the mask of
    the pool pages no table references."""
    perm = torch.randperm(num_pages, generator=torch.Generator().manual_seed(
        num_pages))
    table = torch.full((len(cur), pps), -1, dtype=torch.int32)
    used = 0
    for b, c in enumerate(cur):
        n = pps - 2 if c >= pps * ps else c // ps + 1
        table[b, :n] = perm[used:used + n]
        used += n
    unref = torch.ones(num_pages, dtype=torch.bool)
    unref[table[table >= 0].long()] = False
    return table.to(device), unref.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_and_mla_kernels_match_plain(cuda_device, dtype):
    """Every pool page no table references is NaN, so a kernel that read
    one would show it; ragged positions, one lane at 2**30, a shuffled
    page order and trailing -1 entries."""
    g = torch.Generator(device=cuda_device).manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    tops.reset_launch_counts()
    cur_l = [0, 21, 2 ** 30, 70]
    cur = torch.tensor(cur_l, dtype=torch.int32, device=cuda_device)
    ps, pps, num_pages = 8, 12, 40
    pages, unref = _paged_case(g, cuda_device, cur_l, ps, pps, num_pages)
    q = rnd(4, 6, 1, 32)
    k_pool, v_pool = rnd(num_pages, 2, ps, 32), rnd(num_pages, 2, ps, 32)
    k_pool[unref] = float("nan")
    v_pool[unref] = float("nan")
    for window in (0, 9):
        got = tops.fused_paged_decode_attention(
            q, k_pool, v_pool, pages=pages, cur_pos=cur, window=window)
        assert bool(torch.isfinite(got.float()).all())
        _close(got, tops.gqa_paged_decode_attn_plain(
            q, k_pool, v_pool, pages, cur, window), dtype)
    qa, qr = rnd(4, 5, 64), rnd(4, 5, 16)
    lat, rope = rnd(4, 96, 64), rnd(4, 96, 16)
    _close(tops.fused_mla_decode_attention(qa, qr, lat, rope, cur_pos=cur,
                                           head_dim_for_scale=24),
           tops.mla_decode_attn_plain(qa, qr, lat, rope, cur, 24), dtype)
    lat_p, rope_p = rnd(num_pages, ps, 64), rnd(num_pages, ps, 16)
    lat_p[unref] = float("nan")
    rope_p[unref] = float("nan")
    got = tops.fused_paged_mla_decode_attention(
        qa, qr, lat_p, rope_p, pages=pages, cur_pos=cur,
        head_dim_for_scale=24)
    assert got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    _close(got, tops.mla_paged_decode_attn_plain(qa, qr, lat_p, rope_p,
                                                 pages, cur, 24), dtype)
    torch.cuda.synchronize()
    counts = tops.launch_counts()
    assert (counts["fused_paged_decode_attention"],
            counts["fused_mla_decode_attention"],
            counts["fused_paged_mla_decode_attention"]) == (2, 1, 1)


@pytest.mark.cuda
def test_cuda_paged_options_raise_instead_of_falling_back(cuda_device):
    """A page size that is not a multiple of 8 with the fused switch
    raises — at the engine and at the wrappers — and so do a pool whose
    rows are wider than q's and float16 operands; no kernel launches."""
    from repro_torch.control import ControlConfig
    from repro_torch.launch.serve import ServeEngine

    tops.reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of 8"):
        ServeEngine("yi-6b", num_slots=2, max_len=16, page_size=4,
                    control=ControlConfig(fused_attention=True),
                    device="cuda")
    q = torch.ones((2, 4, 1, 8), device=cuda_device)
    pool = torch.ones((4, 2, 4, 8), device=cuda_device)
    pages = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    cur = torch.zeros((2,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        tops.fused_paged_decode_attention(q, pool, pool, pages=pages,
                                          cur_pos=cur)
    wide = torch.ones((4, 2, 8, 16), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tops.fused_paged_decode_attention(q, wide, wide, pages=pages,
                                          cur_pos=cur)
    lat = torch.ones((4, 4, 16), device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        tops.fused_paged_mla_decode_attention(
            torch.ones((2, 3, 16), device=cuda_device),
            torch.ones((2, 3, 4), device=cuda_device), lat, lat[..., :4],
            pages=pages, cur_pos=cur, head_dim_for_scale=12)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tops.fused_mla_decode_attention(
            torch.ones((2, 3, 16), dtype=torch.float16, device=cuda_device),
            torch.ones((2, 3, 4), dtype=torch.float16, device=cuda_device),
            torch.ones((2, 8, 16), dtype=torch.float16, device=cuda_device),
            torch.ones((2, 8, 4), dtype=torch.float16, device=cuda_device),
            cur_pos=cur, head_dim_for_scale=12)
    assert set(tops.launch_counts().values()) == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_unfused_decode_attention_matches_plain(cuda_device, dtype):
    """#7 at ragged S and head dims (no padding anywhere), ragged
    positions with the engine's invalid lane and an all-masked lane, a
    window, into a NaN-filled output."""
    g = torch.Generator(device=cuda_device).manual_seed(11)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    tops.reset_launch_counts()
    q, k, v = rnd(5, 6, 1, 40), rnd(5, 2, 203, 40), rnd(5, 2, 203, 40)
    cur = torch.tensor([0, 77, 2 ** 30, 202, -1], dtype=torch.int32,
                       device=cuda_device)
    for window in (0, 50):
        out = torch.full((5, 6, 1, 40), float("nan"), dtype=dtype,
                         device=cuda_device)
        got = tops.unfused_decode_attention(q, k, v, cur_pos=cur,
                                            window=window, out=out)
        assert got.data_ptr() == out.data_ptr()
        assert bool(torch.isfinite(got.float()).all())
        _close(got, tops.unfused_gqa_decode_attn_plain(q, k, v, cur, window),
               dtype)
    torch.cuda.synchronize()
    assert tops.launch_counts()["unfused_decode_attention"] == 2


@pytest.mark.cuda
def test_cuda_launch_configs_fit_and_are_priced(cuda_device):
    """R4 on the real build: every kernel function of the ptxas log is
    found, and the launches of all twelve wrappers at the analyzer's
    probe shapes fit the card's budget; #5 at a 4096-wide latent does
    not, and is named before any launch."""
    from repro_torch.analysis import engine, registry, smem
    from repro_torch.kernels import build

    res = smem.kernel_resources()
    assert len(res) >= 20 and all(r.registers > 0 for r in res.values())
    launches = []
    prev = tops.set_launch_hook(lambda name, ls: launches.append((name, ls)))
    try:
        env = registry.CaseEnv(device="cuda")
        import repro_torch.analysis.micro  # noqa: F401
        for case in registry.provider("micro_kernel")(env):
            engine.run_once(case.fn, case.args, "cuda")
    finally:
        tops.set_launch_hook(prev)
    assert {name for name, _ in launches} == {
        w.__name__ for w in tops.KERNEL_WRAPPERS}
    flat = [ln for _, ls in launches for ln in ls]
    assert smem.check_budget(flat, res, smem.device_budget()) == []
    big = build.launch_config("repro_mla_decode_attn", 8, 16, 4096, 64, 32,
                              0, 0)
    with pytest.raises(smem.SmemBudgetError, match="mla_partial_kernel"):
        smem.assert_fits(big)


@pytest.mark.cuda
def test_cuda_analysis_check_and_mutate(cuda_device, capsys):
    """The gate on the card: the whole matrix clean, every mutant firing."""
    from repro_torch.analysis.__main__ import main
    assert main(["--check", "--mutate"]) == 0, capsys.readouterr().out


# ---------------------------------------------------------------------------
# #10 and #8 on the tensor-core core (split contraction, cp.async ring,
# mma.sync): ragged edges, block 8 and 128, sorted and unsorted keep
# lists, operands that take the element-wise loads, determinism
# ---------------------------------------------------------------------------

# name: (M, contraction, nb, kb, block, sorted keep, base offset in
# elements). The contraction is K for #10 and N for #8.
_TC_CASES = {
    "train_ffn_b8": (520, 2048, 256, 30, 8, True, 0),
    "ragged_b128_unsorted": (70, 96, 6, 3, 128, False, 0),
    "ragged_b8_unsorted": (130, 200, 24, 7, 8, False, 0),
    # a contraction of 97: rows are not 16-byte multiples
    "odd_contraction": (65, 97, 10, 4, 8, False, 0),
    # block 6: #10's gathered columns are not whole 16-byte copies
    "block6": (40, 64, 12, 5, 6, False, 0),
    # operands one element past a 16-byte boundary
    "unaligned_base": (33, 128, 8, 3, 8, False, 1),
    # one kept block, a long contraction: the splits outnumber the blocks
    "splits_exceed_kept": (16, 2048, 64, 1, 8, True, 0),
}


def _tc_operand(g, shape, dtype, device, offset, scale=1.0):
    """A contiguous operand whose data starts ``offset`` elements into
    its storage."""
    n = shape[0] * shape[1]
    flat = torch.from_numpy(
        (g.standard_normal(n + offset) * scale).astype("float32"))
    return flat.to(device=device, dtype=dtype)[offset:].view(shape)


def _tc_keep(case, device):
    import numpy as np
    _, _, nb, kb, _, is_sorted, _ = _TC_CASES[case]
    keep = np.random.default_rng(sum(map(ord, case))).permutation(nb)[:kb]
    if is_sorted:
        keep = np.sort(keep)
    return torch.tensor(keep, dtype=torch.int32, device=device)


def _tc_check(run, ref, shape, dtype, device, wrapper):
    """Two calls into NaN-filled outputs: each writes every element within
    the tolerance, the two are bit-identical, and each moves the
    wrapper's count by exactly one."""
    got = []
    for _ in range(2):
        before = wrapper.launches
        out = _nan(shape, dtype, device)
        y = run(out)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert y.data_ptr() == out.data_ptr()
        assert bool(torch.isfinite(y.float()).all())
        _close(y, ref, dtype)
        got.append(y.clone())
    assert torch.equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_TC_CASES))
def test_cuda_tc_outpruned_matmul_matches_plain(cuda_device, dtype, case):
    import numpy as np
    M, K, nb, kb, block, _, off = _TC_CASES[case]
    g = np.random.default_rng(len(case))
    x = _tc_operand(g, (M, K), dtype, cuda_device, off)
    w = _tc_operand(g, (K, nb * block), dtype, cuda_device, off, 0.05)
    keep = _tc_keep(case, cuda_device)
    _tc_check(lambda out: tops.outpruned_matmul(x, w, keep, block=block,
                                                out=out),
              tops.outpruned_matmul_plain(x, w, keep, block),
              (M, kb * block), dtype, cuda_device, tops.outpruned_matmul)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compact_out", [False, True])
@pytest.mark.parametrize("case", sorted(_TC_CASES))
def test_cuda_tc_pruned_matmul_dx_matches_plain(cuda_device, dtype,
                                                compact_out, case):
    import numpy as np
    M, N, nb, kb, block, _, off = _TC_CASES[case]
    g = np.random.default_rng(len(case) + 1)
    dy = _tc_operand(g, (M, N), dtype, cuda_device, off)
    w = _tc_operand(g, (nb * block, N), dtype, cuda_device, off, 0.05)
    keep = _tc_keep(case, cuda_device)
    idx = keep if compact_out else tops.inverse_order(keep, nb)
    _tc_check(lambda out: tops.pruned_matmul_dx(
        dy, w, idx, kb=kb, block=block, compact_out=compact_out, out=out),
        tops.pruned_matmul_dx_plain(dy, w, idx, kb, block, compact_out),
        (M, (kb if compact_out else nb) * block), dtype, cuda_device,
        tops.pruned_matmul_dx)


@pytest.mark.cuda
def test_cuda_tc_launch_configs_split_and_sum(cuda_device):
    """#10 and #8 report both launches, the split products on the
    tensor-core core and the ordered sum (the scatter pass where #8's
    output is not compact); #11's one range is written by the epilogue of
    the tensor-core core."""
    from repro_torch.kernels import build

    launches = []
    prev = tops.set_launch_hook(lambda name, ls: launches.append((name, ls)))
    try:
        keep = torch.tensor([5, 1, 3], dtype=torch.int32, device=cuda_device)
        order = tops.inverse_order(keep, 8)
        x, w = torch.randn(520, 256, device=cuda_device), \
            torch.randn(256, 64, device=cuda_device)
        tops.outpruned_matmul(x, w, keep, block=8)
        tops.pruned_matmul_dx(x, torch.randn(64, 256, device=cuda_device),
                              order, kb=3, block=8)
        tops.outpruned_matmul_dx(torch.randn(520, 24, device=cuda_device),
                                 w, keep, block=8)
    finally:
        tops.set_launch_hook(prev)
    fns = {name: [ln.fn for ln in ls] for name, ls in launches}
    assert fns == {
        "outpruned_matmul": ["pruned_gemm_tc_kernel<OpPolicy,float>",
                             "reduce_splits_kernel<float>"],
        "pruned_matmul_dx": ["pruned_gemm_tc_kernel<DxPolicy,float>",
                             "reduce_splits_scatter_kernel<DxPolicy,float>"],
        "outpruned_matmul_dx": ["pruned_gemm_tc_kernel<OpDxPolicy,float>"]}
    (split, _), = [ls for name, ls in launches if name == "outpruned_matmul"]
    assert split.grid[:2] == (1, 9) and split.grid[2] > 1
    assert split.smem > 48 * 1024
    res = build.launch_config("repro_pruned_matmul_dx", 520, 256, 8, 3, 8, 1,
                              4, 1)
    assert [ln.fn for ln in res] == [
        "pruned_gemm_tc_kernel<DxPolicy,__nv_bfloat16>",
        "reduce_splits_kernel<__nv_bfloat16>"]


# ---------------------------------------------------------------------------
# #9 and #12 on the tensor-core core (A read along its rows: x
# transposed): ragged M, odd widths, block 6, 8 and 128, x_compact,
# unsorted keep lists, unaligned bases, one range and more ranges asked for
# than stages, determinism, launch names
# ---------------------------------------------------------------------------

# name: (M, width, nb, kb, block, sorted keep, base offset in elements,
# split count asked for, None for the wrapper's). The width is N (dy's
# columns) for #9 and K (x's columns) for #12.
_DW_CASES = {
    "train_b8": (520, 512, 256, 32, 8, True, 0, None),
    "m70_b128_unsorted": (70, 96, 6, 3, 128, False, 0, None),
    # odd widths: no operand row or output row is a 16-byte multiple
    "m70_b8_odd_width": (70, 97, 24, 7, 8, False, 0, None),
    # block 6: a mapped column block is not whole 16-byte copies
    "block6": (40, 64, 12, 5, 6, False, 0, None),
    "unaligned_base": (33, 128, 8, 3, 8, False, 1, None),
    # 3 stages asked for 40 ranges: one range per stage
    "splits_exceed_stages": (70, 64, 16, 4, 8, True, 0, 40),
    "unsplit": (70, 64, 16, 4, 8, False, 0, 1),
    # 17 stages in 9 ranges
    "nine_ranges": (520, 64, 16, 4, 8, False, 0, 16),
}


def _dw_keep(case, device):
    import numpy as np
    _, _, nb, kb, _, is_sorted, _, _ = _DW_CASES[case]
    keep = np.random.default_rng(sum(map(ord, case))).permutation(nb)[:kb]
    if is_sorted:
        keep = np.sort(keep)
    return torch.tensor(keep, dtype=torch.int32, device=device)


def _dw_run(monkeypatch, case, policy, dtype, run, ref, shape, device,
            wrapper):
    """``_tc_check`` under the case's split count, with the launch names:
    the tensor-core product (its grid.z the ranges of whole stages), then
    the ordered scatter of the splits' sums."""
    splits = _DW_CASES[case][-1]
    if splits is not None:
        real = tops._dw_partials
        monkeypatch.setattr(tops, "_dw_partials",
                            lambda r, c, d, dv: real(r, c, d, dv,
                                                     splits=splits))
    launches = []
    prev = tops.set_launch_hook(lambda name, ls: launches.append(ls))
    try:
        _tc_check(run, ref, shape, dtype, device, wrapper)
    finally:
        tops.set_launch_hook(prev)
    t = "float" if dtype == torch.float32 else "__nv_bfloat16"
    assert len(launches) == 2
    for ls in launches:
        assert [ln.fn for ln in ls] == [
            f"pruned_gemm_tc_kernel<{policy},{t}>",
            f"reduce_splits_scatter_kernel<{policy},{t}>"]
        if splits is not None:
            stages = -(-_DW_CASES[case][0] // tops.TC_DEPTH)
            per = -(-stages // min(splits, stages))
            assert ls[0].grid[2] == -(-stages // per)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_compact", [False, True])
@pytest.mark.parametrize("case", sorted(_DW_CASES))
def test_cuda_tc_pruned_matmul_dw_matches_plain(cuda_device, monkeypatch,
                                                dtype, x_compact, case):
    import numpy as np
    M, N, nb, kb, block, _, off, _ = _DW_CASES[case]
    g = np.random.default_rng(len(case) + 2)
    x = _tc_operand(g, (M, (kb if x_compact else nb) * block), dtype,
                    cuda_device, off)
    dy = _tc_operand(g, (M, N), dtype, cuda_device, off, 0.05)
    order = tops.inverse_order(_dw_keep(case, cuda_device), nb)
    _dw_run(monkeypatch, case, "DwPolicy", dtype,
            lambda out: tops.pruned_matmul_dw(
                x, dy, order, kb=kb, block=block, x_compact=x_compact,
                out=out),
            tops.pruned_matmul_dw_plain(x, dy, order, kb, block, x_compact),
            (nb * block, N), cuda_device, tops.pruned_matmul_dw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_DW_CASES))
def test_cuda_tc_outpruned_matmul_dw_matches_plain(cuda_device, monkeypatch,
                                                   dtype, case):
    import numpy as np
    M, K, nb, kb, block, _, off, _ = _DW_CASES[case]
    g = np.random.default_rng(len(case) + 3)
    x = _tc_operand(g, (M, K), dtype, cuda_device, off)
    dyc = _tc_operand(g, (M, kb * block), dtype, cuda_device, off, 0.05)
    order = tops.inverse_order(_dw_keep(case, cuda_device), nb)
    _dw_run(monkeypatch, case, "OpDwPolicy", dtype,
            lambda out: tops.outpruned_matmul_dw(x, dyc, order, kb=kb,
                                                 block=block, out=out),
            tops.outpruned_matmul_dw_plain(x, dyc, order, kb, block),
            (K, nb * block), cuda_device, tops.outpruned_matmul_dw)


@pytest.mark.cuda
def test_cuda_tc_dw_launch_configs(cuda_device):
    """#9 and #12 report the tensor-core product, whose extra blocks
    write the zeros (#9's pruned rows along y, #12's pruned columns along
    x), and the ordered scatter of the splits' sums."""
    from repro_torch.kernels import build

    # #9 at wq's shape: 4 x 8 kept tiles, 28 zero-row chunks per column
    dw = build.launch_config("repro_pruned_matmul_dw", 520, 512, 256, 32, 8,
                             0, 4, 0)
    assert [ln.fn for ln in dw] == [
        "pruned_gemm_tc_kernel<DwPolicy,float>",
        "reduce_splits_scatter_kernel<DwPolicy,float>"]
    assert dw[0].grid == (8, 4 + 7, 4)
    assert dw[0].smem > 48 * 1024
    assert dw[1].grid[0] * dw[1].threads >= 256 * 512
    # #12 at the FFN's shape: 32 x 4 kept tiles, 29 zero-column chunks
    op = build.launch_config("repro_outpruned_matmul_dw", 520, 2048, 256, 30,
                             8, 3, 1)
    assert [ln.fn for ln in op] == [
        "pruned_gemm_tc_kernel<OpDwPolicy,__nv_bfloat16>",
        "reduce_splits_scatter_kernel<OpDwPolicy,__nv_bfloat16>"]
    assert op[0].grid == (4 + 10, 32, 3)
    # 40 ranges asked of 3 stages: one range per stage
    many = build.launch_config("repro_outpruned_matmul_dw", 70, 64, 16, 4, 6,
                               40, 0)
    assert many[0].grid == (1 + 1, 1, 3)


# ---------------------------------------------------------------------------
# #11 on the tensor-core core (its contraction read through the keep map)
# and #2: the decode kernel up to BPM_DECODE_MAX_ROWS rows, the
# tensor-core core above. M across the route, block 6 (copies that cross
# a block), 8 and 128, odd widths, unaligned bases, unsorted keep lists,
# x_compact, one range and many; outputs NaN-filled, a second call
# bit-identical, launch names and counts
# ---------------------------------------------------------------------------

# name: (M, width, nb, kb, block, sorted keep, base offset in elements).
# The width is K (dx's columns) for #11 and N (y's columns) for #2.
_MAP_CASES = {
    "m1_b128": (1, 512, 8, 5, 128, True, 0),
    "m1_one_range": (1, 512, 8, 1, 128, True, 0),
    "m7_b8_unsorted": (7, 96, 24, 7, 8, False, 0),
    "m8_b128_unsorted": (8, 576, 6, 4, 128, False, 0),
    "m8_odd_width_b6": (8, 97, 12, 5, 6, False, 0),
    "m8_unaligned": (8, 128, 8, 3, 8, False, 1),
    "m9_b8": (9, 64, 16, 9, 8, True, 0),
    "m16_b128_unsorted": (16, 256, 4, 3, 128, False, 0),
    "m33_unaligned": (33, 128, 8, 3, 8, False, 1),
    "m64_b6": (64, 64, 12, 5, 6, False, 0),
    "m65_odd_width": (65, 97, 10, 4, 8, False, 0),
    "m520_train_b8": (520, 512, 256, 32, 8, True, 0),
    "m520_one_range": (520, 2048, 256, 30, 8, True, 0),
}


def _map_keep(case, device):
    import numpy as np
    _, _, nb, kb, _, is_sorted, _ = _MAP_CASES[case]
    keep = np.random.default_rng(sum(map(ord, case))).permutation(nb)[:kb]
    if is_sorted:
        keep = np.sort(keep)
    return torch.tensor(keep, dtype=torch.int32, device=device)


def _tname(dtype):
    return "float" if dtype == torch.float32 else "__nv_bfloat16"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_MAP_CASES))
def test_cuda_tc_outpruned_matmul_dx_matches_plain(cuda_device, dtype, case):
    import numpy as np
    M, K, nb, kb, block, _, off = _MAP_CASES[case]
    g = np.random.default_rng(len(case) + 4)
    dyc = _tc_operand(g, (M, kb * block), dtype, cuda_device, off)
    w = _tc_operand(g, (K, nb * block), dtype, cuda_device, off, 0.05)
    keep = _map_keep(case, cuda_device)
    launches = []
    prev = tops.set_launch_hook(lambda name, ls: launches.append(ls))
    try:
        _tc_check(lambda out: tops.outpruned_matmul_dx(dyc, w, keep,
                                                       block=block, out=out),
                  tops.outpruned_matmul_dx_plain(dyc, w, keep, block),
                  (M, K), dtype, cuda_device, tops.outpruned_matmul_dx)
    finally:
        tops.set_launch_hook(prev)
    splits = tops._tc_partials(M, K, kb * block, cuda_device, direct=True)[0]
    t = _tname(dtype)
    want = [f"pruned_gemm_tc_kernel<OpDxPolicy,{t}>"] + (
        [f"reduce_splits_kernel<{t}>"] if splits > 1 else [])
    assert len(launches) == 2
    assert all([ln.fn for ln in ls] == want for ls in launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_compact", [False, True])
@pytest.mark.parametrize("case", sorted(_MAP_CASES))
def test_cuda_block_pruned_matmul_routes_match_plain(cuda_device, dtype,
                                                     x_compact, case):
    import numpy as np
    from repro_torch.kernels import build

    M, N, nb, kb, block, _, off = _MAP_CASES[case]
    K = nb * block
    g = np.random.default_rng(len(case) + 5)
    x = _tc_operand(g, (M, kb * block if x_compact else K), dtype,
                    cuda_device, off)
    w = _tc_operand(g, (K, N), dtype, cuda_device, off, 0.05)
    keep = _map_keep(case, cuda_device)
    if x_compact:
        x_full = torch.zeros((M, nb, block), dtype=dtype, device=cuda_device)
        x_full[:, keep.long()] = x.reshape(M, kb, block)
        ref = tops.block_pruned_matmul_plain(x_full.reshape(M, K), w, keep,
                                             block)
    else:
        ref = tops.block_pruned_matmul_plain(x, w, keep, block)
    dt = 0 if dtype == torch.float32 else 1
    got = []
    for _ in range(2):
        out = _nan((M, N), dtype, cuda_device)
        y, config = tops._launch_block_pruned(x, w, keep, block, dt,
                                              x_compact=x_compact, K=K,
                                              out=out)
        torch.cuda.synchronize()
        assert y.data_ptr() == out.data_ptr()
        assert bool(torch.isfinite(y.float()).all())
        _close(y, ref, dtype)
        got.append(y.clone())
    assert torch.equal(got[0], got[1])
    t = _tname(dtype)
    names = [ln.fn for ln in build.launch_config(*config)]
    product = (f"bpm_decode_kernel<{t}>" if M <= tops.BPM_DECODE_MAX_ROWS
               else f"pruned_gemm_tc_kernel<BpmPolicy,{t}>")
    assert names == [product] + (
        [f"reduce_splits_kernel<{t}>"] if config[-2] > 1 else [])
    if not x_compact:
        before = tops.block_pruned_matmul.launches
        y = tops.block_pruned_matmul(x, w, keep, block=block)
        torch.cuda.synchronize()
        assert tops.block_pruned_matmul.launches == before + 1
        assert torch.equal(y, got[0])


# ---------------------------------------------------------------------------
# #1 and #4: one kernel, two row policies (gqa_decode_attn.cu)
# ---------------------------------------------------------------------------

# (G, D, S or pps * ps, window): the CPU model's cases (test_torch_gqa_attn),
# plus D = 72 (a zero-filled copy past D), D = 36 (bf16 rows of 72
# bytes: the element-wise path), and G = 17 with Dv = 2 D = 192 (two
# groups of query heads, two column chunks)
_GQA_CASES = [
    (1, 32, 200, 0), (2, 64, 256, 1), (3, 128, 300, 9), (8, 128, 256, 200),
    (8, 32, 500, 0), (3, 64, 200, 200), (2, 72, 130, 9), (4, 36, 77, 0),
    (17, 96, 160, 0),
]


def _gqa_nan_rows(t, ok):
    """NaN in the rows [B, Hkv, S, d] of t that ``ok`` [B, S] does not
    attend."""
    t = t.clone()
    t[(~ok)[:, None, :, None].expand_as(t)] = float("nan")
    return t


def _gqa_calls(call, ref, shape, dtype, device, wrapper, policy):
    """Two calls into NaN-filled outputs: finite, within tolerance of the
    plain version, bit-identical, one launch each, launch names that show
    the row policy."""
    launches = []
    prev = tops.set_launch_hook(lambda name, ls: launches.append(ls))
    before = wrapper.launches
    got = []
    try:
        for _ in range(2):
            out = _nan(shape, dtype, device)
            y = call(out)
            torch.cuda.synchronize()
            assert y.data_ptr() == out.data_ptr()
            assert bool(torch.isfinite(y.float()).all())
            _close(y, ref, dtype)
            got.append(y.clone())
    finally:
        tops.set_launch_hook(prev)
    assert torch.equal(got[0], got[1])
    assert wrapper.launches == before + 2
    assert len(launches) == 2
    for ls in launches:
        names = [ln.fn for ln in ls]
        assert len(names) == 2
        assert names[0].startswith(f"gqa_decode_partial_kernel<{policy},")
        assert names[1] == f"gqa_decode_merge_kernel<{policy},{_tname(dtype)}>"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D,S,window", _GQA_CASES)
def test_cuda_gqa_decode_attention_matches_plain(cuda_device, dtype, G, D, S,
                                                 window):
    """#1 (SlotRows) at cur_pos -1, 0, S - 1, 2**30 and two middle rows,
    every row it must not read NaN."""
    g = torch.Generator(device=cuda_device).manual_seed(G * D + S + window)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    Hkv, B = 2, 6
    cur = torch.tensor([-1, 0, S - 1, 2 ** 30, S // 2 + 3, S // 3],
                       dtype=torch.int32, device=cuda_device)
    ok = tops.attended_rows(S, cur, window, cuda_device)
    q = rnd(B, Hkv * G, 1, D)
    k = _gqa_nan_rows(rnd(B, Hkv, S, D), ok)
    Dv = 2 * D if G == 17 else D
    v = _gqa_nan_rows(rnd(B, Hkv, S, Dv), ok)
    ref = tops.gqa_decode_attn_plain(q, k, v, cur, window)
    _gqa_calls(lambda out: tops.fused_decode_attention(
        q, k, v, cur_pos=cur, window=window, out=out), ref,
        (B, Hkv * G, 1, Dv), dtype, cuda_device, tops.fused_decode_attention,
        "SlotRows")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D,L,window", _GQA_CASES)
@pytest.mark.parametrize("ps", [8, 16])
def test_cuda_gqa_paged_decode_attention_matches_plain(cuda_device, dtype, G,
                                                       D, L, window, ps):
    """#4 (PagedRows): shuffled pages, trailing -1 entries, the invalid
    lane over all but two pages; NaN in every unreferenced page and in
    every row of a referenced page that the slot does not attend."""
    g = torch.Generator(device=cuda_device).manual_seed(G * D + L + ps)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    Hkv, pps = 2, -(-L // ps)
    cur_l = [-1, 0, pps * ps - 1 - ps, 2 ** 30, L // 2 + 1, 5]
    num_pages = 3 * pps + 2
    pages, unref = _paged_case(g, cuda_device, [max(c, 0) for c in cur_l],
                               ps, pps, num_pages)
    pages[0] = -1                       # cur_pos -1: an empty slot
    unref = torch.ones(num_pages, dtype=torch.bool, device=cuda_device)
    unref[pages[pages >= 0].long()] = False
    cur = torch.tensor(cur_l, dtype=torch.int32, device=cuda_device)
    q = rnd(len(cur_l), Hkv * G, 1, D)
    Dv = 2 * D if G == 17 else D
    pools = []
    for width in (D, Dv):
        pool = rnd(num_pages, Hkv, ps, width)
        pool[unref] = float("nan")
        ok = tops.paged_attended_rows(pages, ps, num_pages, cur, window)
        for b, row in enumerate(pages.tolist()):
            for j, page in enumerate(row):
                if page >= 0:
                    miss = ~ok[b, j * ps:(j + 1) * ps]
                    pool[page, :, miss] = float("nan")
        pools.append(pool)
    kp, vp = pools
    ref = tops.gqa_paged_decode_attn_plain(q, kp, vp, pages, cur, window)
    _gqa_calls(lambda out: tops.fused_paged_decode_attention(
        q, kp, vp, pages=pages, cur_pos=cur, window=window, out=out), ref,
        (len(cur_l), Hkv * G, 1, Dv), dtype, cuda_device,
        tops.fused_paged_decode_attention, "PagedRows")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gqa_decode_attention_unaligned_base(cuda_device, dtype):
    """Contiguous K / V whose base is one element past a 16-byte boundary:
    the element-wise path, in the same kernel, gives the vector path's
    result."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    B, Hkv, G, S, D = 3, 2, 4, 150, 64
    cur = torch.tensor([149, 2 ** 30, 40], dtype=torch.int32,
                       device=cuda_device)
    q = torch.randn((B, Hkv * G, 1, D), generator=g, device=cuda_device).to(
        dtype)
    n = B * Hkv * S * D
    flat = torch.randn((2, n + 1), generator=g, device=cuda_device).to(dtype)
    k, v = flat[0, 1:].view(B, Hkv, S, D), flat[1, 1:].view(B, Hkv, S, D)
    assert k.is_contiguous() and k.data_ptr() % 16 != 0
    ref = tops.gqa_decode_attn_plain(q, k, v, cur, 0)
    _gqa_calls(lambda out: tops.fused_decode_attention(
        q, k, v, cur_pos=cur, out=out), ref, (B, Hkv * G, 1, D), dtype,
        cuda_device, tops.fused_decode_attention, "SlotRows")
    # the same values in the same stages: the same bits
    assert torch.equal(
        tops.fused_decode_attention(q, k.clone(), v.clone(), cur_pos=cur),
        tops.fused_decode_attention(q, k, v, cur_pos=cur))


@pytest.mark.cuda
def test_cuda_gqa_launch_configs(cuda_device):
    """The grid is (B * Hkv, ceil(length / kRows), query-head groups x
    column chunks) from the shapes alone; the names carry the policy, the
    type and the head-dim tile (128, or 0: any D, Dv in chunks of 128);
    every launch fits the card at Yi-6B's shapes and at a wide head."""
    from repro_torch.analysis import smem
    from repro_torch.kernels import build

    rows = tops.GQA_ROWS
    for entry, policy in (("repro_gqa_decode_attn", "SlotRows"),
                          ("repro_gqa_paged_decode_attn", "PagedRows")):
        part, merge = build.launch_config(entry, 8, 4, 8, 128, 128,
                                          1024 // rows, 1)
        assert part.fn == f"gqa_decode_partial_kernel<{policy},__nv_bfloat16,128>"
        assert merge.fn == f"gqa_decode_merge_kernel<{policy},__nv_bfloat16>"
        assert part.grid == (32, 1024 // rows, 1) and part.threads == 128
        assert merge.grid == (-(-8 * 4 * 8 * 128 // 256), 1, 1)
        part, _ = build.launch_config(entry, 2, 1, 40, 64, 200, 3, 0)
        assert part.fn == f"gqa_decode_partial_kernel<{policy},float,0>"
        assert part.grid == (2, 3, 3 * 2)
        part, _ = build.launch_config(entry, 2, 1, 4, 32, 32, 1, 0)
        assert part.fn == f"gqa_decode_partial_kernel<{policy},float,128>"
        smem.assert_fits(build.launch_config(entry, 8, 4, 8, 128, 128, 8, 0))
        wide = build.launch_config(entry, 1, 1, 8, 1024, 1024, 1, 0)
        assert wide[0].threads < 128       # fewer warps where D is wide
        smem.assert_fits(wide)
