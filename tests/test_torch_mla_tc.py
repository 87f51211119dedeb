"""#5 (``fused_mla_decode_attention``) and #6
(``fused_paged_mla_decode_attention``) on the tensor cores, in
``csrc/mla_decode_attn.cu``: one kernel body, two row policies.

On the CPU: the plain versions against the JAX package's Pallas kernels
(interpret mode) at DeepSeek-V2-Lite's own widths (H = 16, R = 512, Dr =
64) with a short cache; the host side of the grid (shapes only); a numpy
model of the kernel's schedule held against the JAX package (finite
inputs) and against the plain versions (NaN in every row the kernel must
not read); and the facts of the design read from the source. The model
repeats what the kernel does in f32:

* a block per (slot, range) takes ``kRows`` rows from ``range * kRows``;
  a range past the slot's last attended row writes nothing, and the
  merge reads only the ranges that hold rows (counted from cur_pos);
* the block scores its rows (heads as the mma's m), takes one softmax
  over them in base 2 (scale * log2 e), and sums P . latent; a row past
  cur_pos or in an absent page is zero and masked (where a row is too
  wide for one pass, the rows come in passes and the softmax is carried
  across them online);
* the ranges merge in range order, one pass with a running maximum.

On the card (``cuda`` marker, skipped here): each route (compile-time
widths R = 512, Dr = 64; run-time widths, down to rows in passes where a
row is too wide for a block's 64 at once) against the plain version in
f32 and bf16, into NaN-filled outputs, with NaN in unattended rows and
unreferenced pages, and two calls that must give the same bits.

Tolerances: CPU f32 max |err| <= 1e-5 * max |ref| (the order of the sums
differs); card f32 <= 1e-4 * max |ref|, bf16 <= 2e-2 * max |ref|. The
JAX package is imported inside the CPU tests only, so this file also runs
on a machine with the card and no JAX. Inputs from fixed seeds.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

REL = 1e-5
INVALID = 2 ** 30
SOURCE = Path(tops.__file__).with_name("csrc") / "mla_decode_attn.cu"
LOG2E = np.float32(1.4426950408889634)
H, R, DR, SCALE_DIM = 16, 512, 64, 192        # DeepSeek-V2-Lite


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def _kernel_constants():
    src = SOURCE.read_text()
    rows = int(re.search(r"#define MLA_ROWS_PER_BLOCK (\d+)", src)[1])
    assert "constexpr int kRows = MLA_ROWS_PER_BLOCK;" in src
    return {"rows": rows, "tile": _const(src, "kTile"),
            "heads": _const(src, "kHeads"), "warps": _const(src, "kWarps"),
            "cols": _const(src, "kCols"), "fast_r": _const(src, "kFastR")}


KERNEL = _kernel_constants()


def _jops():
    from repro.kernels import ops as jops
    return jops


def _ranges(cur: int, length: int) -> int:
    """The kernel's ranges_of: blocks of kRows rows from row 0 that hold
    a slot's attended rows [0, min(cur, length - 1)]."""
    hi = min(cur, length - 1)
    return hi // KERNEL["rows"] + 1 if hi >= 0 else 0


def _inputs(rng, B):
    return (rng.standard_normal((B, H, R)).astype(np.float32),
            rng.standard_normal((B, H, DR)).astype(np.float32))


def _page_table(rng, cur, ps, pps, num_pages):
    """Shuffled pages up to each slot's cur_pos (an invalid lane all but
    its last two, then -1); the mask of the pages no table references."""
    perm = rng.permutation(num_pages)
    table = np.full((len(cur), pps), -1, np.int32)
    used = 0
    for b, c in enumerate(cur):
        n = pps - 2 if c >= pps * ps else c // ps + 1
        table[b, :n] = perm[used:used + n]
        used += n
    unref = np.ones(num_pages, bool)
    unref[table[table >= 0]] = False
    return table, unref


def _slot_rows(lat, rope):
    def rows(b, pos):
        return lat[b, pos], rope[b, pos], True
    return rows


def _paged_rows(lat, rope, table):
    ps, num_pages = lat.shape[1], lat.shape[0]

    def rows(b, pos):
        page = table[b, pos // ps]
        if page < 0 or page >= num_pages:
            return None, None, False
        return lat[page, pos % ps], rope[page, pos % ps], True
    return rows


def _model(qa, qr, rows, cur, length, scale, sub=None):
    """The kernel's schedule in numpy f32: f32 [B, H, R]. ``sub``: rows a
    pass stages (kRows on every path the port serves; fewer where a row
    is too wide for shared memory), the softmax carried across passes."""
    B = qa.shape[0]
    K = KERNEL["rows"]
    sub = sub or K
    out = np.zeros((B, H, R), np.float32)
    sl2 = np.float32(scale) * LOG2E
    for b in range(B):
        hi = min(int(cur[b]), length - 1)
        parts = []
        for r in range(_ranges(int(cur[b]), length)):
            n_rows = min(K, hi + 1 - r * K)
            m = np.full(H, -np.inf, np.float32)
            l = np.zeros(H, np.float32)
            acc = np.zeros((H, R), np.float32)
            for p0 in range(0, n_rows, sub):
                row0, n = r * K + p0, min(sub, n_rows - p0)
                lat = np.zeros((n, R), np.float32)
                rope = np.zeros((n, DR), np.float32)
                ok = np.zeros(n, bool)
                for i in range(n):
                    la, ro, present = rows(b, row0 + i)
                    if present:
                        lat[i], rope[i], ok[i] = la, ro, True
                s = (qa[b] @ lat.T + qr[b] @ rope.T) * sl2
                s = np.where(ok[None, :], s, -np.inf).astype(np.float32)
                m_new = np.maximum(m, s.max(axis=1))
                mu = np.where(m_new == -np.inf, 0, m_new).astype(np.float32)
                p = np.exp2(s - mu[:, None]).astype(np.float32)
                corr = np.exp2(m - mu)
                l = l * corr + p.sum(axis=1)
                acc = acc * corr[:, None] + p @ lat
                m = m_new
            parts.append((m, l, acc))
        M = np.full(H, -np.inf, np.float32)
        Ls = np.zeros(H, np.float32)
        A = np.zeros((H, R), np.float32)
        for mj, lj, aj in parts:           # range order, running maximum
            mn = np.maximum(M, mj)
            seen = mn != -np.inf
            safe = np.where(seen, mn, 0)
            c = np.where(seen, np.exp2(M - safe), 0)
            w = np.where(seen, np.exp2(mj - safe), 0)
            Ls = np.where(seen, Ls * c + lj * w, Ls)
            A = np.where(seen[:, None], A * c[:, None] + aj * w[:, None], A)
            M = np.where(seen, mn, M)
        out[b] = A / np.maximum(Ls, 1e-30)[:, None]
    return out


def _assert_close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


# ---------------------------------------------------------------------------
# the plain versions and the model against the JAX package
# ---------------------------------------------------------------------------

# S = 128: a whole number of the reference's 128-row tiles, so its
# invalid lane attends the same rows as the port's (ROADMAP.md, queue C)
SLOT_CUR = (0, 63, 64, INVALID)
PAGED_CUR = (0, INVALID, 40, 95)


def test_slot_plain_and_model_match_jax_at_deepseek_widths():
    rng = np.random.default_rng(0)
    S = 128
    qa, qr = _inputs(rng, 4)
    lat = rng.standard_normal((4, S, R)).astype(np.float32)
    rope = rng.standard_normal((4, S, DR)).astype(np.float32)
    cur = np.asarray(SLOT_CUR, np.int32)
    ref = np.asarray(_jops().fused_mla_decode_attention(
        qa, qr, lat, rope, cur_pos=cur, head_dim_for_scale=SCALE_DIM))
    got = tops.fused_mla_decode_attention(
        *map(torch.from_numpy, (qa, qr, lat, rope)),
        cur_pos=torch.from_numpy(cur), head_dim_for_scale=SCALE_DIM)
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), ref)
    _assert_close(_model(qa, qr, _slot_rows(lat, rope), cur, S,
                         1 / np.sqrt(SCALE_DIM)), ref)


def test_paged_plain_and_model_match_jax_at_deepseek_widths():
    rng = np.random.default_rng(1)
    ps, pps, num_pages = 16, 6, 20
    qa, qr = _inputs(rng, 4)
    table, unref = _page_table(rng, PAGED_CUR, ps, pps, num_pages)
    lat = rng.standard_normal((num_pages, ps, R)).astype(np.float32)
    rope = rng.standard_normal((num_pages, ps, DR)).astype(np.float32)
    lat[unref] = np.nan
    rope[unref] = np.nan
    cur = np.asarray(PAGED_CUR, np.int32)
    ref = np.asarray(_jops().fused_paged_mla_decode_attention(
        qa, qr, lat, rope, pages=table, cur_pos=cur,
        head_dim_for_scale=SCALE_DIM))
    got = tops.fused_paged_mla_decode_attention(
        *map(torch.from_numpy, (qa, qr, lat, rope)),
        pages=torch.from_numpy(table), cur_pos=torch.from_numpy(cur),
        head_dim_for_scale=SCALE_DIM)
    _assert_close(got.numpy(), ref)
    _assert_close(_model(qa, qr, _paged_rows(lat, rope, table), cur,
                         pps * ps, 1 / np.sqrt(SCALE_DIM)), ref)


@pytest.mark.parametrize("S,sub", [(96, None), (200, None), (200, 16)])
def test_model_matches_plain_with_nan_in_unattended_rows(S, sub):
    """Every row past a slot's cur_pos is NaN: the model (as the kernel)
    never reads it; a ragged cache, an invalid lane, cur_pos 0; a block's
    rows in one pass, or in passes of 16 (a row too wide for one)."""
    rng = np.random.default_rng(S)
    qa, qr = _inputs(rng, 4)
    lat = rng.standard_normal((4, S, R)).astype(np.float32)
    rope = rng.standard_normal((4, S, DR)).astype(np.float32)
    cur = np.asarray([0, S // 2, INVALID, S - 1], np.int32)
    for b, c in enumerate(cur):
        lat[b, c + 1:] = np.nan
        rope[b, c + 1:] = np.nan
    want = tops.mla_decode_attn_plain(
        *map(torch.from_numpy, (qa, qr, lat, rope)), torch.from_numpy(cur),
        SCALE_DIM).numpy()
    _assert_close(_model(qa, qr, _slot_rows(lat, rope), cur, S,
                         1 / np.sqrt(SCALE_DIM), sub), want)


# ---------------------------------------------------------------------------
# the host side of the grid, and which ranges hold rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,length", [(8, 1024), (8, 96), (3, 1), (2, 65)])
def test_grid_is_sized_from_shapes_only(B, length):
    """ranges = ceil(length / kRows) (enough for a slot that attends
    every row), one f32 partial per (slot, range, head); the function
    takes no tensor, so it cannot read cur_pos or the page table."""
    assert tops.MLA_ROWS == KERNEL["rows"]
    ranges, part_ml, part_acc = tops._mla_partials(B, H, R, length, "cpu")
    assert ranges == -(-length // KERNEL["rows"])
    assert tuple(part_ml.shape) == (2, B * ranges * H)
    assert tuple(part_acc.shape) == (B * ranges * H * R,)
    assert part_ml.dtype == part_acc.dtype == torch.float32
    assert _ranges(INVALID, length) == ranges


@pytest.mark.parametrize("length", [96, 1024, 1000])
def test_ranges_cover_every_attended_row_once(length):
    """The blocks that hold rows for a cur_pos take each attended row
    exactly once, and a block past the last one holds none."""
    K = KERNEL["rows"]
    for cur in (-1, 0, 1, K - 1, K, 2 * K + 5, length - 1, length,
                INVALID):
        hi = min(cur, length - 1)
        n = _ranges(cur, length)
        seen = [p for r in range(n)
                for p in range(r * K, min((r + 1) * K, hi + 1))]
        assert seen == list(range(hi + 1))
        assert n <= -(-length // K)
        assert all(r * K > hi for r in range(n, -(-length // K)))


# ---------------------------------------------------------------------------
# the design, read from the source
# ---------------------------------------------------------------------------


def test_one_body_two_row_policies():
    """One templated body and one merge, instantiated for SlotRows and
    PagedRows, whose names carry the policy and the widths route."""
    src = SOURCE.read_text()
    assert src.count("__global__") == 2
    assert re.search(r"template <typename T, typename Rows, int RR, int DRR>"
                     r"\s*__global__ void __launch_bounds__\(kThreads\)\s*"
                     r"mla_partial_kernel\(", src)
    assert re.search(r"template <typename Rows>\s*__global__ void "
                     r"mla_merge_kernel\(", src)
    assert "struct SlotRows" in src and "struct PagedRows" in src
    assert '"mla_partial_kernel<%s,%s,%d,%d>"' in src
    assert '"mla_merge_kernel<%s>"' in src
    assert 'paged ? "PagedRows" : "SlotRows"' in src
    # an absent page (-1 or past the pool) is never read
    assert "if (page < 0 || page >= num_pages) return -1;" in src
    assert tbuild.CONFIG_SIGNATURES["repro_mla_decode_attn"] == 7
    assert "mla_decode_attn.cu" in tbuild.SOURCES


def test_tensor_cores_cp_async_and_no_atomics():
    src = SOURCE.read_text()
    for needle in ("cp_async16(", "cp_async_commit()", "mma_tile16_scores<",
                   "mma_bf16(", "mma_tf32(", "ldsm_x4_t(", "split_tf32("):
        assert needle in src, needle
    assert re.search(r"\batomic\w*\(", src) is None
    # a block with no attended row returns before it stages q
    body = src[src.index("mla_partial_kernel(const T*"):]
    assert body.index("if (r >= ranges_of(") < body.index("copy_row<")
    # 16 heads a block (the mma's m), 4 heads a warp in the softmax, and
    # the warps' output columns cover the compile-time latent width
    assert KERNEL["heads"] == 16 and KERNEL["tile"] == 16
    assert KERNEL["warps"] * KERNEL["cols"] == KERNEL["fast_r"] == R
    assert KERNEL["rows"] % 32 == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, dtype):
    got, ref = got.float().cpu(), ref.float().cpu()
    assert bool(torch.isfinite(got).all())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


def _card_case(dev, dtype, B, h, r, dr, ps, pps, cur_l, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    rng = np.random.default_rng(seed)
    table, unref = _page_table(rng, cur_l, ps, pps, B * pps)
    S = ps * pps
    cur = torch.tensor(cur_l, dtype=torch.int32, device=dev)
    qa, qr = rnd(B, h, r), rnd(B, h, dr)
    lat, rope = rnd(B, S, r), rnd(B, S, dr)
    # the plain version reads clean rows; the kernel reads NaN past each
    # cur_pos and in every unreferenced page
    lat_nan, rope_nan = lat.clone(), rope.clone()
    for b, c in enumerate(cur_l):
        lat_nan[b, c + 1:] = float("nan")
        rope_nan[b, c + 1:] = float("nan")
    lp, rp = rnd(B * pps, ps, r), rnd(B * pps, ps, dr)
    lp[torch.from_numpy(unref).to(dev)] = float("nan")
    rp[torch.from_numpy(unref).to(dev)] = float("nan")
    pages = torch.from_numpy(table).to(dev)
    return qa, qr, lat, rope, lat_nan, rope_nan, lp, rp, pages, cur


def _twice(call, shape, dev):
    """Two calls into NaN-filled outputs; they must agree bit for bit."""
    outs = []
    for _ in range(2):
        out = torch.full(shape, float("nan"), device=dev)
        got = call(out)
        assert got.data_ptr() == out.data_ptr()
        outs.append(got)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    return outs[0]


# (B, H, R, Dr, page size, pages a slot, cur_pos): DeepSeek-V2-Lite's
# widths at the smoke run's phase-2 positions and at a decode step's;
# run-time widths at the card tests' small ragged shapes (an odd head
# count, page size 8), past 16 heads, and a latent too wide for a block's
# 64 rows at once (passes of 32 rows in bf16, 16 in f32; four column
# chunks)
CARD_CASES = {
    "deepseek": (8, 16, 512, 64, 16, 64,
                 (0, 127, 128, 1023, INVALID, 31, 500, 777)),
    "deepseek_step": (8, 16, 512, 64, 16, 20,
                      (63, 99, 136, 172, 209, 246, 282, 319)),
    "runtime_widths": (4, 5, 64, 16, 8, 12, (0, 21, INVALID, 70)),
    "heads_past_16": (3, 20, 96, 8, 8, 9, (5, INVALID, 40)),
    "wide_latent": (3, 16, 1600, 64, 16, 10, (5, 120, INVALID)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_mla_kernels_match_plain(cuda_device, dtype, case):
    B, h, r, dr, ps, pps, cur_l = CARD_CASES[case]
    (qa, qr, lat, rope, lat_nan, rope_nan, lp, rp, pages,
     cur) = _card_case(cuda_device, dtype, B, h, r, dr, ps, pps, cur_l,
                       seed=len(case))
    launches = []
    prev = tops.set_launch_hook(lambda name, ls: launches.extend(ls))
    try:
        got = _twice(lambda out: tops.fused_mla_decode_attention(
            qa, qr, lat_nan, rope_nan, cur_pos=cur, head_dim_for_scale=24,
            out=out), (B, h, r), cuda_device)
        _close(got, tops.mla_decode_attn_plain(qa, qr, lat, rope, cur, 24),
               dtype)
        got = _twice(lambda out: tops.fused_paged_mla_decode_attention(
            qa, qr, lp, rp, pages=pages, cur_pos=cur, head_dim_for_scale=24,
            out=out), (B, h, r), cuda_device)
        _close(got, tops.mla_paged_decode_attn_plain(qa, qr, lp, rp, pages,
                                                     cur, 24), dtype)
    finally:
        tops.set_launch_hook(prev)
    # the route: compile-time widths for DeepSeek's, run-time otherwise
    widths = ",512,64>" if (r, dr) == (R, DR) else ",0,0>"
    partial = [ln.fn for ln in launches if "mla_partial_kernel" in ln.fn]
    t = "float" if dtype == torch.float32 else "__nv_bfloat16"
    assert partial == [f"mla_partial_kernel<{t},SlotRows{widths}"] * 2 + \
        [f"mla_partial_kernel<{t},PagedRows{widths}"] * 2
    chunks = 1 if widths == ",512,64>" else -(-r // 512)
    assert [ln.grid[2] for ln in launches
            if "mla_partial_kernel" in ln.fn] == [-(-h // 16) * chunks] * 4


@pytest.mark.cuda
def test_cuda_mla_slot_with_no_row_writes_zeros(cuda_device):
    """cur_pos -1 (no attended row) and an all-absent page table: the
    merge reads no range and writes 0, as the plain version."""
    B, h, r, dr, ps, pps = 2, 16, 512, 64, 16, 4
    g = torch.Generator(device=cuda_device).manual_seed(3)
    qa = torch.randn((B, h, r), generator=g, device=cuda_device)
    qr = torch.randn((B, h, dr), generator=g, device=cuda_device)
    lat = torch.full((B, ps * pps, r), float("nan"), device=cuda_device)
    rope = torch.full((B, ps * pps, dr), float("nan"), device=cuda_device)
    cur = torch.tensor([-1, -1], dtype=torch.int32, device=cuda_device)
    got = tops.fused_mla_decode_attention(qa, qr, lat, rope, cur_pos=cur,
                                          head_dim_for_scale=24)
    assert torch.equal(got.cpu(), torch.zeros((B, h, r)))
    pages = torch.full((B, pps), -1, dtype=torch.int32, device=cuda_device)
    cur = torch.tensor([20, INVALID], dtype=torch.int32, device=cuda_device)
    got = tops.fused_paged_mla_decode_attention(
        qa, qr, lat.reshape(B * pps, ps, r), rope.reshape(B * pps, ps, dr),
        pages=pages, cur_pos=cur, head_dim_for_scale=24)
    assert torch.equal(got.cpu(), torch.zeros((B, h, r)))
