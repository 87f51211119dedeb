"""#7 (``unfused_decode_attention``) with each of its three launches made
fast, in ``csrc/unfused_gqa_decode_attn.cu``.

On the CPU: the three-launch contract read from the source and the
wrapper (three kernels on one stream, the f32 [B, Hkv, G, S] score matrix
in device memory, every cache row read whatever cur_pos is, the finite
NEG_INF); a numpy model of the new launches — scores over every row, the
softmax (one pass, or the online pass of a row longer than a warp holds),
the weighted sum's partition of the rows over warps and row slots and its
fixed-order sum — held against the JAX package's Pallas kernels
(interpret mode) at Yi-6B's head widths and against the plain version at
ragged shapes.

On the card (``cuda`` marker, skipped here): the kernel against its plain
version at full Yi-6B width and at ragged shapes that take every branch
(a head dim past 128, rows past 1024, more than 16 query heads, head dims
and rows that are not whole 16-byte runs), f32 and bf16, into NaN-filled outputs,
and two calls that must give the same bits.

Tolerances: CPU f32 max |err| <= 1e-5 * max |ref|; card f32 <= 1e-4 *
max |ref|, bf16 <= 2e-2 * max |ref|. The JAX package is imported inside
the CPU tests only. Inputs from fixed seeds.
"""
import inspect
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
SOURCE = Path(tops.__file__).with_name("csrc") / "unfused_gqa_decode_attn.cu"


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def _kernel_constants():
    src = SOURCE.read_text()
    return {k: _const(src, k) for k in (
        "kScoreWarps", "kTile", "kGroup", "kSoftmaxThreads", "kRowRegs",
        "kWsumWarps", "kCols", "kGBatch", "kSChunk")}


KERNEL = _kernel_constants()


def _jops():
    from repro.kernels import ops as jops
    return jops


# ---------------------------------------------------------------------------
# the three-launch contract, read from the source and the wrapper
# ---------------------------------------------------------------------------


def test_three_launches_with_the_score_matrix_in_device_memory():
    src = SOURCE.read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                         r"(\w+)\(", src)
    assert kernels == ["unfused_scores_kernel", "unfused_softmax_kernel",
                       "unfused_wsum_kernel"]
    config = src[src.index("int config("):src.index("template <typename T, "
                                                    "int HD>\ncudaError_t")]
    assert config.count("set_launch(") == 3 and "return 3;" in config
    for name in ("unfused_scores_kernel<%s,%d>", "unfused_softmax_kernel",
                 "unfused_wsum_kernel<%s>"):
        assert f'"{name}"' in config
    assert tbuild.CONFIG_SIGNATURES["repro_unfused_gqa_decode_attn"] == 7
    # the wrapper allocates the f32 score matrix the three launches share
    wrapper = inspect.getsource(tops.unfused_decode_attention)
    assert re.search(r"torch\.empty\(\(B, Hkv, G, S\), dtype=torch\.float32",
                     wrapper)
    # the launches run in order on the caller's stream: scores, softmax
    # (in place), wsum
    launch = src[src.index("cudaError_t launch(const void* q"):]
    order = [launch.index(k) for k in ("launch_scores<T, 128>",
                                       "unfused_softmax_kernel<<<",
                                       "unfused_wsum_kernel<T><<<")]
    assert order == sorted(order) and launch.count(", st>>>(") == 2
    # the finite mask value, as in the TPU kernel and the plain version
    assert "constexpr float kNegInf = -1e30f;" in src
    assert tops.NEG_INF == -1e30
    assert re.search(r"\batomic\w*\(", src) is None


def test_every_cache_row_is_read_whatever_cur_pos_is():
    """The scores grid covers ceil(S / rows) tiles of every (slot, head)
    (64 rows a block, fewer at a wide head dim) and returns only past S;
    the weighted sum's warps cover every row."""
    src = SOURCE.read_text()
    body = src[src.index("unfused_scores_kernel(const T*"):
               src.index("// max (kMax) or sum of v")]
    assert body.count("return;") == 1 and "if (p0 >= S) return;" in body
    # cur_pos is read only to mask the scores, after every copy
    assert body.count("cur_pos[") == 1
    assert body.index("cur_pos[b]") > body.index("mma_tile16_scores")
    assert "dim3(B * Hkv, (S + rows - 1) / rows, (G + kGroup - 1) / kGroup)" \
        in src and "const int rows = warps * kTile;" in src
    assert KERNEL["kScoreWarps"] * KERNEL["kTile"] == 64
    wsum = src[src.index("unfused_wsum_kernel(const float*"):]
    assert "cur_pos" not in wsum[:wsum.index("int config(")]


# ---------------------------------------------------------------------------
# the numpy model of the three launches
# ---------------------------------------------------------------------------


def _wsum_slots(S: int, itemsize: int):
    """The weighted sum's rows of each warp (its k-steps w, w + 16, ... of
    each staged chunk: 16 rows an mma step in bf16, 8 in f32), in the
    order the block adds the warps' sums: [[rows of warp 0], ...]."""
    W, C = KERNEL["kWsumWarps"], KERNEL["kSChunk"]
    step = 16 if itemsize == 2 else 8
    slots = [[] for _ in range(W)]
    for s0 in range(0, S, C):
        sn = min(C, S - s0)
        for w in range(W):
            for k0 in range(w * step, sn, W * step):
                slots[w] += [s0 + s for s in range(k0, min(k0 + step, sn))]
    return slots


def _softmax(s):
    """One block a row: the one-pass form up to kSoftmaxThreads *
    kRowRegs values, the online form (each thread's running (m, l), then
    the block's) past it."""
    S, T = s.shape[-1], KERNEL["kSoftmaxThreads"]
    if S <= T * KERNEL["kRowRegs"]:
        e = np.exp(s - s.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    out = np.empty_like(s)
    for idx in np.ndindex(*s.shape[:-1]):
        x = s[idx]
        ms, ls = [], []
        for t in range(T):
            m, l = -np.inf, np.float32(0)
            for xv in x[t::T]:
                if xv > m:
                    l, m = l * np.exp(m - xv) + 1, xv
                else:
                    l += np.exp(xv - m)
            ms.append(m)
            ls.append(l)
        M = max(ms)
        L = sum(l * np.exp(m - M) for m, l in zip(ms, ls) if m > -np.inf)
        out[idx] = np.exp(x - M) / L
    return out


def _model(q, k, v, cur, window, itemsize=4):
    """The three launches in numpy f32: q [B, Hq, 1, D] -> [B, Hq, 1, Dv]."""
    B, Hq, _, D = q.shape
    Hkv, S, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).astype(np.float32)
    s = np.einsum("bhgd,bhsd->bhgs", qg, k.astype(np.float32)) \
        * np.float32(1 / np.sqrt(D))
    pos = np.arange(S)[None, :]
    ok = pos <= cur[:, None]
    if window > 0:
        ok &= pos > cur[:, None] - window
    s = np.where(ok[:, None, None, :], s, np.float32(-1e30))
    p = _softmax(s.astype(np.float32))
    out = np.zeros((B, Hkv, G, Dv), np.float32)
    for slot in _wsum_slots(S, itemsize):          # fixed order
        if slot:
            out += np.einsum("bhgs,bhsd->bhgd", p[..., slot],
                             v[:, :, slot].astype(np.float32))
    return out.reshape(B, Hq, 1, Dv)


def _assert_close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize("window", [0, 40])
def test_plain_and_model_match_jax_at_yi_head_widths(window):
    """G = 8 query heads of 128 per KV head (Yi-6B) over a 128-row cache
    (a whole tile of the reference), an all-masked lane (the mean of V)
    and an invalid lane."""
    rng = np.random.default_rng(window)
    q = rng.standard_normal((3, 16, 1, 128)).astype(np.float32)
    k = rng.standard_normal((3, 2, 128, 128)).astype(np.float32)
    v = rng.standard_normal((3, 2, 128, 128)).astype(np.float32)
    cur = np.asarray([-1, 77, INVALID], np.int32)
    ref = np.asarray(_jops().unfused_decode_attention(
        q, k, v, cur_pos=cur, window=window))
    got = tops.unfused_decode_attention(
        *map(torch.from_numpy, (q, k, v)), cur_pos=torch.from_numpy(cur),
        window=window).numpy()
    _assert_close(got, ref)
    _assert_close(_model(q, k, v, cur, window), ref)


@pytest.mark.parametrize("G,S,D,Dv,itemsize", [
    (3, 203, 40, 40, 4), (20, 1100, 24, 72, 2), (2, 70, 160, 16, 4)])
def test_model_matches_plain_at_ragged_shapes(G, S, D, Dv, itemsize):
    """Ragged S and head dims; rows past a block's registers (the online
    softmax, two staged chunks of P and V), more than 16 query heads (two
    batches of the mma's m)."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, 2 * G, 1, D)).astype(np.float32)
    k = rng.standard_normal((2, 2, S, D)).astype(np.float32)
    v = rng.standard_normal((2, 2, S, Dv)).astype(np.float32)
    cur = np.asarray([S // 3, INVALID], np.int32)
    want = tops.unfused_gqa_decode_attn_plain(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(cur), 0).numpy()
    _assert_close(_model(q, k, v, cur, 0, itemsize), want)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("S", [1, 7, 203, 1024, 1025, 3000])
def test_wsum_slots_take_every_row_once(S, itemsize):
    rows = sorted(r for slot in _wsum_slots(S, itemsize) for r in slot)
    assert rows == list(range(S))
    # the score grid's tiles cover every row too
    tiles = -(-S // (KERNEL["kScoreWarps"] * KERNEL["kTile"]))
    assert tiles * 64 >= S > (tiles - 1) * 64


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


# (B, Hq, Hkv, S, D, Dv, cur_pos, windows): full Yi-6B width at the smoke
# run's phase-2 positions; the analyzer's micro_kernel probe; ragged
# shapes that take the run-time head tile (D > 128), the online softmax
# (S > 1024), two staged chunks of P and V and two batches of 16 query
# heads; head dims and rows that are not whole 16-byte runs (element-wise
# copies); a head dim too wide for 4 warps' rows (fewer warps a block)
CARD_CASES = {
    "yi_phase2": (8, 32, 4, 1024, 128, 128,
                  (0, 127, 128, 1023, INVALID, 31, 500, 777), (0, 200)),
    "yi_no_row": (8, 32, 4, 1024, 128, 128,
                  (-1, 5, 300, -1, INVALID, 0, 1023, 64), (0,)),
    "probe": (4, 32, 8, 256, 128, 128, (0, 100, 255, INVALID), (0,)),
    "long_wide": (3, 40, 2, 1500, 160, 72, (0, 1100, INVALID), (0, 300)),
    "odd_dims": (5, 6, 2, 203, 36, 70, (0, 77, INVALID, 202, -1), (0, 50)),
    "wide_head": (2, 4, 2, 150, 1000, 40, (0, INVALID), (0,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_unfused_matches_plain(cuda_device, dtype, case):
    B, Hq, Hkv, S, D, Dv, cur_l, windows = CARD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(len(case))

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q, k, v = rnd(B, Hq, 1, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, Dv)
    cur = torch.tensor(cur_l, dtype=torch.int32, device=cuda_device)
    launches = []
    prev = tops.set_launch_hook(lambda name, ls: launches.extend(ls))
    try:
        for window in windows:
            outs = []
            for _ in range(2):
                out = torch.full((B, Hq, 1, Dv), float("nan"), dtype=dtype,
                                 device=cuda_device)
                got = tops.unfused_decode_attention(q, k, v, cur_pos=cur,
                                                    window=window, out=out)
                assert got.data_ptr() == out.data_ptr()
                outs.append(got)
            torch.cuda.synchronize()
            assert torch.equal(outs[0], outs[1])
            _close(outs[0], tops.unfused_gqa_decode_attn_plain(
                q, k, v, cur, window), dtype)
    finally:
        tops.set_launch_hook(prev)
    t = "float" if dtype == torch.float32 else "__nv_bfloat16"
    tile = 128 if D <= 128 else 0
    assert [ln.fn for ln in launches[:3]] == [
        f"unfused_scores_kernel<{t},{tile}>", "unfused_softmax_kernel",
        f"unfused_wsum_kernel<{t}>"]
    assert len(launches) == 3 * 2 * len(windows)
