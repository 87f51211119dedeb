"""#11 (``outpruned_matmul_dx``) and #2 (``block_pruned_matmul``) as far
as the CPU can check their kernels.

Both contract over the kept blocks: #11's B(t, j) = w[j, col(t)] and #2's
A(i, t) = x[i, col(t)] (unless x_compact) and B(t, j) = w[row(t), j] read
the contraction index t through the block map. On the card, #11 and #2
above ``BPM_DECODE_MAX_ROWS`` rows run the tensor-core core of
``csrc/pruned_grad.cu`` (its loaders resolve the stored position of t once
per copy and stage), and #2 at or below it the decode kernel of
``csrc/block_pruned_matmul.cu``. The kernels run only on the card
(``tests/test_torch_cuda.py``). Here: the hosts' choices (contraction
splits and one-range outputs at the ViT-1B train and Yi-6B decode
shapes, the decode / tensor-core route as a function of M), the loaders'
constants read from the kernel sources, and numpy models of both kernels'
f32 arithmetic (``test_torch_tc_core``'s 3xTF32 split model, the
contraction gathered through ``keep``; the decode kernel's 16-row chunks,
warps and ranges summed in order) held against the JAX package's Pallas
kernels in interpret mode. Tolerance as the other backward-family tests:
max |err| <= 1e-5 * max |ref|. Inputs from fixed numpy seeds.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import pruned_matmul as jpk
from repro_torch.kernels import ops as tops
from test_torch_tc_core import H100_SMS, SOURCE, _close, _tc_model, \
    _three_tf32

torch.set_num_threads(1)

DECODE_SOURCE = SOURCE.with_name("block_pruned_matmul.cu")


def _sms(monkeypatch):
    monkeypatch.setattr(tops, "_num_sms", lambda index: H100_SMS)


def _tc_splits(rows, cols, depth, monkeypatch):
    _sms(monkeypatch)
    splits, partial = tops._tc_partials(rows, cols, depth,
                                        torch.device("cpu", 0), direct=True)
    assert partial.dtype == torch.float32
    assert tuple(partial.shape) == ((0 if splits == 1 else splits), rows,
                                    cols)
    return splits


# (what, kept output rows, columns, kept contraction, splits): the ViT-1B
# train shapes at tp 4 (M = 520, block 8) with the straggler's keep counts
TRAIN = [
    ("#11 FFN dx: dpre[520,240] . w_up[:, keep 30/256]^T", 520, 2048, 240, 1),
    ("#2 wq_r: x[520,2048] @ w[2048,512], keep 32/256", 520, 512, 256, 4),
    ("#2 wo_r: x[520,512] @ w[512,2048], keep 8/64", 520, 2048, 64, 1),
    ("#2 FFN down: h[520,240] @ w_down[2048,2048], x_compact", 520, 2048,
     240, 1),
]


@pytest.mark.parametrize("what,rows,cols,depth,want", TRAIN,
                         ids=[t[0].split(":")[0] for t in TRAIN])
def test_tensor_core_ranges_at_the_train_shapes(what, rows, cols, depth,
                                                want, monkeypatch):
    """About two blocks per SM over the output tiles: 288 tiles (#11, #2
    at wo_r and the FFN's down product) already fill the card, so one
    range, written by the epilogue with no partial buffer; #2 at wq_r (72
    tiles, 8 stages) takes 4 ranges, summed by a second launch."""
    assert _tc_splits(rows, cols, depth, monkeypatch) == want
    tiles = -(-rows // tops.TC_TILE) * -(-cols // tops.TC_TILE)
    stages = -(-depth // tops.TC_DEPTH)
    assert want == min(stages, -(-2 * H100_SMS // tiles))


def test_two_launch_cores_keep_their_partial_buffer(monkeypatch):
    """Without ``direct`` (#8, #10) one range still has its buffer: the
    second launch sums it."""
    _sms(monkeypatch)
    splits, partial = tops._tc_partials(520, 2048, 240,
                                        torch.device("cpu", 0))
    assert splits == 1 and tuple(partial.shape) == (1, 520, 2048)


# (what, M, N, kept rows of 128, ranges): Yi-6B decode, 8 slots, block 128
DECODE = [
    ("wq keep 28/32", 8, 4096, 28 * 128, 4),
    ("wk keep 28/32", 8, 512, 28 * 128, 7),
    ("wq keep 4/32", 8, 4096, 4 * 128, 1),
    ("FFN down keep 75/86", 8, 4096, 75 * 128, 4),
    ("one slot, wk keep 1/32", 1, 512, 128, 1),
    ("more tiles than resident blocks", 8, 32768, 28 * 128, 1),
]


@pytest.mark.parametrize("what,M,N,depth,want", DECODE,
                         ids=[d[0] for d in DECODE])
def test_decode_ranges_at_the_serving_shapes(what, M, N, depth, want,
                                             monkeypatch):
    """As many ranges as keep every block resident at once (two per SM
    over the 64-column tiles), but every warp of a range with a full ring
    of chunks of 16 rows (BPM_RING of them): `wq`'s 64 tiles take 4
    ranges, `wk`'s 8 tiles 7, not 33, and `wq` at 4 kept blocks one range,
    written without partials."""
    _sms(monkeypatch)
    splits = tops._bpm_decode_splits(M, N, depth, torch.device("cpu", 0))
    assert splits == want
    chunks = -(-depth // tops.BPM_ROWS)
    tiles = -(-N // tops.BPM_COLS) * -(-M // tops.BPM_SLOTS)
    assert splits == 1 or (
        -(-chunks // splits) >= tops.BPM_WARPS * tops.BPM_RING
        and splits * tiles <= 2 * H100_SMS)


class _FakeLib:
    """Records which C entry point a wrapper calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


@pytest.mark.parametrize("M", [1, 7, 8, 9, 16, 17, 64, 520])
@pytest.mark.parametrize("x_compact", [False, True])
def test_route_by_rows(M, x_compact, monkeypatch):
    """The decode kernel up to BPM_DECODE_MAX_ROWS (16: the 8 slots of
    the serving path and a prefill chunk of 16) rows of x, the
    tensor-core core above: a function of M alone, with no option. The
    config key names the entry that ran."""
    assert tops.BPM_DECODE_MAX_ROWS == 16
    fake = _FakeLib()
    lib = type("Lib", (), {"lib": fake})()
    monkeypatch.setattr(tops._build, "library", lambda: lib)
    monkeypatch.setattr(tops, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    _sms(monkeypatch)
    keep = torch.tensor([3, 0, 5], dtype=torch.int32)
    x = torch.zeros((M, 3 * 8 if x_compact else 64))
    y, config = tops._launch_block_pruned(x, torch.zeros((64, 40)), keep, 8,
                                          0, x_compact=x_compact, K=64)
    assert tuple(y.shape) == (M, 40)
    name, = fake.calls
    want = ("repro_block_pruned_matmul" if M <= 16
            else "repro_block_pruned_matmul_tc")
    assert name == config[0] == want
    if M <= 16:
        assert config == (want, M, 40, 3, 8, 1, 0)
    else:
        assert config[1:] == (M, 64, 40, 3, 8, int(x_compact), 1, 0)


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def test_decode_constants_match_the_kernel_source():
    """The wrapper's tile constants are the kernel's; each lane loads 4
    rows x 8 columns (4 lanes tg per column group, 8 groups g), so a
    chunk is 16 rows and a block's tile 64 columns; the 8 slots are the
    mma's n; the register ring holds BPM_RING chunks of bf16 per warp (8
    16-byte loads of one depth, f32 half as many chunks of twice the
    bytes); the warps' sums meet in 16 KB of static shared memory."""
    src = DECODE_SOURCE.read_text()
    assert _const(src, "kCols") == tops.BPM_COLS == 8 * 8
    assert _const(src, "kRows") == tops.BPM_ROWS == 4 * 4
    assert _const(src, "kSlots") == tops.BPM_SLOTS == 8
    assert _const(src, "kWarps") == tops.BPM_WARPS
    assert "kDepth = 8 / kPieces / 2;" in src
    pieces = {4: 2, 2: 1}                     # 16-byte loads per 8 columns
    assert {size: 8 // p // 2 for size, p in pieces.items()} == {
        2: tops.BPM_RING, 4: tops.BPM_RING // 2}
    assert "float red[kWarps * 16 * 32];" in src
    assert tops.BPM_WARPS * 16 * 32 * 4 <= 48 * 1024
    assert "mma_bf16(acc[u], a, b)" in src and "mma_tf32(acc[u]" in src


def test_mapped_contraction_loader_constants():
    """Along t a 16-byte copy of a mapped operand stays inside one block
    when block % V == 0 (f32 V = 4, bf16 V = 8): true at the train path's
    block 8 and the serving path's 128, and the vector rule of the
    launcher asks for exactly that; a ring stage (32 deep) at block 8
    crosses 4 blocks, each copy resolved on its own."""
    src = SOURCE.read_text()
    assert "kVec = 16 / (int)sizeof(T);" in src
    assert src.count("(!Policy::a_tmap(p) || p.blk % V == 0)") == 1
    assert src.count("(!Policy::b_tmap(p) || p.blk % V == 0)") == 1
    for size in (4, 2):
        vec = 16 // size
        assert 8 % vec == 0 and 128 % vec == 0 and 6 % vec != 0
    assert tops.TC_DEPTH % 8 == 0
    assert "pruned_gemm_kernel" not in src
    for policy in ("OpDxPolicy", "BpmPolicy"):
        body = src[src.index(f"struct {policy}"):]
        body = body[:body.index("};")]
        assert "DIRECT = true" in body and "b_tmap" in body


# (block, nb, kb, unsorted, M, width): the Pallas kernels take tile
# multiples (8 rows, 16 wide); the width is K (dx's columns) for #11 and
# N (y's columns) for #2
CASES = [
    (8, 6, 4, False, 72, 48),
    (8, 24, 7, True, 40, 32),
    (128, 3, 2, True, 136, 16),
    (128, 4, 1, False, 40, 32),
]


def _keep(rng, nb, kb, unsorted):
    keep = rng.choice(nb, size=kb, replace=False).astype(np.int32)
    return keep if unsorted else np.sort(keep)


@pytest.mark.parametrize("block,nb,kb,unsorted,M,K", CASES)
def test_outpruned_dx_model_matches_jax(block, nb, kb, unsorted, M, K,
                                        monkeypatch):
    """#11: dyc . w[:, keep]^T through the core's split 3xTF32 model (B
    read through the map: B(t, j) = w[j, col(t)]) and the port's plain
    version, against outpruned_matmul_dx_2d."""
    rng = np.random.default_rng(50 + block + nb + kb + M)
    dyc = rng.standard_normal((M, kb * block)).astype(np.float32)
    w = (rng.standard_normal((K, nb * block)) * 0.1).astype(np.float32)
    keep = _keep(rng, nb, kb, unsorted)
    ref = jpk.outpruned_matmul_dx_2d(jnp.asarray(dyc), jnp.asarray(w),
                                     jnp.asarray(keep), block=block, tm=8,
                                     tk=16, interpret=True)
    cols = w.reshape(K, nb, block)[:, keep].reshape(K, kb * block)
    splits = _tc_splits(M, K, kb * block, monkeypatch)
    _close(_tc_model(dyc, np.ascontiguousarray(cols.T), splits), ref)
    _close(tops.outpruned_matmul_dx(torch.from_numpy(dyc),
                                    torch.from_numpy(w),
                                    torch.from_numpy(keep),
                                    block=block).numpy(), ref)


def _bpm_operands(rng, block, nb, kb, unsorted, M, N, x_compact):
    """x [M, K] (or the compact [M, kb*B] and its scatter into [M, K] for
    the reference), w [K, N], keep, and the gathered A [M, T], B [T, N]."""
    K = nb * block
    keep = _keep(rng, nb, kb, unsorted)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    if x_compact:
        xc = rng.standard_normal((M, kb * block)).astype(np.float32)
        x_full = np.zeros((M, nb, block), np.float32)
        x_full[:, keep] = xc.reshape(M, kb, block)
        x_full = x_full.reshape(M, K)
        a = xc
    else:
        x_full = xc = rng.standard_normal((M, K)).astype(np.float32)
        a = x_full.reshape(M, nb, block)[:, keep].reshape(M, kb * block)
    b = w.reshape(nb, block, N)[keep].reshape(kb * block, N)
    ref = jpk.block_pruned_matmul_2d(jnp.asarray(x_full), jnp.asarray(w),
                                     jnp.asarray(keep), block=block, tm=M if
                                     M <= 8 else 8, tn=16, interpret=True)
    return xc, w, keep, a, b, ref


@pytest.mark.parametrize("block,nb,kb,unsorted,M,N", CASES)
@pytest.mark.parametrize("x_compact", [False, True])
def test_block_pruned_tc_model_matches_jax(block, nb, kb, unsorted, M, N,
                                           x_compact, monkeypatch):
    """#2 above the decode kernel's rows: x[:, keep] @ w[keep] through the
    core's split 3xTF32 model (A and B read through the map, A not with
    x_compact), against block_pruned_matmul_2d; and the port's wrapper
    (its plain version on the CPU) against the same reference."""
    rng = np.random.default_rng(60 + block + nb + kb + M + x_compact)
    xc, w, keep, a, b, ref = _bpm_operands(rng, block, nb, kb, unsorted, M,
                                           N, x_compact)
    assert M > tops.BPM_DECODE_MAX_ROWS
    splits = _tc_splits(M, N, kb * block, monkeypatch)
    _close(_tc_model(a, b, splits), ref)
    if not x_compact:
        _close(tops.block_pruned_matmul(torch.from_numpy(xc),
                                        torch.from_numpy(w),
                                        torch.from_numpy(keep),
                                        block=block).numpy(), ref)


def _decode_model(a: np.ndarray, b: np.ndarray, splits: int) -> np.ndarray:
    """The decode kernel's f32 product of a [M <= 16, T] and b [T, N]:
    16-row chunks, each two 3xTF32 k-steps (lane tg's rows 4tg + 2q and
    4tg + 2q + 1 in step q); chunk c of a range on warp c % 8; each
    warp's chunks in order, the 8 warps summed in order, then the ranges
    in order."""
    T = a.shape[1]
    chunks = -(-T // tops.BPM_ROWS)
    per = -(-chunks // splits)
    steps = [np.array([4 * tg + 2 * q + d for tg in range(4) for d in (0, 1)])
             for q in (0, 1)]
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for lo in range(0, chunks, per):
        warps = np.zeros((tops.BPM_WARPS,) + out.shape, np.float32)
        for c in range(lo, min(chunks, lo + per)):
            for rows in steps:
                t = c * tops.BPM_ROWS + rows
                t = t[t < T]
                warps[(c - lo) % tops.BPM_WARPS] += _three_tf32(
                    np.ascontiguousarray(a[:, t]), b[t])
        out += warps.sum(axis=0, dtype=np.float32)
    return out


@pytest.mark.parametrize("block,nb,kb", [(8, 24, 7), (128, 3, 2),
                                          (128, 6, 5), (6, 12, 5)])
@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("x_compact", [False, True])
def test_block_pruned_decode_model_matches_jax(block, nb, kb, M, x_compact,
                                               monkeypatch):
    """#2 at the decode kernel's rows (M <= 16): its chunked, warp-ordered
    3xTF32 model, at the wrapper's range count, against
    block_pruned_matmul_2d; unsorted keep ids, block 6 (a lane's 4 rows
    cross a block), 8 and 128."""
    rng = np.random.default_rng(70 + block + nb + kb + M + x_compact)
    _, _, _, a, b, ref = _bpm_operands(rng, block, nb, kb, True, M, 16,
                                       x_compact)
    _sms(monkeypatch)
    splits = tops._bpm_decode_splits(M, 16, kb * block,
                                     torch.device("cpu", 0))
    _close(_decode_model(a, b, splits), ref)
    _close(_decode_model(a, b, 1), ref)
