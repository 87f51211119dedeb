"""#9 (``pruned_matmul_dw``) and #12 (``outpruned_matmul_dw``) on the
tensor-core core of ``csrc/pruned_grad.cu``, as far as the CPU can check
them.

Both read their A operand along its rows (A(i, t) is x[t, col(i)] for #9
and x[t, i] for #12), so the core stages A as [TC_DEPTH][rows + pad],
filled by 16-byte copies along i. The kernel runs only on the card
(``tests/test_torch_cuda.py``). Here: the host's choice of contraction
splits at the ViT-1B train shapes, the loader's constants read from the
kernel source, and the numpy model of the core's f32 arithmetic (stages
of ``TC_DEPTH``, contiguous ranges of stages summed in split order, each
in the 3xTF32 form with the mask split; ``test_torch_tc_core``) held,
with the kept rows or columns scattered through ``order``, against the
JAX package's Pallas kernels in interpret mode. Tolerance as the other
backward-family tests: max |err| <= 1e-5 * max |ref|. Inputs from fixed
numpy seeds.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import pruned_matmul as jpk
from repro_torch.kernels import ops as tops
from test_torch_tc_core import H100_SMS, SOURCE, _close, _tc_model

torch.set_num_threads(1)


def _dw_splits(rows, cols, depth, monkeypatch, asked=None):
    monkeypatch.setattr(tops, "_num_sms", lambda index: H100_SMS)
    splits, partial = tops._dw_partials(rows, cols, depth,
                                        torch.device("cpu", 0), asked)
    assert tuple(partial.shape) == (splits, rows, cols)
    assert partial.dtype == torch.float32
    return splits


# (kernel, kept rows, kept cols, contraction M, splits): the ViT-1B train
# shapes at tp 4 (M = 520, block 8) with the straggler's keep counts
TRAIN = [
    ("#9 wq: x[520,2048]^T . dy[520,512], keep 32/256", 256, 512, 520, 9),
    ("#9 wo: x[520,512]^T . dy[520,2048], keep 8/64", 64, 2048, 520, 9),
    ("#9 FFN dW_down, x_compact keep 30/256", 240, 2048, 520, 4),
    ("#12 FFN dW_up: x[520,2048]^T . dpre[520,240]", 2048, 240, 520, 4),
]


@pytest.mark.parametrize("what,rows,cols,depth,want", TRAIN,
                         ids=[t[0].split(":")[0].split(",")[0]
                              for t in TRAIN])
def test_split_count_at_the_train_shapes(what, rows, cols, depth, want,
                                         monkeypatch):
    """About three blocks per SM over the kept tiles (13 ranges asked for
    at 32 tiles, 4 at 128), counted as the ranges of whole stages that
    the 17 stages of 32 rows make: the kernel's grid.z."""
    splits = _dw_splits(rows, cols, depth, monkeypatch)
    assert splits == want
    tiles = -(-rows // tops.TC_TILE) * -(-cols // tops.TC_TILE)
    stages = -(-depth // tops.TC_DEPTH)
    asked = min(stages, -(-3 * H100_SMS // tiles))
    per = -(-stages // asked)
    assert splits == -(-stages // per) and (splits - 1) * per < stages


@pytest.mark.parametrize("depth,asked,want", [
    (tops.TC_DEPTH, None, 1),     # one stage: one range
    (520, 1, 1),
    (520, 17, 17),
    (520, 16, 9),                 # 9 ranges of 2 stages
    (520, 40, 17),                # one range per stage at most
    (2080, None, 13),             # 65 stages at 32 tiles: 13 of 5
])
def test_split_count_rounds_to_whole_ranges(depth, asked, want,
                                            monkeypatch):
    """The count asked for (or chosen) becomes the number of ranges of
    whole stages it makes, the kernel's grid.z, so no partial goes
    unwritten."""
    assert _dw_splits(256, 512, depth, monkeypatch, asked) == want


def test_a_loader_constants_match_the_kernel_source():
    """A along i sits in [kTcDepth][kTcRows + pad]: every row 16-byte
    aligned, the f32 fragment's scalar loads (lane = 4 g + tg reads t =
    k + tg, column g) on 32 distinct banks, the bf16 ldmatrix.trans rows
    (8 rows of 16 bytes) on 8 distinct 4-bank groups; at block 8 a
    16-byte copy never crosses a block (two copies per block in f32, one
    in bf16)."""
    src = SOURCE.read_text()
    pad = int(re.search(r"kLdI = kTcRows \+ (\d+);", src)[1])
    rows = int(re.search(r"constexpr int kTcRows = (\d+);", src)[1])
    assert rows == tops.TC_TILE
    ld = rows + pad
    for size in (4, 2):                      # f32, bf16
        assert ld * size % 16 == 0
    banks = {((tg * ld) + g) % 32 for g in range(8) for tg in range(4)}
    assert len(banks) == 32
    groups = {(r * ld * 2 // 4) % 32 // 4 for r in range(8)}
    assert len(groups) == 8
    for size, copies in ((4, 2), (2, 1)):
        vec = 16 // size
        assert 8 % vec == 0 and 8 // vec == copies


# (block, nb, kb, unsorted, M, width): the Pallas kernels take tile
# multiples (8 rows, 16 wide); M = 40 and 136 end mid-stage
CASES = [
    (8, 6, 4, False, 72, 32),
    (8, 24, 7, True, 40, 48),
    (128, 3, 2, True, 40, 32),
    (128, 4, 1, False, 136, 16),
]


def _keep_order(rng, nb, kb, unsorted):
    keep = rng.choice(nb, size=kb, replace=False).astype(np.int32)
    keep = keep if unsorted else np.sort(keep)
    return keep, np.array(jops._inverse_order(jnp.asarray(keep), nb))


@pytest.mark.parametrize("block,nb,kb,unsorted,M,N", CASES)
@pytest.mark.parametrize("x_compact", [False, True])
def test_pruned_dw_model_matches_jax(block, nb, kb, unsorted, M, N,
                                     x_compact, monkeypatch):
    """#9: the kept rows x[:, order[k]]^T . dy through the core's split
    3xTF32 model, scattered to rows order[k] with zeros elsewhere, and
    the port's plain version, against pruned_matmul_dw_2d."""
    rng = np.random.default_rng(30 + block + nb + kb + M + x_compact)
    x = rng.standard_normal(
        (M, (kb if x_compact else nb) * block)).astype(np.float32)
    dy = (rng.standard_normal((M, N)) * 0.1).astype(np.float32)
    _, order = _keep_order(rng, nb, kb, unsorted)
    ref = jpk.pruned_matmul_dw_2d(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(order), kb=kb,
        block=block, tm=8, tn=16, x_compact=x_compact, interpret=True)
    a = x[:, :kb * block] if x_compact else \
        x.reshape(M, nb, block)[:, order[:kb]].reshape(M, kb * block)
    splits = _dw_splits(kb * block, N, M, monkeypatch)
    kept = _tc_model(np.ascontiguousarray(a.T), dy, splits)
    got = np.zeros((nb, block, N), np.float32)
    got[order[:kb]] = kept.reshape(kb, block, N)
    _close(got.reshape(nb * block, N), ref)
    _close(tops.pruned_matmul_dw(torch.from_numpy(x), torch.from_numpy(dy),
                                 torch.from_numpy(order), kb=kb, block=block,
                                 x_compact=x_compact).numpy(), ref)


@pytest.mark.parametrize("block,nb,kb,unsorted,M,K", CASES)
def test_outpruned_dw_model_matches_jax(block, nb, kb, unsorted, M, K,
                                        monkeypatch):
    """#12: x^T . dyc through the core's split 3xTF32 model, its column
    blocks scattered to order[k] with zeros elsewhere, and the port's
    plain version, against outpruned_matmul_dw_2d."""
    rng = np.random.default_rng(40 + block + nb + kb + M)
    x = rng.standard_normal((M, K)).astype(np.float32)
    dyc = (rng.standard_normal((M, kb * block)) * 0.1).astype(np.float32)
    _, order = _keep_order(rng, nb, kb, unsorted)
    ref = jpk.outpruned_matmul_dw_2d(
        jnp.asarray(x), jnp.asarray(dyc), jnp.asarray(order), kb=kb,
        block=block, tm=8, tk=16, interpret=True)
    splits = _dw_splits(K, kb * block, M, monkeypatch)
    kept = _tc_model(np.ascontiguousarray(x.T), dyc, splits)
    got = np.zeros((K, nb, block), np.float32)
    got[:, order[:kb]] = kept.reshape(K, kb, block)
    _close(got.reshape(K, nb * block), ref)
    _close(tops.outpruned_matmul_dw(torch.from_numpy(x),
                                    torch.from_numpy(dyc),
                                    torch.from_numpy(order), kb=kb,
                                    block=block).numpy(), ref)
