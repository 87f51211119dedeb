"""The tensor-core core of #10 (``outpruned_matmul``) and #8
(``pruned_matmul_dx``) in ``csrc/pruned_grad.cu``, as far as the CPU can
check it.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here: the host's choice of contraction splits, the tile constants the
wrapper shares with the kernel source, and a numpy model of the kernel's
arithmetic held against the JAX package's Pallas kernels in interpret
mode. The model repeats what the kernel does to an f32 product: the
contraction cut into ``TC_DEPTH``-deep stages and split into contiguous
ranges of stages, each range's partial product in the 3xTF32 form (each
operand split into its top 10 mantissa bits and a remainder that the
tensor core truncates to TF32 too; lo*hi + hi*lo + hi*hi), the partials
summed in split order. Tolerance as the other backward-family tests:
max |err| <= 1e-5 * max |ref|. Inputs from fixed numpy seeds.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import pruned_matmul as jpk
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

REL = 1e-5
H100_SMS = 132
SOURCE = (Path(tops.__file__).with_name("csrc") / "pruned_grad.cu")


def _tf32(x: np.ndarray) -> np.ndarray:
    """The tensor core's reading of f32 as TF32: the low 13 bits dropped."""
    return (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _three_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the kernel's 3xTF32 mma passes, f32 accumulation."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tc_model(a: np.ndarray, b: np.ndarray, splits: int) -> np.ndarray:
    """The kernel's product of a [I, T] and b [T, J]: ranges of
    ``TC_DEPTH``-deep stages, one f32 partial each, summed in order."""
    steps = -(-a.shape[1] // tops.TC_DEPTH)
    per = -(-steps // splits)
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for lo in range(0, steps, per):
        t0, t1 = lo * tops.TC_DEPTH, (lo + per) * tops.TC_DEPTH
        out += _three_tf32(a[:, t0:t1], b[t0:t1])
    return out


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= REL * float(np.abs(ref).max()), err


def _splits(rows, cols, depth, monkeypatch):
    monkeypatch.setattr(tops, "_num_sms", lambda index: H100_SMS)
    splits, partial = tops._tc_partials(rows, cols, depth,
                                        torch.device("cpu", 0))
    assert tuple(partial.shape) == (splits, rows, cols)
    assert partial.dtype == torch.float32
    return splits


def test_tile_constants_match_the_kernel_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kTcRows") == const("kTcCols") == tops.TC_TILE
    assert const("kTcDepth") == tops.TC_DEPTH


@pytest.mark.parametrize("rows,cols,depth,want", [
    (520, 240, 2048, 8),     # #10 FFN recompute / #8 FFN dh: 36 tiles
    (520, 256, 512, 8),      # #8 at wq: 16 stages
    (520, 64, 2048, 30),     # #8 at wo (8 kept blocks of 8): 9 tiles
    (16, 8, 2048, 64),       # one tile: every stage its own split
    (70, 384, 96, 3),        # 3 stages bound the split count
])
def test_split_count_fills_the_card(rows, cols, depth, want, monkeypatch):
    """About two blocks per SM, never more splits than stages."""
    splits = _splits(rows, cols, depth, monkeypatch)
    assert splits == want
    stages = -(-depth // tops.TC_DEPTH)
    tiles = -(-rows // tops.TC_TILE) * -(-cols // tops.TC_TILE)
    assert 1 <= splits <= stages
    assert splits == stages or (splits - 1) * tiles < 2 * H100_SMS


def test_three_tf32_keeps_f32_accuracy():
    """hi + lo is x exactly; over a contraction of 2048 one TF32 pass
    misses the f32 tolerance of the card checks (1e-4 * max |ref|), the
    three passes meet it a hundred times over."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 2048)).astype(np.float32)
    b = (rng.standard_normal((2048, 64)) * 0.02).astype(np.float32)
    hi = _tf32(a)
    assert np.array_equal(hi + (a - hi), a)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = float(np.abs(ref).max())
    one = _tf32(a).astype(np.float64) @ _tf32(b).astype(np.float64)
    assert float(np.abs(one - ref).max()) > 1e-4 * scale
    three = _three_tf32(a, b).astype(np.float64)
    assert float(np.abs(three - ref).max()) <= 1e-6 * scale


# (block, nb, kb, unsorted, M, contraction); the Pallas kernels take
# tile multiples (8 rows, 16 deep), the contractions end mid-stage
CASES = [
    (8, 6, 4, False, 72, 208),
    (8, 24, 7, True, 136, 96),
    (128, 3, 2, True, 40, 112),
]


@pytest.mark.parametrize("block,nb,kb,unsorted,M,T", CASES)
def test_outpruned_model_matches_jax(block, nb, kb, unsorted, M, T,
                                     monkeypatch):
    """#10: yc = x @ w[:, keep] through the kernel's split 3xTF32 model
    and the port's plain version, against outpruned_matmul_2d."""
    rng = np.random.default_rng(block + nb + kb + M)
    x = rng.standard_normal((M, T)).astype(np.float32)
    w = (rng.standard_normal((T, nb * block)) * 0.1).astype(np.float32)
    keep = rng.choice(nb, size=kb, replace=False).astype(np.int32)
    keep = keep if unsorted else np.sort(keep)
    ref = jpk.outpruned_matmul_2d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(keep), block=block, tm=8,
                                  tk=16, interpret=True)
    cols = w.reshape(T, nb, block)[:, keep].reshape(T, kb * block)
    splits = _splits(M, kb * block, T, monkeypatch)
    _close(_tc_model(x, cols, splits), ref)
    _close(tops.outpruned_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(keep),
                                 block=block).numpy(), ref)


@pytest.mark.parametrize("block,nb,kb,unsorted,M,T", CASES)
@pytest.mark.parametrize("compact_out", [False, True])
def test_pruned_dx_model_matches_jax(block, nb, kb, unsorted, M, T,
                                     compact_out, monkeypatch):
    """#8: the kept slots through the kernel's split 3xTF32 model, then
    the second pass's placement (compact, or scattered through ``order``
    with zeros at the pruned blocks), against pruned_matmul_dx_2d."""
    rng = np.random.default_rng(10 + block + nb + kb + M + compact_out)
    dy = rng.standard_normal((M, T)).astype(np.float32)
    w = (rng.standard_normal((nb * block, T)) * 0.1).astype(np.float32)
    keep = rng.choice(nb, size=kb, replace=False).astype(np.int32)
    keep = keep if unsorted else np.sort(keep)
    order = keep if compact_out else np.asarray(
        jops._inverse_order(jnp.asarray(keep), nb))
    ref = jpk.pruned_matmul_dx_2d(
        jnp.asarray(dy), jnp.asarray(w), jnp.asarray(order), kb=kb,
        block=block, tm=8, tn=16, compact_out=compact_out, interpret=True)
    rows = w.reshape(nb, block, T)[order[:kb]].reshape(kb * block, T)
    splits = _splits(M, kb * block, T, monkeypatch)
    kept = _tc_model(dy, np.ascontiguousarray(rows.T), splits)
    if compact_out:
        got = kept
    else:
        got = np.zeros((M, nb, block), np.float32)
        got[:, order[:kb]] = kept.reshape(M, kb, block)
        got = got.reshape(M, nb * block)
    _close(got, ref)
    _close(tops.pruned_matmul_dx(torch.from_numpy(dy), torch.from_numpy(w),
                                 torch.from_numpy(order), kb=kb, block=block,
                                 compact_out=compact_out).numpy(), ref)
