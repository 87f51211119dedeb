"""The port's kernel wrappers against the JAX package's Pallas wrappers.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX wrappers run their Pallas kernels in interpret mode. Same inputs
(numpy, from a seed), float32, rtol = atol = 1e-5 (both accumulate in
f32; only the summation order differs). ``tests/test_torch_cuda.py``
holds the CUDA kernels against the same plain versions on a GPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _arr(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _keep(rng, nb, kb):
    return np.sort(rng.choice(nb, size=kb, replace=False)).astype(np.int32)


# ---------------------------------------------------------------------------
# plain versions against the JAX wrappers (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N,block,kb", [
    (5, 64, 48, 8, 3),        # the engine's default block (8), ragged M/N
    (8, 256, 130, 32, 5),
    (3, 128, 64, 128, 1),     # one kept block of 128
])
def test_block_pruned_matmul_plain_matches_jax(M, K, N, block, kb):
    rng = np.random.default_rng(M * 1000 + K + N)
    x, w = _arr(rng, (M, K)), _arr(rng, (K, N))
    keep = _keep(rng, K // block, kb)
    ref = np.asarray(jops.block_pruned_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(keep), block))
    got = tops.block_pruned_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(keep), block=block)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_block_pruned_matmul_keeps_leading_dims():
    rng = np.random.default_rng(7)
    x, w = _arr(rng, (2, 3, 64)), _arr(rng, (64, 16))
    keep = _keep(rng, 8, 4)
    ref = np.asarray(jops.block_pruned_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(keep), 8))
    got = tops.block_pruned_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(keep), block=8)
    assert got.shape == (2, 3, 16)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("block,kb", [(8, 5), (16, 2)])
def test_fused_pruned_ffn_plain_matches_jax(gated, block, kb):
    import jax
    rng = np.random.default_rng(11 + block + kb + gated)
    M, K, H, D2 = 6, 32, 64, 24
    x = _arr(rng, (M, K))
    w_up, w_down = _arr(rng, (K, H), 0.3), _arr(rng, (H, D2), 0.3)
    w_gate = _arr(rng, (K, H), 0.3) if gated else None
    keep = _keep(rng, H // block, kb)
    j_act, t_act = (jax.nn.silu, tops.silu) if gated else (jax.nn.gelu,
                                                          tops.gelu)
    ref = np.asarray(jops.fused_pruned_ffn(
        jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down),
        jnp.asarray(keep), None if w_gate is None else jnp.asarray(w_gate),
        j_act, block))
    got = tops.fused_pruned_ffn(
        torch.from_numpy(x), torch.from_numpy(w_up), torch.from_numpy(w_down),
        torch.from_numpy(keep),
        None if w_gate is None else torch.from_numpy(w_gate), t_act, block)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("window", [0, 50])
def test_fused_decode_attention_plain_matches_jax(window):
    rng = np.random.default_rng(23 + window)
    B, Hq, Hkv, S, D = 5, 4, 2, 256, 64
    q = _arr(rng, (B, Hq, 1, D))
    k, v = _arr(rng, (B, Hkv, S, D)), _arr(rng, (B, Hkv, S, D))
    # ragged: the first row, the last row of a 128 tile, the first row of
    # the next tile, the engine's invalid lane, the cache's last row
    cur = np.asarray([0, 127, 128, 2 ** 30, S - 1], np.int32)
    ref = np.asarray(jops.fused_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        cur_pos=jnp.asarray(cur), window=window))
    got = tops.fused_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        cur_pos=torch.from_numpy(cur), window=window)
    assert got.shape == (B, Hq, 1, D)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# ---------------------------------------------------------------------------
# readable errors: the same checks and messages as the JAX wrappers
# ---------------------------------------------------------------------------


def _message(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    # the hint names each package's own module; dtypes print differently
    return (str(ei.value).replace("repro_torch.", "repro.")
            .replace("torch.", ""))


@pytest.mark.parametrize("case", [
    "zero_block", "k_mismatch", "k_not_multiple", "keep_2d", "keep_empty",
    "keep_too_many", "keep_float"])
def test_block_pruned_matmul_errors_match_jax(case):
    K, N, block = 64, 16, 8
    xs, ws = (4, K), (K, N)
    keep = np.arange(3, dtype=np.int32)
    if case == "zero_block":
        block = 0
    elif case == "k_mismatch":
        ws = (K + 8, N)
    elif case == "k_not_multiple":
        xs, ws, block = (4, 60), (60, N), 8
    elif case == "keep_2d":
        keep = np.zeros((2, 2), np.int32)
    elif case == "keep_empty":
        keep = np.zeros((0,), np.int32)
    elif case == "keep_too_many":
        keep = np.arange(9, dtype=np.int32)
    elif case == "keep_float":
        keep = np.arange(3, dtype=np.float32)
    x, w = np.ones(xs, np.float32), np.ones(ws, np.float32)
    j = _message(lambda: jops.block_pruned_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(keep), block))
    t = _message(lambda: tops.block_pruned_matmul(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(keep),
        block=block))
    assert t == j


def test_fused_pruned_ffn_errors_match_jax():
    x = np.ones((2, 16), np.float32)
    w_up, w_down = np.ones((16, 32), np.float32), np.ones((24, 8), np.float32)
    keep = np.arange(2, dtype=np.int32)
    import jax
    j = _message(lambda: jops.fused_pruned_ffn(
        jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down),
        jnp.asarray(keep), None, jax.nn.silu, 8))
    t = _message(lambda: tops.fused_pruned_ffn(
        torch.from_numpy(x), torch.from_numpy(w_up), torch.from_numpy(w_down),
        torch.from_numpy(keep), None, tops.silu, 8))
    assert t == j


@pytest.mark.parametrize("case", ["two_tokens", "gqa_ratio", "cache_batch",
                                  "cur_pos_shape"])
def test_fused_decode_attention_errors_match_jax(case):
    B, Hq, Hkv, S, D = 2, 4, 2, 16, 8
    qs, ks, cs = (B, Hq, 1, D), (B, Hkv, S, D), (B,)
    if case == "two_tokens":
        qs = (B, Hq, 2, D)
    elif case == "gqa_ratio":
        ks = (B, 3, S, D)
    elif case == "cache_batch":
        ks = (B + 1, Hkv, S, D)
    elif case == "cur_pos_shape":
        cs = (B + 1,)
    q, k = np.ones(qs, np.float32), np.ones(ks, np.float32)
    cur = np.zeros(cs, np.int32)
    j = _message(lambda: jops.fused_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
        cur_pos=jnp.asarray(cur)))
    t = _message(lambda: tops.fused_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
        cur_pos=torch.from_numpy(cur)))
    assert t == j


def test_cpu_tensors_never_move_a_launch_counter():
    tops.reset_launch_counts()
    rng = np.random.default_rng(3)
    x, w = torch.from_numpy(_arr(rng, (4, 64))), torch.from_numpy(
        _arr(rng, (64, 64)))
    keep = torch.tensor([1, 4], dtype=torch.int32)
    w.requires_grad_()
    # the backward passes run the five backward wrappers' plain versions
    tops.block_pruned_matmul(x, w, keep, block=8).sum().backward()
    tops.fused_pruned_ffn(x, w, w, keep, w, tops.silu, 8).sum().backward()
    q = torch.from_numpy(_arr(rng, (2, 4, 1, 8)))
    kv = torch.from_numpy(_arr(rng, (2, 2, 16, 8)))
    tops.fused_decode_attention(q, kv, kv,
                                cur_pos=torch.tensor([3, 2 ** 30]))
    pool = torch.from_numpy(_arr(rng, (5, 2, 8, 8)))
    pages = torch.tensor([[0, 3], [4, -1]], dtype=torch.int32)
    cur = torch.tensor([9, 2 ** 30])
    tops.fused_paged_decode_attention(q, pool, pool, pages=pages,
                                      cur_pos=cur)
    qa, qr = (torch.from_numpy(_arr(rng, (2, 3, 16))),
              torch.from_numpy(_arr(rng, (2, 3, 4))))
    tops.fused_mla_decode_attention(
        qa, qr, torch.from_numpy(_arr(rng, (2, 16, 16))),
        torch.from_numpy(_arr(rng, (2, 16, 4))), cur_pos=cur,
        head_dim_for_scale=12)
    tops.fused_paged_mla_decode_attention(
        qa, qr, torch.from_numpy(_arr(rng, (5, 8, 16))),
        torch.from_numpy(_arr(rng, (5, 8, 4))), pages=pages, cur_pos=cur,
        head_dim_for_scale=12)
    tops.unfused_decode_attention(q, kv, kv,
                                  cur_pos=torch.tensor([3, 2 ** 30]))
    counts = tops.launch_counts()
    assert set(counts) == {"block_pruned_matmul", "fused_pruned_ffn",
                           "fused_decode_attention", "pruned_matmul_dx",
                           "pruned_matmul_dw", "outpruned_matmul",
                           "outpruned_matmul_dx", "outpruned_matmul_dw",
                           "fused_paged_decode_attention",
                           "fused_mla_decode_attention",
                           "fused_paged_mla_decode_attention",
                           "unfused_decode_attention"}
    assert set(counts.values()) == {0}
