"""The port's unfused GQA decode attention (kernel #7's wrapper) against the
JAX package's ``unfused_decode_attention``, on the CPU.

On CPU tensors the port's wrapper runs its plain PyTorch version; the JAX
wrapper runs its three Pallas kernels in interpret mode. Same inputs
(numpy, from a seed), float32, ``atol=2e-6`` — the reference's own
tolerance for this function (``tests/test_decode_attn.py``).

The reference pads the cache to its 128-row tile and computes every
padded row. A lane whose cur_pos is past the cache (the engine's invalid
lane, 2**30) attends those zero rows, so its output depends on the
padding wherever S % 128 != 0; the port has no padding. Such lanes are
compared only at S % 128 == 0 (the contract is recorded in ROADMAP.md,
beside the MLA one). ``tests/test_torch_cuda.py`` holds the CUDA kernel
against the same plain version on a GPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

ATOL = 2e-6
INVALID = 2 ** 30


def _case(seed, B, Hq, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, 1, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32))


def _both(q, k, v, cur, window=0):
    ref = np.asarray(jops.unfused_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        cur_pos=jnp.asarray(cur), window=window))
    got = tops.unfused_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        cur_pos=torch.from_numpy(cur), window=window)
    return ref, got.numpy()


@pytest.mark.parametrize("window", [0, 50])
def test_unfused_decode_attention_matches_jax(window):
    # S = 256 is a whole number of the reference's tiles, so every lane,
    # the invalid one included, is independent of its padding
    S = 256
    q, k, v = _case(31 + window, 5, 4, 2, S, 64)
    cur = np.asarray([0, 127, 128, INVALID, S - 1], np.int32)
    ref, got = _both(q, k, v, cur, window)
    assert got.shape == (5, 4, 1, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_unfused_decode_attention_valid_lanes_at_ragged_cache():
    # the reference test's size (S = 160, padded to 256 there): the valid
    # lanes never attend a padded row; the invalid lane (last) does in the
    # reference and is excluded here
    S = 160
    q, k, v = _case(17, 5, 8, 2, S, 64)
    cur = np.asarray([0, 10, 100, S - 1, INVALID], np.int32)
    ref, got = _both(q, k, v, cur)
    np.testing.assert_allclose(got[:4], ref[:4], rtol=0, atol=ATOL)
    assert np.isfinite(got).all()


def test_unfused_all_masked_lane_is_uniform_like_jax():
    # cur_pos < 0 attends no row; NEG_INF is finite in both packages, so
    # the softmax is uniform over the S rows: the mean of V (S = 128, no
    # padding in the reference)
    S = 128
    q, k, v = _case(5, 2, 4, 2, S, 64)
    cur = np.asarray([-1, 40], np.int32)
    ref, got = _both(q, k, v, cur)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    mean_v = v[0].mean(axis=1)                       # [Hkv, D]
    np.testing.assert_allclose(got[0, :, 0].reshape(2, 2, 64),
                               np.repeat(mean_v[:, None], 2, 1),
                               rtol=0, atol=ATOL)
    fused = tops.fused_decode_attention(
        *[torch.from_numpy(a) for a in (q, k, v)],
        cur_pos=torch.from_numpy(cur)).numpy()
    assert np.all(fused[0] == 0.0)                   # the fused contract


def _message(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


@pytest.mark.parametrize("case", ["two_tokens", "gqa_ratio", "cache_batch",
                                  "cur_pos_shape"])
def test_unfused_decode_attention_errors_match_jax(case):
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
    j = _message(lambda: jops.unfused_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
        cur_pos=jnp.asarray(cur)))
    t = _message(lambda: tops.unfused_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
        cur_pos=torch.from_numpy(cur)))
    assert t.replace("torch.Size", "") == j.replace("torch.Size", "")


def test_unfused_cpu_tensors_never_move_a_launch_counter():
    tops.reset_launch_counts()
    q, k, v = _case(3, 2, 4, 2, 32, 8)
    tops.unfused_decode_attention(
        *[torch.from_numpy(a) for a in (q, k, v)],
        cur_pos=torch.tensor([3, INVALID]))
    assert tops.unfused_decode_attention in tops.KERNEL_WRAPPERS
    assert all(n == 0 for n in tops.launch_counts().values())
