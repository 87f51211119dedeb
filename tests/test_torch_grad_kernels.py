"""The backward family of the pruned products (TPU kernels #8-#12) and the
VJPs built on it, against the JAX package.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the JAX side runs the Pallas kernels in interpret mode
(``pruned_matmul.*_2d(..., interpret=True)``) and ``jax.vjp`` of the
reference's custom-VJP wrappers. Same inputs (numpy, from a seed),
float32; tolerance max |err| <= 1e-5 * max |ref| (both accumulate in f32
and only the summation order differs). Block 8 (the trainer's) and block
128 (the serving shapes), the compact modes, and an unsorted keep list,
which pins that compact slot k pairs with block keep_idx[k].
``tests/test_torch_cuda.py`` holds the CUDA kernels against the same
plain versions on a GPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import pruned_matmul as jpk
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

REL = 1e-5


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    assert err <= REL * float(np.abs(ref).max()), err


def _arr(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _keep(rng, nb, kb, unsorted):
    keep = rng.choice(nb, size=kb, replace=False).astype(np.int32)
    return keep if unsorted else np.sort(keep)


def _order(keep, nb):
    return np.asarray(jops._inverse_order(jnp.asarray(keep), nb))


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = [  # (block, nb, kb, unsorted)
    (8, 6, 4, False),
    (8, 6, 3, True),
    (128, 3, 2, True),
]


def test_inverse_order_matches_jax():
    rng = np.random.default_rng(0)
    for nb, kb in ((6, 4), (9, 1), (5, 5)):
        keep = _keep(rng, nb, kb, True)
        got = tops.inverse_order(_t(keep), nb).numpy()
        np.testing.assert_array_equal(got, _order(keep, nb))


@pytest.mark.parametrize("block,nb,kb,unsorted", CASES)
@pytest.mark.parametrize("compact_out", [False, True])
def test_pruned_matmul_dx_matches_jax(block, nb, kb, unsorted, compact_out):
    rng = np.random.default_rng(block + nb + kb + compact_out)
    M, N = 16, 32
    dy, w = _arr(rng, (M, N)), _arr(rng, (nb * block, N))
    keep = _keep(rng, nb, kb, unsorted)
    order = keep if compact_out else _order(keep, nb)
    ref = jpk.pruned_matmul_dx_2d(
        jnp.asarray(dy), jnp.asarray(w), jnp.asarray(order), kb=kb,
        block=block, tm=8, tn=16, compact_out=compact_out, interpret=True)
    got = tops.pruned_matmul_dx(_t(dy), _t(w), _t(order), kb=kb,
                                block=block, compact_out=compact_out)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("block,nb,kb,unsorted", CASES)
@pytest.mark.parametrize("x_compact", [False, True])
def test_pruned_matmul_dw_matches_jax(block, nb, kb, unsorted, x_compact):
    rng = np.random.default_rng(10 + block + nb + kb + x_compact)
    M, N = 16, 32
    x = _arr(rng, (M, (kb if x_compact else nb) * block))
    dy = _arr(rng, (M, N))
    keep = _keep(rng, nb, kb, unsorted)
    order = _order(keep, nb)
    ref = jpk.pruned_matmul_dw_2d(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(order), kb=kb,
        block=block, tm=8, tn=16, x_compact=x_compact, interpret=True)
    got = tops.pruned_matmul_dw(_t(x), _t(dy), _t(order), kb=kb,
                                block=block, x_compact=x_compact)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("block,nb,kb,unsorted", CASES)
def test_outpruned_family_matches_jax(block, nb, kb, unsorted):
    """#10 (compact forward), #11 (dense dx) and #12 (scattered dW)."""
    rng = np.random.default_rng(20 + block + nb + kb)
    M, K = 16, 32
    x, w = _arr(rng, (M, K)), _arr(rng, (K, nb * block))
    dyc = _arr(rng, (M, kb * block))
    keep = _keep(rng, nb, kb, unsorted)
    order = _order(keep, nb)
    ref = jpk.outpruned_matmul_2d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(keep), block=block, tm=8,
                                  tk=16, interpret=True)
    _close(tops.outpruned_matmul(_t(x), _t(w), _t(keep),
                                 block=block).numpy(), ref)
    ref = jpk.outpruned_matmul_dx_2d(jnp.asarray(dyc), jnp.asarray(w),
                                     jnp.asarray(keep), block=block, tm=8,
                                     tk=16, interpret=True)
    _close(tops.outpruned_matmul_dx(_t(dyc), _t(w), _t(keep),
                                    block=block).numpy(), ref)
    ref = jpk.outpruned_matmul_dw_2d(jnp.asarray(x), jnp.asarray(dyc),
                                     jnp.asarray(order), kb=kb, block=block,
                                     tm=8, tk=16, interpret=True)
    _close(tops.outpruned_matmul_dw(_t(x), _t(dyc), _t(order), kb=kb,
                                    block=block).numpy(), ref)


def test_backward_wrappers_reject_bad_shapes():
    dy, w = torch.zeros(4, 8), torch.zeros(24, 8)
    order = torch.arange(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="pruned_matmul_dx"):
        tops.pruned_matmul_dx(dy, torch.zeros(24, 7), order, kb=2, block=8)
    with pytest.raises(ValueError, match="kb=4"):
        tops.pruned_matmul_dx(dy, w, order, kb=4, block=8)
    with pytest.raises(ValueError, match="pruned_matmul_dw"):
        tops.pruned_matmul_dw(torch.zeros(4, 16), dy, order, kb=2, block=8)
    with pytest.raises(ValueError, match="outpruned_matmul_dx"):
        tops.outpruned_matmul_dx(torch.zeros(4, 8), w.t().contiguous(),
                                 order[:2], block=8)


# ---------------------------------------------------------------------------
# the autograd Functions against jax.vjp of the reference custom VJPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block,nb,kb,unsorted", CASES)
def test_block_pruned_matmul_vjp_matches_jax(block, nb, kb, unsorted):
    rng = np.random.default_rng(30 + block + kb)
    x = _arr(rng, (2, 5, nb * block))
    w = _arr(rng, (nb * block, 24))
    dy = _arr(rng, (2, 5, 24))
    keep = _keep(rng, nb, kb, unsorted)
    y_ref, vjp = jax.vjp(
        lambda a, b: jops.block_pruned_matmul(a, b, jnp.asarray(keep), block),
        jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(dy))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = tops.block_pruned_matmul(xt, wt, _t(keep), block=block)
    y.backward(_t(dy))
    _close(y.detach().numpy(), y_ref)
    _close(xt.grad.numpy(), dx_ref)
    _close(wt.grad.numpy(), dw_ref)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("block,nb,kb,unsorted", CASES[1:])
def test_fused_pruned_ffn_vjp_matches_jax(gated, block, nb, kb, unsorted):
    rng = np.random.default_rng(40 + block + kb + gated)
    M, K, D2 = 8, 16, 24
    H = nb * block
    x = _arr(rng, (M, K))
    w_up, w_down = _arr(rng, (K, H), 0.3), _arr(rng, (H, D2), 0.3)
    w_gate = _arr(rng, (K, H), 0.3) if gated else None
    dy = _arr(rng, (M, D2))
    keep = _keep(rng, nb, kb, unsorted)
    j_act, t_act = (jax.nn.silu, tops.silu) if gated else (jax.nn.gelu,
                                                          tops.gelu)
    args = [jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down)] + (
        [jnp.asarray(w_gate)] if gated else [])

    def f(a, u, d, *g):
        return jops.fused_pruned_ffn(a, u, d, jnp.asarray(keep),
                                     g[0] if g else None, j_act, block)
    y_ref, vjp = jax.vjp(f, *args)
    grads_ref = vjp(jnp.asarray(dy))
    leaves = [_t(a).requires_grad_() for a in
              [x, w_up, w_down] + ([w_gate] if gated else [])]
    y = tops.fused_pruned_ffn(leaves[0], leaves[1], leaves[2], _t(keep),
                              leaves[3] if gated else None, t_act, block)
    y.backward(_t(dy))
    _close(y.detach().numpy(), y_ref)
    for leaf, g_ref in zip(leaves, grads_ref):
        _close(leaf.grad.numpy(), g_ref)
