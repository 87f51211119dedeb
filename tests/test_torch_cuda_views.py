"""Kernel wrappers fed strided views on the card.

A tensor-parallel rank computes on views of the global weights (a
column shard is strided), and its activations can be views too, so a
wrapper often makes more than one contiguous copy for one launch. Each
copy must stay alive until the kernel has read it: a copy whose pointer
is taken and then dropped returns its memory to the caching allocator,
and the next copy of the same size would be written over it before the
launch. Here every operand of the backward family is a strided view of
one size, and the result must equal the plain version's on the same
views.

These tests carry the ``cuda`` marker and skip without a CUDA device:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_views.py
"""
import pytest
import torch

from repro_torch.kernels import ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _strided(shape, g, dev):
    """A [rows, cols] view with a row stride twice its width."""
    rows, cols = shape
    return torch.randn((rows, 2 * cols), generator=g, device=dev)[:, :cols]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["pruned_matmul_dx", "pruned_matmul_dw",
                                   "outpruned_matmul",
                                   "outpruned_matmul_dx",
                                   "outpruned_matmul_dw"])
def test_two_strided_operands_of_one_size(cuda_device, which):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, block = 256, 16
    a, b = _strided((n, n), g, cuda_device), _strided((n, n), g, cuda_device)
    assert not a.is_contiguous() and not b.is_contiguous()
    nb = n // block
    order = torch.randperm(nb, generator=torch.Generator().manual_seed(1)
                           ).to(torch.int32).to(cuda_device)
    kb = nb // 2
    keep = torch.sort(order[:kb]).values
    fn = getattr(ops, which)
    if which == "pruned_matmul_dx":
        got, ref = (fn(a, b, order, kb=kb, block=block),
                    ops.pruned_matmul_dx_plain(a, b, order, kb, block,
                                               False))
    elif which == "pruned_matmul_dw":
        got, ref = (fn(a, b, order, kb=kb, block=block),
                    ops.pruned_matmul_dw_plain(a, b, order, kb, block,
                                               False))
    elif which == "outpruned_matmul":
        got, ref = (fn(a, b, keep, block=block),
                    ops.outpruned_matmul_plain(a, b, keep, block))
    elif which == "outpruned_matmul_dx":
        dyc = a[:, :kb * block]
        got, ref = (fn(dyc, b, keep, block=block),
                    ops.outpruned_matmul_dx_plain(dyc, b, keep, block))
    else:
        dyc = b[:, :kb * block]
        got, ref = (fn(a, dyc, order, kb=kb, block=block),
                    ops.outpruned_matmul_dw_plain(a, dyc, order, kb, block))
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 1e-4 * float(ref.float().abs().max()), err
