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
    assert tops.launch_counts() == {"block_pruned_matmul": 1,
                                    "fused_pruned_ffn": 2,
                                    "fused_decode_attention": 2}


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
