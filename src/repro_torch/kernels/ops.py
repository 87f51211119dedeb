"""Public wrappers of the port's CUDA kernels, with their plain versions
(port of ``repro.kernels.ops``).

Each wrapper validates its arguments with the reference's readable
errors, then dispatches on where its tensors lie:

* on a CUDA device it launches the hand-written kernel (``csrc/*.cu``,
  built on first use by :mod:`repro_torch.kernels.build`) and adds one
  to its ``launches`` count — there is no fallback, a failed launch
  raises;
* on the CPU it runs the kernel's plain PyTorch version, defined beside
  it in this module, which repeats the kernel's arithmetic (f32
  accumulation, the same casts) and is what the CPU tests hold against
  the JAX package.

Kernels (see each source's header for what bounds it on the H100), as
wrapper: CUDA source (under ``csrc/``) <- the TPU kernel it replaces
(under ``src/repro/kernels/``):

* block_pruned_matmul: block_pruned_matmul.cu up to BPM_DECODE_MAX_ROWS
  rows, the tensor-core core of pruned_grad.cu above <-
  pruned_matmul.py:block_pruned_matmul_2d
* fused_pruned_ffn: its hidden stage in fused_pruned_ffn.cu up to
  BPM_DECODE_MAX_ROWS rows, on the tensor-core core of pruned_grad.cu
  above; then the block-pruned product <- pruned_matmul.py:fused_ffn_2d
* fused_decode_attention: gqa_decode_attn.cu (row policy SlotRows) <-
  decode_attn.py:gqa_decode_attn_2d
* fused_paged_decode_attention: gqa_decode_attn.cu (the same body, row
  policy PagedRows: rows read through the page table) <-
  decode_attn.py:gqa_paged_decode_attn_2d
* fused_mla_decode_attention: mla_decode_attn.cu (row policy SlotRows)
  <- decode_attn.py:mla_decode_attn_2d
* fused_paged_mla_decode_attention: mla_decode_attn.cu (the same body,
  row policy PagedRows) <- decode_attn.py:mla_paged_decode_attn_2d
* unfused_decode_attention: unfused_gqa_decode_attn.cu <-
  decode_attn.py:unfused_gqa_decode_attn_2d (the three-launch baseline of
  the fused decode attention)
* pruned_matmul_dx, pruned_matmul_dw, outpruned_matmul,
  outpruned_matmul_dx, outpruned_matmul_dw: pruned_grad.cu <-
  pruned_matmul.py:<name>_2d

``block_pruned_matmul`` and ``fused_pruned_ffn`` are
``torch.autograd.Function``s whose backward runs the last five kernels,
as the reference's custom VJPs run its backward Pallas kernels (on CPU
tensors, their plain versions). The decode attention defines no
gradient, and neither do the paged, MLA and unfused decode attentions.

Every launch adds one to its wrapper's ``launches`` count. While the
analyzer (:mod:`repro_torch.analysis`) records a run it installs a hook
(:func:`set_launch_hook`) that also receives each launch's configuration,
read from the C launcher's own ``*_launch_config`` export.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# activations the FFN kernel knows (by identity of the function)
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), as ``jax.nn.silu``."""
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, as ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


ACT_CODES = {silu: 0, gelu: 1}


# ---------------------------------------------------------------------------
# checks shared by the wrappers
# ---------------------------------------------------------------------------


def _validate(K: int, w_rows: int, keep_idx: torch.Tensor, block: int,
              what: str) -> int:
    """Readable errors instead of a failure deep in the kernel (the
    reference's ``ops._validate``). Returns num_blocks."""
    if block <= 0:
        raise ValueError(f"{what}: block size must be positive, got {block}")
    if K != w_rows:
        raise ValueError(
            f"{what}: contraction mismatch — x has K={K} but w has "
            f"{w_rows} rows")
    if K % block != 0:
        raise ValueError(
            f"{what}: contraction dim K={K} is not a multiple of the "
            f"pruning block size {block} (K would be silently truncated); "
            "choose a block via repro_torch.core.workload.adapt_block_size")
    nb = K // block
    if keep_idx.ndim != 1:
        raise ValueError(
            f"{what}: keep_idx must be a 1-D block-id vector, got shape "
            f"{tuple(keep_idx.shape)}")
    kb = keep_idx.shape[0]
    if kb < 1 or kb > nb:
        raise ValueError(
            f"{what}: keep_idx has {kb} entries but K={K} / block={block} "
            f"gives only {nb} blocks (need 1 <= kept <= {nb})")
    if keep_idx.dtype.is_floating_point or keep_idx.dtype.is_complex \
            or keep_idx.dtype == torch.bool:
        raise ValueError(
            f"{what}: keep_idx must be integer block ids, got "
            f"{keep_idx.dtype}")
    return nb


def _kernel_args(what: str, tensors, keep_idx=None):
    """Device checks for a launch; returns (dtype code, int32 keep ids)."""
    dev = tensors[0].device
    dt = tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: operands lie on {t.device} and {dev}")
        if t.dtype != dt:
            raise ValueError(
                f"{what}: the kernel takes operands of one dtype, got "
                f"{t.dtype} and {dt}")
    if dt not in _DTYPE_CODES:
        raise ValueError(f"{what}: the kernel takes float32 or bfloat16, "
                         f"got {dt}")
    keep = None
    if keep_idx is not None:
        if keep_idx.device != dev:
            raise ValueError(
                f"{what}: keep_idx lies on {keep_idx.device}, operands on "
                f"{dev}")
        keep = keep_idx.to(torch.int32).contiguous()
    return _DTYPE_CODES[dt], keep


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _device_sms(device) -> int:
    return _num_sms(device.index if device.index is not None
                    else torch.cuda.current_device())


def _splits(limit: int, blocks_per_split_unit: int, device,
            per_sm: int = 4) -> int:
    """How many contraction ranges to spread across grid.z so that about
    ``per_sm`` blocks per SM are in flight (at most ``limit``)."""
    target = per_sm * _device_sms(device)
    return max(1, min(limit, -(-target // max(blocks_per_split_unit, 1))))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_launch_hook = None


def set_launch_hook(hook):
    """Install ``hook(wrapper name, launches)``, called after every kernel
    launch with the :class:`~repro_torch.kernels.build.Launch` records of
    that call (``None`` removes it); returns the previous hook."""
    global _launch_hook
    prev, _launch_hook = _launch_hook, hook
    return prev


def _launched(wrapper, *configs) -> None:
    """Count one launch of ``wrapper``'s kernel. ``configs`` are
    ``(entry, *ints)`` keys of :func:`build.launch_config`, read only when
    a hook is installed."""
    wrapper.launches += 1
    if _launch_hook is not None:
        _launch_hook(wrapper.__name__, tuple(
            rec for entry, *ints in configs
            for rec in _build.launch_config(entry, *ints)))


# ---------------------------------------------------------------------------
# the backward family (kernels #8-#12 of the TPU package)
# ---------------------------------------------------------------------------


def inverse_order(keep_idx: torch.Tensor, nb: int) -> torch.Tensor:
    """[nb] int32 permutation concat(keep_idx, pruned ids) for the
    backward kernels' inverse index maps (the reference's
    ``ops._inverse_order``). The keep prefix is ``keep_idx`` ITSELF, in
    the caller's order, sorted or not: compact slot k maps to block
    ``keep_idx[k]``. Built on the device with a mask and a stable
    argsort, so it costs no host sync."""
    keep = keep_idx.to(torch.int32)
    is_kept = torch.zeros((nb,), dtype=torch.bool, device=keep.device)
    is_kept.index_fill_(0, keep.long(), True)
    pruned = torch.argsort(is_kept.to(torch.int32), stable=True)
    return torch.cat([keep, pruned[: nb - keep.shape[0]].to(torch.int32)])


# the tensor-core core (pruned_grad.cu): output tile edge and contraction
# depth of one ring stage
TC_TILE, TC_DEPTH = 64, 32


def _tc_split_count(rows: int, cols: int, depth: int, device) -> int:
    """The split count of the tensor-core core for a kept output of
    ``rows x cols`` over a contraction of ``depth``: at most one range per
    stage; about two blocks per SM, which measured faster than four at
    the train shapes (fewer partials to sum)."""
    return _splits(-(-depth // TC_DEPTH),
                   -(-rows // TC_TILE) * -(-cols // TC_TILE), device,
                   per_sm=2)


def _tc_partials(rows: int, cols: int, depth: int, device,
                 direct: bool = False):
    """:func:`_tc_split_count` and its f32 partial buffer [splits, rows,
    cols]. ``direct``: the kernel's epilogue writes the output itself when
    there is one range (#2, #11), and the buffer is empty."""
    splits = _tc_split_count(rows, cols, depth, device)
    n = 0 if direct and splits == 1 else splits
    return splits, torch.empty((n, rows, cols), dtype=torch.float32,
                               device=device)


def _dw_partials(rows: int, cols: int, depth: int, device, splits=None):
    """The split count of #9's and #12's calls on the tensor-core core
    for a kept output of ``rows x cols`` over a contraction of ``depth``
    (about three blocks per SM over the kept tiles, the fastest in f32 at
    the train shapes; at most one range per stage, counted as the ranges
    of whole stages it makes: the kernel's grid.z; ``splits`` replaces the
    first choice), and their f32 partial buffer [splits, rows, cols]."""
    stages = -(-depth // TC_DEPTH)
    if splits is None:
        splits = _splits(stages, -(-rows // TC_TILE) * -(-cols // TC_TILE),
                         device, per_sm=3)
    splits = -(-stages // -(-stages // max(1, min(splits, stages))))
    return splits, torch.empty((splits, rows, cols), dtype=torch.float32,
                               device=device)


def _check_2d(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.ndim != 2:
            raise ValueError(f"{what}: {name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")


def _check_slots(what: str, idx: torch.Tensor, kb: int, nb: int) -> None:
    if idx.ndim != 1 or idx.dtype.is_floating_point \
            or idx.dtype == torch.bool:
        raise ValueError(f"{what}: the index vector must be 1-D integer "
                         f"block ids, got {idx.dtype} {tuple(idx.shape)}")
    if not 1 <= kb <= idx.shape[0] or idx.shape[0] > nb:
        raise ValueError(
            f"{what}: kb={kb} kept slots with an index vector of "
            f"{idx.shape[0]} over {nb} blocks (need 1 <= kb <= len <= nb)")


def _out(out, shape, like, dtype=None):
    """The caller's output buffer (checked), or a fresh torch.empty: the
    kernels write every element, zeros included. ``dtype`` defaults to
    ``like``'s."""
    dtype = dtype or like.dtype
    if out is None:
        return torch.empty(shape, dtype=dtype, device=like.device)
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype \
            or out.device != like.device or not out.is_contiguous():
        raise ValueError(
            f"out must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {like.device}, got {out.dtype} "
            f"{tuple(out.shape)} on {out.device}")
    return out


def _scatter_blocks(compact: torch.Tensor, ids: torch.Tensor, nb: int,
                    block: int, dim: int) -> torch.Tensor:
    """Place the kb compact blocks of ``compact`` (along ``dim``, 0 or 1)
    at block positions ``ids`` of an nb-block zero tensor."""
    if dim == 0:
        out = compact.new_zeros((nb, block, compact.shape[1]))
        out[ids] = compact.reshape(-1, block, compact.shape[1])
        return out.reshape(nb * block, compact.shape[1])
    out = compact.new_zeros((compact.shape[0], nb, block))
    out[:, ids] = compact.reshape(compact.shape[0], -1, block)
    return out.reshape(compact.shape[0], nb * block)


def pruned_matmul_dx_plain(dy, w, order, kb: int, block: int,
                           compact_out: bool = False) -> torch.Tensor:
    """dX[:, order[k]] = dy @ w[order[k]]^T for k < kb, zeros at the other
    slots of ``order``; compact_out returns the [M, kb*block] kept part."""
    N = w.shape[1]
    ids = order[:kb].long()
    wk = w.reshape(-1, block, N)[ids].reshape(kb * block, N)
    dxk = dy.float() @ wk.float().t()
    if compact_out:
        return dxk.to(dy.dtype)
    return _scatter_blocks(dxk, ids, order.shape[0], block, 1).to(dy.dtype)


def pruned_matmul_dx(dy: torch.Tensor, w: torch.Tensor, order: torch.Tensor,
                     *, kb: int, block: int, compact_out: bool = False,
                     out=None) -> torch.Tensor:
    """dX of the block-pruned product (TPU kernel
    ``pruned_matmul_dx_2d``): dy [M, N], w [nb*block, N], order [nb]
    (only its keep prefix [kb] with ``compact_out``). Returns [M, nb*block]
    with zeros at the pruned blocks, or [M, kb*block] compact."""
    what = "pruned_matmul_dx"
    _check_2d(what, dy=dy, w=w)
    if dy.shape[1] != w.shape[1] or w.shape[0] % block:
        raise ValueError(f"{what}: dy {tuple(dy.shape)} / w "
                         f"{tuple(w.shape)} with block={block}")
    nb = w.shape[0] // block
    _check_slots(what, order, kb, nb)
    if not compact_out and order.shape[0] != nb:
        raise ValueError(f"{what}: order has {order.shape[0]} entries, w "
                         f"{nb} blocks")
    if not dy.is_cuda:
        return pruned_matmul_dx_plain(dy, w, order, kb, block, compact_out)
    dt, idx = _kernel_args(what, (dy, w), order)
    M, N = dy.shape
    y = _out(out, (M, (kb if compact_out else nb) * block), dy)
    splits, partial = _tc_partials(M, kb * block, N, dy.device)
    # copies held to the launch (a dropped one's memory can go to the next)
    dy_c, w_c = dy.contiguous(), w.contiguous()
    err = _build.library().lib.repro_pruned_matmul_dx(
        dy_c.data_ptr(), w_c.data_ptr(),
        idx.data_ptr(), partial.data_ptr(), y.data_ptr(), M, N, nb, kb,
        block, int(compact_out), splits, dt, _stream(dy.device))
    _build.check(err, what)
    _launched(pruned_matmul_dx, ("repro_pruned_matmul_dx", M, N, nb, kb,
                                 block, int(compact_out), splits, dt))
    return y


pruned_matmul_dx.launches = 0


def pruned_matmul_dw_plain(x, dy, order, kb: int, block: int,
                           x_compact: bool = False) -> torch.Tensor:
    """dW[order[k]] = x[:, order[k]]^T @ dy for k < kb, zeros at the
    pruned rows; x_compact reads x as [M, kb*block] (slot k = block k)."""
    M = dy.shape[0]
    ids = order[:kb].long()
    if x_compact:
        xk = x[:, : kb * block]
    else:
        xk = x.reshape(M, -1, block)[:, ids].reshape(M, kb * block)
    dwk = xk.float().t() @ dy.float()
    return _scatter_blocks(dwk, ids, order.shape[0], block, 0).to(dy.dtype)


def pruned_matmul_dw(x: torch.Tensor, dy: torch.Tensor, order: torch.Tensor,
                     *, kb: int, block: int, x_compact: bool = False,
                     out=None) -> torch.Tensor:
    """dW of the block-pruned product (TPU kernel ``pruned_matmul_dw_2d``):
    x [M, nb*block] (or [M, kb*block] with ``x_compact``), dy [M, N],
    order [nb]. Returns [nb*block, N] with zeros at the pruned rows."""
    what = "pruned_matmul_dw"
    _check_2d(what, x=x, dy=dy)
    nb = order.shape[0]
    _check_slots(what, order, kb, nb)
    if x.shape[0] != dy.shape[0] \
            or x.shape[1] != (kb if x_compact else nb) * block:
        raise ValueError(f"{what}: x {tuple(x.shape)} / dy "
                         f"{tuple(dy.shape)} with {nb} blocks of {block}, "
                         f"kb={kb}, x_compact={x_compact}")
    if not dy.is_cuda:
        return pruned_matmul_dw_plain(x, dy, order, kb, block, x_compact)
    dt, idx = _kernel_args(what, (x, dy), order)
    M, N = dy.shape
    y = _out(out, (nb * block, N), dy)
    splits, partial = _dw_partials(kb * block, N, M, dy.device)
    # copies held to the launch (a dropped one's memory can go to the next)
    x_c, dy_c = x.contiguous(), dy.contiguous()
    err = _build.library().lib.repro_pruned_matmul_dw(
        x_c.data_ptr(), dy_c.data_ptr(),
        idx.data_ptr(), partial.data_ptr(), y.data_ptr(), M, N, nb, kb,
        block, int(x_compact), splits, dt, _stream(dy.device))
    _build.check(err, what)
    _launched(pruned_matmul_dw, ("repro_pruned_matmul_dw", M, N, nb, kb,
                                 block, int(x_compact), splits, dt))
    return y


pruned_matmul_dw.launches = 0


def _cols(w: torch.Tensor, keep: torch.Tensor, block: int) -> torch.Tensor:
    """The kept column blocks of w [K, nb*block] -> [K, kb*block]."""
    K = w.shape[0]
    return w.reshape(K, -1, block)[:, keep.long()].reshape(
        K, keep.shape[0] * block)


def outpruned_matmul_plain(x, w, keep_idx, block: int) -> torch.Tensor:
    """Compact yc[:, k-th block] = x @ w[:, keep_idx[k]]."""
    return (x.float() @ _cols(w, keep_idx, block).float()).to(x.dtype)


def outpruned_matmul(x: torch.Tensor, w: torch.Tensor, keep_idx: torch.Tensor,
                     *, block: int, out=None) -> torch.Tensor:
    """The out-pruned product (TPU kernel ``outpruned_matmul_2d``): x [M, K]
    @ w[:, keep] for w [K, nb*block] -> compact [M, kb*block]."""
    what = "outpruned_matmul"
    _check_2d(what, x=x, w=w)
    if x.shape[1] != w.shape[0] or w.shape[1] % block:
        raise ValueError(f"{what}: x {tuple(x.shape)} @ w {tuple(w.shape)} "
                         f"with block={block}")
    kb = keep_idx.shape[0]
    _check_slots(what, keep_idx, kb, w.shape[1] // block)
    if not x.is_cuda:
        return outpruned_matmul_plain(x, w, keep_idx, block)
    dt, idx = _kernel_args(what, (x, w), keep_idx)
    (M, K), H = x.shape, w.shape[1]
    y = _out(out, (M, kb * block), x)
    splits, partial = _tc_partials(M, kb * block, K, x.device)
    # copies held to the launch (a dropped one's memory can go to the next)
    x_c, w_c = x.contiguous(), w.contiguous()
    err = _build.library().lib.repro_outpruned_matmul(
        x_c.data_ptr(), w_c.data_ptr(), idx.data_ptr(),
        partial.data_ptr(), y.data_ptr(), M, K, H, kb, block, splits, dt,
        _stream(x.device))
    _build.check(err, what)
    _launched(outpruned_matmul, ("repro_outpruned_matmul", M, K, H, kb, block,
                                 splits, dt))
    return y


outpruned_matmul.launches = 0


def outpruned_matmul_dx_plain(dyc, w, keep_idx, block: int) -> torch.Tensor:
    """dx = dyc @ w[:, keep]^T (dense output)."""
    return (dyc.float() @ _cols(w, keep_idx, block).float().t()).to(dyc.dtype)


def outpruned_matmul_dx(dyc: torch.Tensor, w: torch.Tensor,
                        keep_idx: torch.Tensor, *, block: int,
                        out=None) -> torch.Tensor:
    """dx of the out-pruned product (TPU kernel
    ``outpruned_matmul_dx_2d``): dyc [M, kb*block], w [K, nb*block] ->
    [M, K]; the contraction runs over the kept blocks only."""
    what = "outpruned_matmul_dx"
    _check_2d(what, dyc=dyc, w=w)
    kb = keep_idx.shape[0]
    if dyc.shape[1] != kb * block or w.shape[1] % block:
        raise ValueError(f"{what}: dyc {tuple(dyc.shape)} / w "
                         f"{tuple(w.shape)} with {kb} kept blocks of {block}")
    _check_slots(what, keep_idx, kb, w.shape[1] // block)
    if not dyc.is_cuda:
        return outpruned_matmul_dx_plain(dyc, w, keep_idx, block)
    dt, idx = _kernel_args(what, (dyc, w), keep_idx)
    M, (K, H) = dyc.shape[0], w.shape
    y = _out(out, (M, K), dyc)
    splits, partial = _tc_partials(M, K, kb * block, dyc.device, direct=True)
    # copies held to the launch (a dropped one's memory can go to the next)
    dyc_c, w_c = dyc.contiguous(), w.contiguous()
    err = _build.library().lib.repro_outpruned_matmul_dx(
        dyc_c.data_ptr(), w_c.data_ptr(),
        idx.data_ptr(), partial.data_ptr(), y.data_ptr(), M, K, H, kb, block,
        splits, dt, _stream(dyc.device))
    _build.check(err, what)
    _launched(outpruned_matmul_dx, ("repro_outpruned_matmul_dx", M, K, H, kb,
                                    block, splits, dt))
    return y


outpruned_matmul_dx.launches = 0


def outpruned_matmul_dw_plain(x, dyc, order, kb: int,
                              block: int) -> torch.Tensor:
    """dW[:, order[k]] = x^T @ dyc[:, k-th block] for k < kb, zeros at
    the pruned column blocks."""
    dwk = x.float().t() @ dyc.float()
    return _scatter_blocks(dwk, order[:kb].long(), order.shape[0], block,
                           1).to(dyc.dtype)


def outpruned_matmul_dw(x: torch.Tensor, dyc: torch.Tensor,
                        order: torch.Tensor, *, kb: int, block: int,
                        out=None) -> torch.Tensor:
    """dW of the out-pruned product (TPU kernel
    ``outpruned_matmul_dw_2d``): x [M, K], dyc [M, kb*block], order [nb]
    -> [K, nb*block] with zeros at the pruned column blocks."""
    what = "outpruned_matmul_dw"
    _check_2d(what, x=x, dyc=dyc)
    nb = order.shape[0]
    _check_slots(what, order, kb, nb)
    if x.shape[0] != dyc.shape[0] or dyc.shape[1] != kb * block:
        raise ValueError(f"{what}: x {tuple(x.shape)} / dyc "
                         f"{tuple(dyc.shape)} with {kb} kept blocks of "
                         f"{block}")
    if not dyc.is_cuda:
        return outpruned_matmul_dw_plain(x, dyc, order, kb, block)
    dt, idx = _kernel_args(what, (x, dyc), order)
    M, K = x.shape
    y = _out(out, (K, nb * block), dyc)
    splits, partial = _dw_partials(K, kb * block, M, dyc.device)
    # copies held to the launch (a dropped one's memory can go to the next)
    x_c, dyc_c = x.contiguous(), dyc.contiguous()
    err = _build.library().lib.repro_outpruned_matmul_dw(
        x_c.data_ptr(), dyc_c.data_ptr(),
        idx.data_ptr(), partial.data_ptr(), y.data_ptr(), M, K, nb, kb,
        block, splits, dt, _stream(dyc.device))
    _build.check(err, what)
    _launched(outpruned_matmul_dw, ("repro_outpruned_matmul_dw", M, K, nb, kb,
                                    block, splits, dt))
    return y


outpruned_matmul_dw.launches = 0


# ---------------------------------------------------------------------------
# block-pruned matmul (contraction pruning), with its kernel-level VJP
# ---------------------------------------------------------------------------


def block_pruned_matmul_plain(x2d: torch.Tensor, w: torch.Tensor,
                              keep_idx: torch.Tensor,
                              block: int) -> torch.Tensor:
    """y = x[:, keep-blocks] @ w[keep-blocks, :], f32 accumulation, cast
    to x's dtype."""
    M, K = x2d.shape
    keep = keep_idx.long()
    xk = x2d.reshape(M, K // block, block)[:, keep].reshape(M, -1)
    wk = w.reshape(K // block, block, w.shape[1])[keep].reshape(-1, w.shape[1])
    return (xk.float() @ wk.float()).to(x2d.dtype)


# #2's decode kernel (block_pruned_matmul.cu): output columns and slots
# per block, contraction rows per chunk, warps per block, chunks in
# flight per warp (its register ring in bf16; two turns of f32's)
BPM_COLS, BPM_SLOTS, BPM_ROWS, BPM_WARPS, BPM_RING = 64, 8, 16, 8, 4
# #2 runs the decode kernel up to this many rows of x and the tensor-core
# core above them (the M sweep of grad_timing.py --bpm-sweep, PERF.md)
BPM_DECODE_MAX_ROWS = 16


def _bpm_decode_splits(M: int, N: int, depth: int, device) -> int:
    """Contraction ranges of the decode kernel for y [M, N] over ``depth``
    kept rows: as many as keep every block resident at once (two per SM,
    one wave: a second one measured 20-30% slower) over the column and
    slot tiles, with a full ring of chunks for every warp of a range."""
    chunks = -(-depth // BPM_ROWS)
    tiles = -(-N // BPM_COLS) * -(-M // BPM_SLOTS)
    return max(1, min(chunks // (BPM_WARPS * BPM_RING),
                      2 * _device_sms(device) // tiles))


def _launch_block_pruned(x2d, w, keep, block, dt, *, x_compact=False,
                         K=None, out=None):
    """Run #2's kernel for x2d's rows: the decode kernel up to
    BPM_DECODE_MAX_ROWS rows, the tensor-core core above; ``x_compact``
    reads x as [M, kb*block]. Returns the output (``out`` when given)
    and the launch's config key."""
    M = x2d.shape[0]
    N = w.shape[1]
    K = w.shape[0] if K is None else K
    kb = keep.shape[0]
    dev = x2d.device
    lib = _build.library().lib
    y = _out(out, (M, N), x2d)
    if M <= BPM_DECODE_MAX_ROWS:
        splits = _bpm_decode_splits(M, N, kb * block, dev)
        partial = torch.empty((splits if splits > 1 else 0, M, N),
                              dtype=torch.float32, device=dev)
        err = lib.repro_block_pruned_matmul(
            x2d.data_ptr(), w.data_ptr(), keep.data_ptr(), partial.data_ptr(),
            y.data_ptr(), M, K, N, kb, block, int(x_compact), splits, dt,
            _stream(dev))
        config = ("repro_block_pruned_matmul", M, N, kb, block, splits, dt)
    else:
        splits, partial = _tc_partials(M, N, kb * block, dev, direct=True)
        err = lib.repro_block_pruned_matmul_tc(
            x2d.data_ptr(), w.data_ptr(), keep.data_ptr(), partial.data_ptr(),
            y.data_ptr(), M, K, N, kb, block, int(x_compact), splits, dt,
            _stream(dev))
        config = ("repro_block_pruned_matmul_tc", M, K, N, kb, block,
                  int(x_compact), splits, dt)
    _build.check(err, "block_pruned_matmul")
    return y, config


class _BlockPrunedMatmul(torch.autograd.Function):
    """Forward: the block-pruned kernel (#2). Backward (reference
    ``ops._bwd``): dX through ``pruned_matmul_dx`` (#8) and dW through
    ``pruned_matmul_dw`` (#9), both zero at the pruned blocks."""

    @staticmethod
    def forward(ctx, x2d, w, keep_idx, block):
        ctx.save_for_backward(x2d, w, keep_idx)
        ctx.block = block
        if not x2d.is_cuda:
            return block_pruned_matmul_plain(x2d, w, keep_idx, block)
        dt, keep = _kernel_args("block_pruned_matmul", (x2d, w), keep_idx)
        y, config = _launch_block_pruned(x2d.contiguous(), w.contiguous(),
                                         keep, block, dt)
        _launched(block_pruned_matmul, config)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, w, keep_idx = ctx.saved_tensors
        block = ctx.block
        kb = keep_idx.shape[0]
        order = inverse_order(keep_idx, x2d.shape[1] // block)
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = pruned_matmul_dx(dy, w, order, kb=kb,
                                  block=block).to(x2d.dtype)
        if ctx.needs_input_grad[1]:
            dw = pruned_matmul_dw(x2d, dy, order, kb=kb,
                                  block=block).to(w.dtype)
        return dx, dw, None, None


def block_pruned_matmul(x: torch.Tensor, w: torch.Tensor,
                        keep_idx: torch.Tensor,
                        block: int = 128) -> torch.Tensor:
    """y = x[..., keep] @ w[keep, :], differentiable in x and w.

    x: [..., K]; w: [K, N]; keep_idx: [kb] integer block ids.
    """
    *lead, K = x.shape
    _validate(K, w.shape[0], keep_idx, block, "block_pruned_matmul")
    y = _BlockPrunedMatmul.apply(x.reshape(-1, K), w, keep_idx, block)
    return y.reshape(*lead, w.shape[1])


block_pruned_matmul.launches = 0


# ---------------------------------------------------------------------------
# pruned FFN pair, with its kernel-level VJP
# ---------------------------------------------------------------------------


def fused_pruned_ffn_plain(x2d, w_up, w_down, keep_idx, w_gate, act_fn,
                           block: int) -> torch.Tensor:
    """act(x @ Wup[:, keep] [, · gate]) @ Wdown[keep, :]: both products
    accumulate in f32, the activation runs in f32, the hidden is cast to
    Wdown's dtype before the second product (as the TPU kernel does)."""
    d, H = w_up.shape
    keep = keep_idx.long()
    nb = H // block

    def cols(w):
        return w.reshape(d, nb, block)[:, keep].reshape(d, -1).float()

    pre = x2d.float() @ cols(w_up)
    if w_gate is not None:
        h = act_fn(x2d.float() @ cols(w_gate)) * pre
    else:
        h = act_fn(pre)
    wd = w_down.reshape(nb, block, w_down.shape[1])[keep].reshape(
        -1, w_down.shape[1])
    return (h.to(w_down.dtype).float() @ wd.float()).to(x2d.dtype)


# #3's decode kernel (fused_pruned_ffn.cu): compact columns per block (two
# groups of 64, each down 4 of its 8 warps), rows of x a block stages in
# shared memory at most (8 rows of x: 66 KB in f32)
FFN_COLS, FFN_CHUNK_WARPS, FFN_X_ROWS = 128, 4, 2048


def _ffn_decode_splits(M: int, K: int, C: int, device) -> int:
    """K ranges of #3's decode kernel for h [M, C]: as many as keep every
    block resident at once (two per SM over the 128-column and 8-row
    tiles, one wave, as #2's decode kernel; the range sweep of
    grad_timing.py --ffn-sweep, PERF.md), but at least enough that a
    range's x fits its stage (FFN_X_ROWS rows) and at most as many as
    leave each warp two chunks of 16 rows."""
    chunks = -(-K // BPM_ROWS)
    tiles = -(-C // FFN_COLS) * -(-M // BPM_SLOTS)
    lo = -(-K // FFN_X_ROWS)
    hi = max(lo, chunks // (2 * FFN_CHUNK_WARPS))
    return max(lo, min(hi, 2 * _device_sms(device) // tiles))


def _launch_pruned_ffn(x2d, w_up, w_down, w_gate, keep, act, block, dt):
    """Run #3 for x2d's rows: the compact hidden h [M, kb*block] by the
    decode kernel up to BPM_DECODE_MAX_ROWS rows and the tensor-core core
    above (the down product's threshold too), then the down product
    through #2's launcher reading h as compact x. Returns y and the two
    stages' config keys."""
    M, K = x2d.shape
    H = w_up.shape[1]
    kb = keep.shape[0]
    C = kb * block
    gated = w_gate is not None
    dev = x2d.device
    if M <= BPM_DECODE_MAX_ROWS:
        entry, splits = "repro_pruned_ffn_hidden", _ffn_decode_splits(
            M, K, C, dev)
    else:
        entry, splits = "repro_pruned_ffn_hidden_tc", _tc_split_count(
            M, C, K, dev)
    # both products' f32 partials, when the contraction is split
    partial = torch.empty(((1 + gated) * splits if splits > 1 else 0, M, C),
                          dtype=torch.float32, device=dev)
    h = torch.empty((M, C), dtype=x2d.dtype, device=dev)
    err = getattr(_build.library().lib, entry)(
        x2d.data_ptr(), w_up.data_ptr(),
        None if w_gate is None else w_gate.data_ptr(), keep.data_ptr(),
        partial.data_ptr(), h.data_ptr(), M, K, H, kb, block, splits, act, dt,
        _stream(dev))
    _build.check(err, "fused_pruned_ffn (hidden)")
    y, down = _launch_block_pruned(h, w_down, keep, block, dt, x_compact=True,
                                   K=w_down.shape[0])
    return y, ((entry, M, K, kb, block, int(gated), splits, dt), down)


class _FusedPrunedFFN(torch.autograd.Function):
    """Forward: the compact hidden stage and the block-pruned down
    product (#3). Backward (reference ``ops._ffn_bwd``): recompute the
    compact pre-activations with ``outpruned_matmul`` (#10) instead of
    keeping the hidden; dWdown through ``pruned_matmul_dw`` on the compact
    hidden (#9, x_compact); the compact dh through ``pruned_matmul_dx``
    (#8, compact_out); the activation's VJP elementwise; dWup (and
    dWgate) through ``outpruned_matmul_dw`` (#12); dx through
    ``outpruned_matmul_dx`` (#11)."""

    @staticmethod
    def forward(ctx, x2d, w_up, w_down, keep_idx, w_gate, act_fn, block):
        ctx.save_for_backward(x2d, w_up, w_down, keep_idx, w_gate)
        ctx.act_fn, ctx.block = act_fn, block
        if not x2d.is_cuda:
            return fused_pruned_ffn_plain(x2d, w_up, w_down, keep_idx,
                                          w_gate, act_fn, block)
        ops_ = (x2d, w_up, w_down) + ((w_gate,) if w_gate is not None else ())
        dt, keep = _kernel_args("fused_pruned_ffn", ops_, keep_idx)
        y, configs = _launch_pruned_ffn(
            x2d.contiguous(), w_up.contiguous(), w_down.contiguous(),
            None if w_gate is None else w_gate.contiguous(), keep,
            ACT_CODES[act_fn], block, dt)
        _launched(fused_pruned_ffn, *configs)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, w_up, w_down, keep_idx, w_gate = ctx.saved_tensors
        act_fn, block = ctx.act_fn, ctx.block
        kb = keep_idx.shape[0]
        order = inverse_order(keep_idx, w_up.shape[1] // block)
        dy = dy.contiguous()
        pre_up = outpruned_matmul(x2d, w_up, keep_idx, block=block)
        pre_g = (outpruned_matmul(x2d, w_gate, keep_idx, block=block)
                 if w_gate is not None else None)
        with torch.enable_grad():
            pu = pre_up.detach().requires_grad_()
            pg = pre_g.detach().requires_grad_() if pre_g is not None \
                else None
            h = act_fn(pg) * pu if pg is not None else act_fn(pu)
        dw_down = pruned_matmul_dw(h.detach().to(dy.dtype), dy, order, kb=kb,
                                   block=block, x_compact=True)
        dh = pruned_matmul_dx(dy, w_down, keep_idx, kb=kb, block=block,
                              compact_out=True)
        leaves = (pu, pg) if pg is not None else (pu,)
        dpre = torch.autograd.grad(h, leaves, dh.to(h.dtype))
        dpre_up = dpre[0].to(x2d.dtype).contiguous()
        dw_up = outpruned_matmul_dw(x2d, dpre_up, order, kb=kb, block=block)
        dx = outpruned_matmul_dx(dpre_up, w_up, keep_idx, block=block)
        dw_gate = None
        if pg is not None:
            dpre_g = dpre[1].to(x2d.dtype).contiguous()
            dw_gate = outpruned_matmul_dw(x2d, dpre_g, order, kb=kb,
                                          block=block).to(w_gate.dtype)
            dx = dx + outpruned_matmul_dx(dpre_g, w_gate, keep_idx,
                                          block=block)
        return (dx.to(x2d.dtype), dw_up.to(w_up.dtype),
                dw_down.to(w_down.dtype), None, dw_gate, None, None)


def fused_pruned_ffn(x: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, keep_idx: torch.Tensor,
                     w_gate=None, act_fn=None,
                     block: int = 128) -> torch.Tensor:
    """Controlled FFN pair y = act(x @ Wup[:, keep] [, · gate]) @
    Wdown[keep, :], differentiable in x and the weights.

    x: [..., K]; w_up/w_gate: [K, H]; w_down: [H, d_out]; keep_idx: [kb]
    kept H-block ids. On the card: the compact hidden stage
    (``csrc/fused_pruned_ffn.cu`` up to BPM_DECODE_MAX_ROWS rows, the
    tensor-core core of ``csrc/pruned_grad.cu`` above) then the
    block-pruned down product; ``act_fn`` must be :func:`silu` or
    :func:`gelu`.
    """
    *lead, K = x.shape
    _validate(w_up.shape[1], w_down.shape[0], keep_idx, block,
              "fused_pruned_ffn")
    if w_up.shape[0] != K or (w_gate is not None
                              and w_gate.shape != w_up.shape):
        raise ValueError(
            f"fused_pruned_ffn: x has K={K} but w_up is "
            f"{tuple(w_up.shape)}"
            + ("" if w_gate is None else f", w_gate {tuple(w_gate.shape)}"))
    if act_fn is None:
        raise ValueError("fused_pruned_ffn: act_fn is required")
    if x.is_cuda and act_fn not in ACT_CODES:
        raise ValueError(
            f"fused_pruned_ffn: activation {act_fn!r} has no kernel "
            "code; use repro_torch.kernels.ops.silu or .gelu")
    y = _FusedPrunedFFN.apply(x.reshape(-1, K), w_up, w_down, keep_idx,
                              w_gate, act_fn, block)
    return y.reshape(*lead, w_down.shape[1])


fused_pruned_ffn.launches = 0


# ---------------------------------------------------------------------------
# fused GQA decode attention (inference-only)
# ---------------------------------------------------------------------------


def _check_decode_attn(q, k_cache, v_cache, cur_pos):
    B, Hq, S1, _ = q.shape
    Hkv = k_cache.shape[1]
    if S1 != 1:
        raise ValueError(
            f"fused_decode_attention: q {tuple(q.shape)} must carry exactly "
            "one query token (decode step), got seq len "
            f"{S1}")
    if Hq % Hkv != 0:
        raise ValueError(
            f"fused_decode_attention: Hq={Hq} is not a multiple of "
            f"Hkv={Hkv} (GQA groups must divide evenly)")
    if k_cache.shape[0] != B or v_cache.shape[:3] != k_cache.shape[:3]:
        raise ValueError(
            f"fused_decode_attention: cache shapes k {tuple(k_cache.shape)} "
            f"/ v {tuple(v_cache.shape)} do not match q batch {B}")
    if tuple(cur_pos.shape) != (B,):
        raise ValueError(
            f"fused_decode_attention: cur_pos {tuple(cur_pos.shape)} must "
            f"be [{B}] (one ragged position per slot)")


def _decode_scratch(rows: int, width: int, device):
    """f32 split scratch: (m, l) of ``rows`` entries each and the
    ``rows`` x ``width`` accumulators."""
    part_ml = torch.empty((2, rows), dtype=torch.float32, device=device)
    part_acc = torch.empty((rows * width,), dtype=torch.float32,
                           device=device)
    return part_ml, part_acc


#: cache rows per block of gqa_decode_attn.cu (kRows), counted from the
#: tile that holds a slot's first attended row
GQA_ROWS = 128


def _gqa_partials(B: int, Hkv: int, G: int, length: int, Dv: int, device):
    """Host side of the GQA decode kernels' grid (#1 over a slot cache of
    ``length`` rows, #4 over a page table of ``length`` = pps * ps rows):
    ``ranges`` = ceil(length / GQA_ROWS) blocks of rows per (slot, KV
    head), enough for a slot that attends every row, and the f32 scratch
    of one partial (m, l, acc) per (slot, head, range, query head). Shapes
    only: which ranges hold rows is worked out from cur_pos on the
    device, so nothing here reads a tensor."""
    ranges = -(-length // GQA_ROWS)
    part_ml, part_acc = _decode_scratch(B * Hkv * ranges * G, Dv, device)
    return ranges, part_ml, part_acc


def _check_widths(what: str, **pairs) -> None:
    """Before a launch: each (name -> (width, expected)) must agree, or
    the kernel would read past a row."""
    for name, (got, want) in pairs.items():
        if got != want:
            raise ValueError(f"{what}: {name} is {got}, expected {want}")


def _int32_on(t: torch.Tensor, dev, what: str, name: str) -> torch.Tensor:
    if t.device != dev:
        raise ValueError(f"{what}: {name} lies on {t.device}, q on {dev}")
    return t.to(torch.int32).contiguous()


def _gqa_attend(qg, k, v, ok, scale):
    """Masked f32 softmax attention shared by the GQA plain versions:
    qg [B, Hkv, G, D], k / v [B, Hkv, S, D|Dv], ok [B, S] the rows each
    slot attends. Rows outside ``ok`` are zeroed before use (a row the
    kernel never reads may hold anything, NaN included); a slot with no
    row gets zeros."""
    okk = ok[:, None, :, None]
    k = torch.where(okk, k.float(), torch.zeros((), device=k.device))
    v = torch.where(okk, v.float(), torch.zeros((), device=v.device))
    s = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k) * scale
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, torch.full_like(s, -math.inf))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v)
    return out / torch.clamp(l, min=1e-30)


def attended_rows(S: int, cur_pos, window: int = 0, device=None):
    """[B, S] bool: the rows p <= cur_pos (and > cur_pos - window)."""
    pos = torch.arange(S, device=device)[None, :]
    cur = cur_pos.to(torch.int64)[:, None]
    ok = pos <= cur
    if window > 0:
        ok = ok & (pos > cur - window)
    return ok


def paged_attended_rows(pages, ps: int, num_pages: int, cur_pos,
                   window: int = 0):
    """[B, pps*ps] bool: the rows a paged kernel attends — in range, and
    in a page the table holds (an entry -1 or past the pool is absent)."""
    pg = pages.to(torch.int64)
    present = ((pg >= 0) & (pg < num_pages)).repeat_interleave(ps, dim=1)
    return attended_rows(pg.shape[1] * ps, cur_pos, window, pages.device) \
        & present


def gqa_decode_attn_plain(q, k_cache, v_cache, cur_pos,
                          window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 scores and softmax
    over the positions p <= cur_pos (and > cur_pos - window); a slot with
    no such position gets zeros. q [B, Hq, 1, D] -> [B, Hq, 1, Dv]."""
    B, Hq, _, D = q.shape
    Hkv, S, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    out = _gqa_attend(qg, k_cache, v_cache,
                      attended_rows(S, cur_pos, window, q.device),
                      1.0 / math.sqrt(D))
    return out.reshape(B, Hq, 1, Dv).to(q.dtype)


def fused_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, *, cur_pos: torch.Tensor,
                           window: int = 0, out=None) -> torch.Tensor:
    """Fused GQA decode attention (one kernel, online softmax).

    Same contract as ``layers.attention.decode_attention``:
    q [B, Hq, 1, D]; caches [B, Hkv, S, D]/[B, Hkv, S, Dv]; cur_pos [B]
    int — attends cache positions p <= cur_pos[b] (windowed if set).
    Returns [B, Hq, 1, Dv] in q.dtype (into ``out`` when given, on the
    card). Inference-only.
    """
    _check_decode_attn(q, k_cache, v_cache, cur_pos)
    if not q.is_cuda:
        return gqa_decode_attn_plain(q, k_cache, v_cache, cur_pos, window)
    B, Hq, _, D = q.shape
    Hkv, S, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    G = Hq // Hkv
    what = "fused_decode_attention"
    _check_widths(what, **{"k_cache head dim": (k_cache.shape[3], D)})
    dt, _ = _kernel_args(what, (q, k_cache, v_cache))
    cur = _int32_on(cur_pos, q.device, what, "cur_pos")
    qc = q.contiguous()
    kc, vc = k_cache.contiguous(), v_cache.contiguous()
    ranges, part_ml, part_acc = _gqa_partials(B, Hkv, G, S, Dv, q.device)
    out = _out(out, (B, Hq, 1, Dv), q)
    err = _build.library().lib.repro_gqa_decode_attn(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), cur.data_ptr(),
        part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, Hkv, G, S, D, Dv, 1.0 / math.sqrt(D),
        int(window), ranges, dt, _stream(q.device))
    _build.check(err, "fused_decode_attention")
    _launched(fused_decode_attention, ("repro_gqa_decode_attn", B, Hkv, G, D,
                                       Dv, ranges, dt))
    return out


fused_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# unfused GQA decode attention: the three-launch baseline (inference-only)
# ---------------------------------------------------------------------------

NEG_INF = -1e30       # the TPU kernel's mask value: finite


def unfused_gqa_decode_attn_plain(q, k_cache, v_cache, cur_pos,
                                  window: int = 0) -> torch.Tensor:
    """The unfused kernel's function in plain PyTorch: f32 scores over
    every cache row with ``NEG_INF`` at the positions p > cur_pos (or
    p <= cur_pos - window), a softmax over all S rows, an f32 weighted
    sum. ``NEG_INF`` is finite, as in the TPU kernel, so a slot with no
    attended row (cur_pos < 0) gets the uniform average of its S value
    rows — where :func:`gqa_decode_attn_plain` (the fused kernels'
    function) gives zeros. q [B, Hq, 1, D] -> [B, Hq, 1, Dv]."""
    B, Hq, _, D = q.shape
    Hkv, S, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) / math.sqrt(D)
    ok = attended_rows(S, cur_pos, window, q.device)[:, None, None, :]
    p = torch.softmax(torch.where(ok, s, torch.full_like(s, NEG_INF)), -1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, 1, Dv).to(q.dtype)


def unfused_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, *, cur_pos: torch.Tensor,
                             window: int = 0, out=None) -> torch.Tensor:
    """Unfused GQA decode attention: :func:`fused_decode_attention`'s
    contract in three launches (scores, softmax, weighted sum) with the
    f32 [B, Hkv, G, S] score matrix in device memory, every cache row
    read whatever cur_pos is. The baseline that shows what fusion saves;
    no serve path calls it. Returns [B, Hq, 1, Dv] in q.dtype (into
    ``out`` when given, on the card). Inference-only.
    """
    _check_decode_attn(q, k_cache, v_cache, cur_pos)
    if not q.is_cuda:
        return unfused_gqa_decode_attn_plain(q, k_cache, v_cache, cur_pos,
                                             window)
    what = "unfused_decode_attention"
    B, Hq, _, D = q.shape
    Hkv, S, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    G = Hq // Hkv
    _check_widths(what, **{"k_cache head dim": (k_cache.shape[3], D)})
    dt, _ = _kernel_args(what, (q, k_cache, v_cache))
    cur = _int32_on(cur_pos, q.device, what, "cur_pos")
    scores = torch.empty((B, Hkv, G, S), dtype=torch.float32,
                         device=q.device)
    out = _out(out, (B, Hq, 1, Dv), q)
    # copies held to the launch (a dropped one's memory can go to the next)
    q_c, k_cache_c, v_cache_c = (q.contiguous(), k_cache.contiguous(),
                                 v_cache.contiguous())
    err = _build.library().lib.repro_unfused_gqa_decode_attn(
        q_c.data_ptr(), k_cache_c.data_ptr(),
        v_cache_c.data_ptr(), cur.data_ptr(), scores.data_ptr(),
        out.data_ptr(), B, Hkv, G, S, D, Dv, 1.0 / math.sqrt(D), int(window),
        dt, _stream(q.device))
    _build.check(err, what)
    _launched(unfused_decode_attention, ("repro_unfused_gqa_decode_attn", B,
                                         Hkv, G, S, D, Dv, dt))
    return out


unfused_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# fused GQA decode attention over the paged pool (inference-only)
# ---------------------------------------------------------------------------


def _check_paged_decode_attn(q, k_pool, v_pool, pages, cur_pos):
    what = "fused_paged_decode_attention"
    B, Hq, S1, _ = q.shape
    Hkv, ps = k_pool.shape[1], k_pool.shape[2]
    if S1 != 1:
        raise ValueError(
            f"{what}: q {tuple(q.shape)} must carry exactly one query token")
    if Hq % Hkv != 0:
        raise ValueError(f"{what}: Hq={Hq} not a multiple of Hkv={Hkv}")
    if ps % 8 != 0:
        raise ValueError(
            f"{what}: page_size={ps} must be a multiple of 8 (f32 sublane "
            "tiling) — use the oracle path or pick a multiple-of-8 "
            "--page-size")
    if pages.shape[0] != B or tuple(cur_pos.shape) != (B,):
        raise ValueError(
            f"{what}: pages {tuple(pages.shape)} / cur_pos "
            f"{tuple(cur_pos.shape)} do not match q batch {B}")
    if v_pool.shape[:3] != k_pool.shape[:3]:
        raise ValueError(f"{what}: pools k {tuple(k_pool.shape)} / v "
                         f"{tuple(v_pool.shape)} differ")


def gqa_paged_decode_attn_plain(q, k_pool, v_pool, pages, cur_pos,
                                window: int = 0) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch: slot b's row p is
    pool page ``pages[b, p // ps]`` at offset ``p % ps``; rows in a page
    the table does not hold (-1) are skipped, as the kernel skips them,
    and otherwise as :func:`gqa_decode_attn_plain`."""
    from repro_torch.layers.attention import gather_paged_kv
    B, Hq, _, D = q.shape
    num_pages, Hkv, ps = k_pool.shape[:3]
    Dv = v_pool.shape[3]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    ok = paged_attended_rows(pages, ps, num_pages, cur_pos, window)
    out = _gqa_attend(qg, gather_paged_kv(k_pool, pages),
                      gather_paged_kv(v_pool, pages), ok,
                      1.0 / math.sqrt(D))
    return out.reshape(B, Hq, 1, Dv).to(q.dtype)


def fused_paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, *,
                                 pages: torch.Tensor, cur_pos: torch.Tensor,
                                 window: int = 0, out=None) -> torch.Tensor:
    """Fused GQA decode attention over the block-paged KV pool.

    q [B, Hq, 1, D]; pools [num_pages, Hkv, page_size, D] /
    [num_pages, Hkv, page_size, Dv]; pages int [B, pages_per_slot] (-1 =
    unallocated); cur_pos [B]. Same ragged-position contract as
    :func:`fused_decode_attention`; unallocated pages are never read.
    Returns [B, Hq, 1, Dv] in q.dtype (into ``out`` when given, on the
    card). Inference-only.
    """
    what = "fused_paged_decode_attention"
    _check_paged_decode_attn(q, k_pool, v_pool, pages, cur_pos)
    if not q.is_cuda:
        return gqa_paged_decode_attn_plain(q, k_pool, v_pool, pages,
                                           cur_pos, window)
    B, Hq, _, D = q.shape
    num_pages, Hkv, ps = k_pool.shape[:3]
    Dv, pps = v_pool.shape[3], pages.shape[1]
    G = Hq // Hkv
    _check_widths(what, **{"k_pool head dim": (k_pool.shape[3], D)})
    dt, _ = _kernel_args(what, (q, k_pool, v_pool))
    pt = _int32_on(pages, q.device, what, "pages")
    cur = _int32_on(cur_pos, q.device, what, "cur_pos")
    ranges, part_ml, part_acc = _gqa_partials(B, Hkv, G, pps * ps, Dv,
                                              q.device)
    out = _out(out, (B, Hq, 1, Dv), q)
    # copies held to the launch (a dropped one's memory can go to the next)
    q_c, k_pool_c, v_pool_c = (q.contiguous(), k_pool.contiguous(),
                               v_pool.contiguous())
    err = _build.library().lib.repro_gqa_paged_decode_attn(
        q_c.data_ptr(), k_pool_c.data_ptr(),
        v_pool_c.data_ptr(), pt.data_ptr(), cur.data_ptr(),
        part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, Hkv, G, num_pages, ps, pps, D, Dv,
        1.0 / math.sqrt(D), int(window), ranges, dt, _stream(q.device))
    _build.check(err, what)
    _launched(fused_paged_decode_attention,
              ("repro_gqa_paged_decode_attn", B, Hkv, G, D, Dv, ranges, dt))
    return out


fused_paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# fused absorbed-MLA decode attention, slot cache and paged pool
# (inference-only)
# ---------------------------------------------------------------------------


def _mla_attend(q_abs, q_rope, lat, rope, ok, scale):
    """Masked f32 absorbed-MLA attention shared by the MLA plain
    versions: q_abs [B, H, R], q_rope [B, H, Dr], lat [B, S, R], rope
    [B, S, Dr], ok [B, S]. Rows outside ``ok`` are zeroed before use; a
    slot with no row gets zeros. Returns f32 [B, H, R]."""
    okr = ok[:, :, None]
    lat = torch.where(okr, lat.float(), torch.zeros((), device=lat.device))
    rope = torch.where(okr, rope.float(),
                       torch.zeros((), device=rope.device))
    s = (torch.einsum("bhr,bsr->bhs", q_abs.float(), lat)
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), rope)) * scale
    ok = ok[:, None, :]
    s = torch.where(ok, s, torch.full_like(s, -math.inf))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhs,bsr->bhr", p, lat) / torch.clamp(l, min=1e-30)


#: cache rows per block of mla_decode_attn.cu (kRows), counted from row 0
MLA_ROWS = 64


def _mla_partials(B: int, H: int, R: int, length: int, device):
    """Host side of the MLA decode kernels' grid (#5 over a slot cache
    of ``length`` rows, #6 over a page table of ``length`` = pps * ps
    rows): ``ranges`` = ceil(length / MLA_ROWS) blocks of rows per slot,
    enough for a slot that attends every row, and the f32 scratch of one
    partial (m, l, acc) per (slot, range, head). Shapes only: which
    ranges hold rows is worked out from cur_pos on the device, so nothing
    here reads a tensor."""
    ranges = -(-length // MLA_ROWS)
    part_ml, part_acc = _decode_scratch(B * ranges * H, R, device)
    return ranges, part_ml, part_acc


def _check_q_rope(what, q_nope_abs, q_rope):
    B, H, _ = q_nope_abs.shape
    if tuple(q_rope.shape[:2]) != (B, H):
        raise ValueError(f"{what}: q_rope {tuple(q_rope.shape)} must lead "
                         f"with [B={B}, H={H}]")


def mla_decode_attn_plain(q_nope_abs, q_rope, latent_cache, rope_cache,
                          cur_pos, head_dim_for_scale: int) -> torch.Tensor:
    """The MLA kernel's function in plain PyTorch (f32 out)."""
    ok = attended_rows(latent_cache.shape[1], cur_pos,
                  device=q_nope_abs.device)
    return _mla_attend(q_nope_abs, q_rope, latent_cache, rope_cache, ok,
                       1.0 / math.sqrt(head_dim_for_scale))


def fused_mla_decode_attention(q_nope_abs: torch.Tensor,
                               q_rope: torch.Tensor,
                               latent_cache: torch.Tensor,
                               rope_cache: torch.Tensor, *,
                               cur_pos: torch.Tensor,
                               head_dim_for_scale: int,
                               out=None) -> torch.Tensor:
    """Fused absorbed-MLA decode attention against the compressed latent.

    Same contract as ``layers.attention.mla_decode_attention``:
    q_nope_abs [B, H, R]; q_rope [B, H, Dr]; latent_cache [B, S, R];
    rope_cache [B, S, Dr]; returns f32 [B, H, R] (into ``out`` when
    given, on the card). Inference-only.
    """
    what = "fused_mla_decode_attention"
    B, H, R = q_nope_abs.shape
    Dr = q_rope.shape[2]
    _check_q_rope(what, q_nope_abs, q_rope)
    if latent_cache.shape[0] != B or \
            rope_cache.shape[:2] != latent_cache.shape[:2]:
        raise ValueError(
            f"{what}: caches latent {tuple(latent_cache.shape)} / rope "
            f"{tuple(rope_cache.shape)} do not match batch {B}")
    if tuple(cur_pos.shape) != (B,):
        raise ValueError(f"{what}: cur_pos {tuple(cur_pos.shape)} must be "
                         f"[{B}]")
    if not q_nope_abs.is_cuda:
        return mla_decode_attn_plain(q_nope_abs, q_rope, latent_cache,
                                     rope_cache, cur_pos, head_dim_for_scale)
    S = latent_cache.shape[1]
    _check_widths(what, **{"latent width": (latent_cache.shape[2], R),
                           "rope width": (rope_cache.shape[2], Dr)})
    dt, _ = _kernel_args(what, (q_nope_abs, q_rope, latent_cache,
                                rope_cache))
    cur = _int32_on(cur_pos, q_nope_abs.device, what, "cur_pos")
    ranges, part_ml, part_acc = _mla_partials(B, H, R, S,
                                              q_nope_abs.device)
    out = _out(out, (B, H, R), q_nope_abs, torch.float32)
    # copies held to the launch (a dropped one's memory can go to the next)
    q_nope_abs_c, q_rope_c, latent_cache_c, rope_cache_c = (
        q_nope_abs.contiguous(), q_rope.contiguous(),
        latent_cache.contiguous(), rope_cache.contiguous())
    err = _build.library().lib.repro_mla_decode_attn(
        q_nope_abs_c.data_ptr(), q_rope_c.data_ptr(),
        latent_cache_c.data_ptr(),
        rope_cache_c.data_ptr(), cur.data_ptr(),
        part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, H, R, Dr, S, 1.0 / math.sqrt(head_dim_for_scale),
        ranges, dt, _stream(q_nope_abs.device))
    _build.check(err, what)
    _launched(fused_mla_decode_attention,
              ("repro_mla_decode_attn", B, H, R, Dr, ranges, 0, dt))
    return out


fused_mla_decode_attention.launches = 0


def mla_paged_decode_attn_plain(q_nope_abs, q_rope, latent_pool, rope_pool,
                                pages, cur_pos,
                                head_dim_for_scale: int) -> torch.Tensor:
    """The paged MLA kernel's function in plain PyTorch (f32 out): rows
    in a page the table does not hold are skipped."""
    from repro_torch.layers.attention import gather_paged_rows
    num_pages, ps = latent_pool.shape[:2]
    ok = paged_attended_rows(pages, ps, num_pages, cur_pos)
    return _mla_attend(q_nope_abs, q_rope,
                       gather_paged_rows(latent_pool, pages),
                       gather_paged_rows(rope_pool, pages), ok,
                       1.0 / math.sqrt(head_dim_for_scale))


def fused_paged_mla_decode_attention(q_nope_abs: torch.Tensor,
                                     q_rope: torch.Tensor,
                                     latent_pool: torch.Tensor,
                                     rope_pool: torch.Tensor, *,
                                     pages: torch.Tensor,
                                     cur_pos: torch.Tensor,
                                     head_dim_for_scale: int,
                                     out=None) -> torch.Tensor:
    """Fused absorbed-MLA decode attention over the paged latent pool.

    q_nope_abs [B, H, R]; q_rope [B, H, Dr]; pools
    [num_pages, page_size, R] / [num_pages, page_size, Dr]; pages
    [B, pages_per_slot] (-1 = unallocated); returns f32 [B, H, R] (into
    ``out`` when given, on the card). Inference-only.
    """
    what = "fused_paged_mla_decode_attention"
    B, H, R = q_nope_abs.shape
    Dr = q_rope.shape[2]
    num_pages, ps = latent_pool.shape[:2]
    _check_q_rope(what, q_nope_abs, q_rope)
    if ps % 8 != 0:
        raise ValueError(
            f"{what}: page_size={ps} must be a multiple of 8 — use the "
            "oracle path or a multiple-of-8 --page-size")
    if pages.shape[0] != B or tuple(cur_pos.shape) != (B,):
        raise ValueError(
            f"{what}: pages {tuple(pages.shape)} / cur_pos "
            f"{tuple(cur_pos.shape)} do not match batch {B}")
    if not q_nope_abs.is_cuda:
        return mla_paged_decode_attn_plain(q_nope_abs, q_rope, latent_pool,
                                           rope_pool, pages, cur_pos,
                                           head_dim_for_scale)
    pps = pages.shape[1]
    _check_widths(what, **{"latent width": (latent_pool.shape[2], R),
                           "rope width": (rope_pool.shape[2], Dr),
                           "rope pool pages": (tuple(rope_pool.shape[:2]),
                                               (num_pages, ps))})
    dt, _ = _kernel_args(what, (q_nope_abs, q_rope, latent_pool, rope_pool))
    pt = _int32_on(pages, q_nope_abs.device, what, "pages")
    cur = _int32_on(cur_pos, q_nope_abs.device, what, "cur_pos")
    ranges, part_ml, part_acc = _mla_partials(B, H, R, pps * ps,
                                              q_nope_abs.device)
    out = _out(out, (B, H, R), q_nope_abs, torch.float32)
    # copies held to the launch (a dropped one's memory can go to the next)
    q_nope_abs_c, q_rope_c, latent_pool_c, rope_pool_c = (
        q_nope_abs.contiguous(), q_rope.contiguous(),
        latent_pool.contiguous(), rope_pool.contiguous())
    err = _build.library().lib.repro_mla_paged_decode_attn(
        q_nope_abs_c.data_ptr(), q_rope_c.data_ptr(),
        latent_pool_c.data_ptr(),
        rope_pool_c.data_ptr(), pt.data_ptr(), cur.data_ptr(),
        part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, H, R, Dr, num_pages, ps, pps,
        1.0 / math.sqrt(head_dim_for_scale), ranges, dt,
        _stream(q_nope_abs.device))
    _build.check(err, what)
    _launched(fused_paged_mla_decode_attention,
              ("repro_mla_decode_attn", B, H, R, Dr, ranges, 1, dt))
    return out


fused_paged_mla_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

KERNEL_WRAPPERS = (block_pruned_matmul, fused_pruned_ffn,
                   fused_decode_attention, pruned_matmul_dx, pruned_matmul_dw,
                   outpruned_matmul, outpruned_matmul_dx, outpruned_matmul_dw,
                   fused_paged_decode_attention, fused_mla_decode_attention,
                   fused_paged_mla_decode_attention, unfused_decode_attention)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
