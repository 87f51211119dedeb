"""Public wrappers of the port's CUDA kernels, with their plain versions
(port of ``repro.kernels.ops``, forward only).

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

Kernels (see each source's header for what bounds it on the H100):

========================  ==============================  ==========================================
wrapper                   CUDA source                     TPU kernel it replaces
========================  ==============================  ==========================================
block_pruned_matmul       csrc/block_pruned_matmul.cu     kernels/pruned_matmul.py:block_pruned_matmul_2d
fused_pruned_ffn          csrc/fused_pruned_ffn.cu (+ the kernels/pruned_matmul.py:fused_ffn_2d
                          block-pruned product)
fused_decode_attention    csrc/gqa_decode_attn.cu         kernels/decode_attn.py:gqa_decode_attn_2d
========================  ==============================  ==========================================

None of these defines a gradient: this slice serves, and the backward
kernels of the pruned family come with the training slice.
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


def _splits(limit: int, blocks_per_split_unit: int, device) -> int:
    """How many contraction ranges to spread across grid.z so that about
    four blocks per SM are in flight (at most ``limit``)."""
    target = 4 * _num_sms(device.index if device.index is not None
                          else torch.cuda.current_device())
    return max(1, min(limit, -(-target // max(blocks_per_split_unit, 1))))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# block-pruned matmul (contraction pruning)
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


def _launch_block_pruned(x2d, w, keep, block, dt, *, x_compact=False,
                         K=None):
    """Run the CUDA kernel; ``x_compact`` reads x as [M, kb*block]."""
    M = x2d.shape[0]
    N = w.shape[1]
    K = w.shape[0] if K is None else K
    kb = keep.shape[0]
    lib = _build.library().lib
    splits = _splits(kb, -(-N // 128) * -(-M // 8), x2d.device)
    partial = torch.empty((splits, M, N), dtype=torch.float32,
                          device=x2d.device)
    y = torch.empty((M, N), dtype=x2d.dtype, device=x2d.device)
    err = lib.repro_block_pruned_matmul(
        x2d.data_ptr(), w.data_ptr(), keep.data_ptr(), partial.data_ptr(),
        y.data_ptr(), M, K, N, kb, block, int(x_compact), splits, dt,
        _stream(x2d.device))
    _build.check(err, "block_pruned_matmul")
    return y


def block_pruned_matmul(x: torch.Tensor, w: torch.Tensor,
                        keep_idx: torch.Tensor,
                        block: int = 128) -> torch.Tensor:
    """y = x[..., keep] @ w[keep, :].

    x: [..., K]; w: [K, N]; keep_idx: [kb] integer block ids (sorted).
    """
    *lead, K = x.shape
    _validate(K, w.shape[0], keep_idx, block, "block_pruned_matmul")
    x2d = x.reshape(-1, K)
    if x.is_cuda:
        dt, keep = _kernel_args("block_pruned_matmul", (x2d, w), keep_idx)
        y = _launch_block_pruned(x2d.contiguous(), w.contiguous(), keep,
                                 block, dt)
        block_pruned_matmul.launches += 1
    else:
        y = block_pruned_matmul_plain(x2d, w, keep_idx, block)
    return y.reshape(*lead, w.shape[1])


block_pruned_matmul.launches = 0


# ---------------------------------------------------------------------------
# pruned FFN pair
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


def fused_pruned_ffn(x: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, keep_idx: torch.Tensor,
                     w_gate=None, act_fn=None,
                     block: int = 128) -> torch.Tensor:
    """Controlled FFN pair y = act(x @ Wup[:, keep] [, · gate]) @
    Wdown[keep, :].

    x: [..., K]; w_up/w_gate: [K, H]; w_down: [H, d_out]; keep_idx: [kb]
    kept H-block ids. On the card: the compact hidden stage
    (``csrc/fused_pruned_ffn.cu``) then the block-pruned down product;
    ``act_fn`` must be :func:`silu` or :func:`gelu`.
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
    x2d = x.reshape(-1, K)
    if x.is_cuda:
        if act_fn not in ACT_CODES:
            raise ValueError(
                f"fused_pruned_ffn: activation {act_fn!r} has no kernel "
                "code; use repro_torch.kernels.ops.silu or .gelu")
        ops_ = (x2d, w_up, w_down) + ((w_gate,) if w_gate is not None else ())
        dt, keep = _kernel_args("fused_pruned_ffn", ops_, keep_idx)
        y = _launch_pruned_ffn(x2d.contiguous(), w_up.contiguous(),
                               w_down.contiguous(),
                               None if w_gate is None else w_gate.contiguous(),
                               keep, ACT_CODES[act_fn], block, dt)
        fused_pruned_ffn.launches += 1
    else:
        y = fused_pruned_ffn_plain(x2d, w_up, w_down, keep_idx, w_gate,
                                   act_fn, block)
    return y.reshape(*lead, w_down.shape[1])


fused_pruned_ffn.launches = 0


def _launch_pruned_ffn(x2d, w_up, w_down, w_gate, keep, act, block, dt):
    M, K = x2d.shape
    H = w_up.shape[1]
    kb = keep.shape[0]
    C = kb * block
    dev = x2d.device
    lib = _build.library().lib
    splits = _splits(-(-K // 128), -(-C // 128) * -(-M // 8), dev)
    part_up = torch.empty((splits, M, C), dtype=torch.float32, device=dev)
    part_gate = (torch.empty_like(part_up) if w_gate is not None
                 else part_up)
    h = torch.empty((M, C), dtype=x2d.dtype, device=dev)
    err = lib.repro_pruned_ffn_hidden(
        x2d.data_ptr(), w_up.data_ptr(),
        None if w_gate is None else w_gate.data_ptr(), keep.data_ptr(),
        part_up.data_ptr(), part_gate.data_ptr(), h.data_ptr(),
        M, K, H, kb, block, splits, act, dt, _stream(dev))
    _build.check(err, "fused_pruned_ffn (hidden)")
    return _launch_block_pruned(h, w_down, keep, block, dt, x_compact=True,
                                K=w_down.shape[0])


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


def gqa_decode_attn_plain(q, k_cache, v_cache, cur_pos,
                          window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 scores and softmax
    over the positions p <= cur_pos (and > cur_pos - window); a slot with
    no such position gets zeros. q [B, Hq, 1, D] -> [B, Hq, 1, Dv]."""
    B, Hq, _, D = q.shape
    Hkv, S, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)[None, :]
    cur = cur_pos.to(torch.int64)[:, None]
    ok = pos <= cur
    if window > 0:
        ok = ok & (pos > cur - window)
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, torch.full_like(s, -math.inf))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, 1, Dv).to(q.dtype)


def fused_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, *, cur_pos: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """Fused GQA decode attention (one kernel, online softmax).

    Same contract as ``layers.attention.decode_attention``:
    q [B, Hq, 1, D]; caches [B, Hkv, S, D]/[B, Hkv, S, Dv]; cur_pos [B]
    int — attends cache positions p <= cur_pos[b] (windowed if set).
    Returns [B, Hq, 1, Dv] in q.dtype. Inference-only.
    """
    _check_decode_attn(q, k_cache, v_cache, cur_pos)
    if not q.is_cuda:
        return gqa_decode_attn_plain(q, k_cache, v_cache, cur_pos, window)
    B, Hq, _, D = q.shape
    Hkv, S, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    G = Hq // Hkv
    dt, _ = _kernel_args("fused_decode_attention", (q, k_cache, v_cache))
    if cur_pos.device != q.device:
        raise ValueError(
            f"fused_decode_attention: cur_pos lies on {cur_pos.device}, "
            f"q on {q.device}")
    cur = cur_pos.to(torch.int32).contiguous()
    qc = q.contiguous()
    kc, vc = k_cache.contiguous(), v_cache.contiguous()
    # split each slot's rows across blocks so that B*Hkv fills the card
    splits = _splits(-(-S // 32), B * Hkv, q.device)
    part_ml = torch.empty((2, B * Hkv * splits * G), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B * Hkv * splits * G * Dv,), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((B, Hkv, G, Dv), dtype=q.dtype, device=q.device)
    err = _build.library().lib.repro_gqa_decode_attn(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), cur.data_ptr(),
        part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, Hkv, G, S, D, Dv, 1.0 / math.sqrt(D),
        int(window), splits, dt, _stream(q.device))
    _build.check(err, "fused_decode_attention")
    fused_decode_attention.launches += 1
    return out.reshape(B, Hq, 1, Dv)


fused_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

KERNEL_WRAPPERS = (block_pruned_matmul, fused_pruned_ffn,
                   fused_decode_attention)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
