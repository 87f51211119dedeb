"""#3's hidden stage (``fused_pruned_ffn``): h = act(x @ w_gate[:, keep])
* (x @ w_up[:, keep]), ungated act(x @ w_up[:, keep]), compact, cast to
w_down's dtype; then the block-pruned down product reads h.

Up to ``BPM_DECODE_MAX_ROWS`` rows of x (the serving slots and a prefill
chunk) the stage runs the decode kernel of ``csrc/fused_pruned_ffn.cu``;
above them the tensor-core core of ``csrc/pruned_grad.cu``
(``FfnPolicy`` / ``FfnGatedPolicy``). The down product routes on the same
constant, so #3 has one threshold.

On the CPU: the route as a function of M, the split counts at the serving
and train shapes, the decode kernel's constants read from its source, and
numpy models of both schedules' f32 arithmetic, each followed by the
existing model of the down product on the same route and held against
the JAX package's ``fused_ffn_2d`` in interpret mode within 1e-5 * max
|ref|:

* the tensor-core core: ``test_torch_tc_core``'s split 3xTF32 model of
  #10's product (stages of ``TC_DEPTH``, ranges summed in order), for
  w_up and w_gate, the activation applied after the ranges' sum;
* the decode kernel: the schedule of #2's decode kernel
  (``test_torch_tc_opdx``) with the contraction dense and the columns
  through the keep map, 16-row chunks, chunk c of a range on the column
  group's warp c % 4, each chunk two 3xTF32 k-steps, the 4 warps summed
  in order, then the ranges in order; the activation after.

On the card (``cuda`` marker, skipped here): #3 against its plain version
at M = 1, 8, 16, 17, 64 and 520, gated and ungated, blocks 6 (the
element-wise path), 8, 64 and 128, unsorted keep ids, strided views, f32
(<= 1e-4 * max |ref|) and bf16 (<= 2e-2 * max |ref|: the hidden and the
output are rounded to bf16 once each); the launches name the route's
function; a second call gives the same bits. The JAX package and the
model helpers (whose files import it) are imported inside the CPU tests
only, so this file also runs on a machine with the card and no JAX.
Inputs from fixed numpy seeds.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

H100_SMS = 132
CSRC = Path(tops.__file__).with_name("csrc")
DECODE_SOURCE = CSRC / "fused_pruned_ffn.cu"
CORE_SOURCE = CSRC / "pruned_grad.cu"


def _sms(monkeypatch):
    monkeypatch.setattr(tops, "_num_sms", lambda index: H100_SMS)


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


class _FakeLib:
    """Records which C entry points a wrapper calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


@pytest.mark.parametrize("M", [1, 8, 16, 17, 70, 520])
@pytest.mark.parametrize("gated", [False, True])
def test_route_by_rows(M, gated, monkeypatch):
    """The decode kernel up to BPM_DECODE_MAX_ROWS (16) rows of x, the
    tensor-core core above, and the down product on the same side of the
    same threshold: a function of M alone, with no option. The config
    keys name the entries that ran."""
    assert tops.BPM_DECODE_MAX_ROWS == 16
    fake = _FakeLib()
    monkeypatch.setattr(tops._build, "library",
                        lambda: type("Lib", (), {"lib": fake})())
    monkeypatch.setattr(tops, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    _sms(monkeypatch)
    keep = torch.tensor([3, 0, 5], dtype=torch.int32)
    w = torch.zeros((64, 48))
    y, (hidden, down) = tops._launch_pruned_ffn(
        torch.zeros((M, 64)), w, torch.zeros((48, 40)), w if gated else None,
        keep, 1, 8, 0)
    assert tuple(y.shape) == (M, 40)
    decode = M <= 16
    want = ("repro_pruned_ffn_hidden" if decode
            else "repro_pruned_ffn_hidden_tc",
            "repro_block_pruned_matmul" if decode
            else "repro_block_pruned_matmul_tc")
    assert tuple(fake.calls) == want == (hidden[0], down[0])
    assert hidden[1:6] == (M, 64, 3, 8, int(gated)) and hidden[-1] == 0


# (what, M, K, kept columns, splits)
SPLITS = [
    ("Yi serve, 8 slots, keep 75/86", 8, 4096, 75 * 128, 3),
    ("Yi serve, one slot, keep 75/86", 1, 4096, 75 * 128, 3),
    ("Yi prefill chunk of 16, keep 75/86", 16, 4096, 75 * 128, 2),
    ("Yi serve, keep 1/86", 8, 4096, 128, 32),
    ("block 8 smoke, keep 40/64", 8, 256, 320, 2),
]


@pytest.mark.parametrize("what,M,K,C,want", SPLITS,
                         ids=[s[0] for s in SPLITS])
def test_decode_splits_at_the_serving_shapes(what, M, K, C, want,
                                             monkeypatch):
    """As many ranges as keep every block resident at once, two per SM
    over the 128-column and 8-row tiles: 75 column tiles take 3 ranges
    (225 blocks of 264); at least K / FFN_X_ROWS (a range's x fits its
    stage: 2 at 16 rows, whose 150 tiles alone would take one), at most
    as many as leave each of a column group's 4 warps two chunks of 16
    rows (one kept block: 32)."""
    _sms(monkeypatch)
    splits = tops._ffn_decode_splits(M, K, C, torch.device("cpu", 0))
    assert splits == want
    chunks = -(-K // tops.BPM_ROWS)
    assert -(-K // tops.FFN_X_ROWS) <= splits
    assert -(-chunks // splits) >= 2 * tops.FFN_CHUNK_WARPS
    tiles = -(-C // tops.FFN_COLS) * -(-M // tops.BPM_SLOTS)
    assert splits * tiles <= 2 * H100_SMS or splits == -(-K //
                                                          tops.FFN_X_ROWS)


def test_tensor_core_splits_at_the_train_shape(monkeypatch):
    """ViT-1B at tp 4 (x [520, 2048], keep 30/256 blocks of 8: h [520,
    240]): #10's 36 tiles take 8 ranges of 8 stages, summed (with the
    activation) by ffn_hidden_act_kernel; 17 rows of the Yi serving
    shape fill the card with 300 tiles and two ranges."""
    _sms(monkeypatch)
    dev = torch.device("cpu", 0)
    assert tops._tc_split_count(520, 240, 2048, dev) == 8
    assert tops._tc_split_count(17, 75 * 128, 4096, dev) == 2
    assert tops._tc_partials(520, 240, 2048, dev)[0] == 8


def test_decode_kernel_constants_match_its_source():
    """A warp's tile is #2's (64 columns of 8 lanes g, 16 rows of 4 lanes
    tg, 8 rows of x as the mma's n); a block's 8 warps cover two groups
    of 64 columns, 4 warps down each; the ring holds 16 16-byte loads a
    lane, a gated chunk two units of it; the x stage's pitch keeps the
    fragment loads on distinct banks; at FFN_X_ROWS rows in f32 a block
    needs 66 KB of shared memory (the gated warps' sums 32 KB), so two
    blocks fit an SM."""
    src = DECODE_SOURCE.read_text()
    assert _const(src, "kCols") == tops.FFN_COLS == 2 * tops.BPM_COLS
    assert _const(src, "kGroups") == 2
    assert "kChunkWarps = kWarps / kGroups;" in src
    assert tops.FFN_CHUNK_WARPS == tops.BPM_WARPS // 2
    assert _const(src, "kRows") == tops.BPM_ROWS == 16
    assert _const(src, "kSlots") == tops.BPM_SLOTS == 8
    assert _const(src, "kWarps") == tops.BPM_WARPS == 8
    assert "kDepth = 16 / kRegs;" in src and "kUnits = G ? 2 : 1;" in src
    assert "return (rows + 63) / 64 * 64 + 16;" in src
    pitch = (tops.FFN_X_ROWS + 63) // 64 * 64 + 16
    for size, vec in ((2, 8), (4, 4)):
        # a warp's 8 rows of x at distinct 32-byte (bf16) / 64-byte (f32)
        # offsets within 128 bytes, per phase of the shared load
        assert (pitch * size) % 128 in (32, 64, 96) and pitch % vec == 0
    x_stage = tops.BPM_SLOTS * pitch * 4
    red_gated = 2 * tops.BPM_WARPS * 16 * 32 * 4
    assert x_stage == 66048 and red_gated == 32768
    assert 2 * max(x_stage, red_gated) <= 227 * 1024
    assert "__launch_bounds__(kThreads, 2)" in src
    assert "ffn_hidden_partial_kernel" not in src


def test_gated_core_ring_fits_two_blocks():
    """The gated policy adds a second B ring ([32][64 + 8] a stage) beside
    A's and w_up's: 82 944 bytes in f32 (55 296 without it), 43 008 in
    bf16; two blocks still fit one SM's 228 KB."""
    src = CORE_SOURCE.read_text()
    assert "kStage = kA + (Policy::GATED ? 2 : 1) * kB;" in src
    stages, rows, depth = _const(src, "kTcStages"), tops.TC_TILE, \
        tops.TC_DEPTH
    for size, want in ((4, 82944), (2, 43008)):
        vec = 16 // size
        a = rows * (depth + vec)
        b = depth * (rows + 8)
        assert stages * (a + b) * size == {4: 55296, 2: 29184}[size]
        assert stages * (a + 2 * b) * size == want
        assert 2 * want <= 228 * 1024
    for policy in ("FfnPolicy", "FfnGatedPolicy"):
        assert f'kName = "{policy}"' in src


def _act(v, gelu):
    v = v.astype(np.float32)
    if gelu:
        k0 = np.float32(0.7978845608028654)
        return (np.float32(0.5) * v * (np.float32(1) + np.tanh(
            k0 * (v + np.float32(0.044715) * v * v * v)))).astype(np.float32)
    return (v / (np.float32(1) + np.exp(-v))).astype(np.float32)


def _operands(rng, gated, block, nb, kb, unsorted, M, K):
    """x, w_up, w_gate (or None), w_down [H, N], keep, and the gathered
    w_up / w_gate columns [K, C] and w_down rows [C, N]."""
    H, N = nb * block, 48
    keep = rng.choice(nb, size=kb, replace=False).astype(np.int32)
    keep = keep if unsorted else np.sort(keep)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w_up = (rng.standard_normal((K, H)) * 0.1).astype(np.float32)
    w_gate = ((rng.standard_normal((K, H)) * 0.1).astype(np.float32)
              if gated else None)
    w_down = (rng.standard_normal((H, N)) * 0.1).astype(np.float32)

    def cols(w):
        return w.reshape(K, nb, block)[:, keep].reshape(K, kb * block)
    return (x, w_up, w_gate, w_down, keep, cols(w_up),
            cols(w_gate) if gated else None,
            w_down.reshape(nb, block, N)[keep].reshape(kb * block, N))


def _reference(x, w_up, w_gate, w_down, keep, block, gelu):
    import jax
    import jax.numpy as jnp
    from repro.kernels import pruned_matmul as jpk
    return np.asarray(jpk.fused_ffn_2d(
        jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down),
        jnp.asarray(keep), None if w_gate is None else jnp.asarray(w_gate),
        act_fn=jax.nn.gelu if gelu else jax.nn.silu, block=block,
        tm=x.shape[0], interpret=True))


def _ffn_decode_model(a: np.ndarray, b: np.ndarray,
                      splits: int) -> np.ndarray:
    """The decode kernel's f32 product of x [M <= 16, K] and the kept
    columns b [K, C]: 16-row chunks, each two 3xTF32 k-steps (lane tg's
    rows 4tg + 2q and 4tg + 2q + 1 in step q); chunk c of a range on the
    column group's warp c % 4, each warp's chunks in order; the 4 warps
    summed in order, then the ranges in order."""
    from test_torch_tc_core import _three_tf32
    K = a.shape[1]
    chunks = -(-K // tops.BPM_ROWS)
    per = -(-chunks // splits)
    steps = [np.array([4 * tg + 2 * q + d for tg in range(4) for d in (0, 1)])
             for q in (0, 1)]
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for lo in range(0, chunks, per):
        warps = np.zeros((tops.FFN_CHUNK_WARPS,) + out.shape, np.float32)
        for c in range(lo, min(chunks, lo + per)):
            for rows in steps:
                t = c * tops.BPM_ROWS + rows
                t = t[t < K]
                warps[(c - lo) % tops.FFN_CHUNK_WARPS] += _three_tf32(
                    np.ascontiguousarray(a[:, t]), b[t])
        total = np.zeros_like(out)
        for w in warps:
            total += w
        out += total
    return out


def _hidden(model, x, up, gate, gelu, splits):
    """The stage's f32 arithmetic: each product through the schedule's
    model, then the activation (the one range's epilogue and the sum's
    pass apply it to the same sums)."""
    u = model(x, up, splits)
    if gate is None:
        return _act(u, gelu)
    return _act(model(x, gate, splits), gelu) * u


# (gated, gelu, block, nb, kb, unsorted, M, K): the tensor-core route
# (M > 16; contractions ending mid-stage, ragged column tiles)
TC_CASES = [
    (True, False, 8, 32, 6, True, 70, 96),
    (False, True, 8, 16, 5, False, 40, 64),
    (True, False, 128, 3, 2, False, 17, 200),
    (False, True, 128, 4, 2, True, 24, 256),
]


@pytest.mark.parametrize("gated,gelu,block,nb,kb,unsorted,M,K", TC_CASES)
def test_tensor_core_model_matches_jax(gated, gelu, block, nb, kb, unsorted,
                                       M, K, monkeypatch):
    """Above 16 rows: the hidden stage through the core's split 3xTF32
    model at the wrapper's split count (B read through the keep map, A =
    x dense), then the down product's model on the core (x_compact),
    against fused_ffn_2d."""
    from test_torch_tc_core import _close, _tc_model
    rng = np.random.default_rng(80 + block + nb + kb + M + gated)
    x, w_up, w_gate, w_down, keep, up, gate, wd = _operands(
        rng, gated, block, nb, kb, unsorted, M, K)
    ref = _reference(x, w_up, w_gate, w_down, keep, block, gelu)
    _sms(monkeypatch)
    dev = torch.device("cpu", 0)
    C = kb * block
    h = _hidden(_tc_model, x, up, gate, gelu,
                tops._tc_split_count(M, C, K, dev))
    down_splits, _ = tops._tc_partials(M, wd.shape[1], C, dev, direct=True)
    _close(_tc_model(h, wd, down_splits), ref)


# the decode route (M <= 16): blocks 8 and 128, the block 6 of the
# element-wise path, K ending mid-chunk
DECODE_CASES = [
    (True, False, 128, 4, 3, True, 8, 256),
    (False, True, 8, 32, 7, True, 1, 96),
    (True, False, 8, 16, 4, False, 16, 136),
    (False, True, 6, 12, 5, False, 5, 64),
]


@pytest.mark.parametrize("gated,gelu,block,nb,kb,unsorted,M,K",
                         DECODE_CASES)
def test_decode_model_matches_jax(gated, gelu, block, nb, kb, unsorted, M,
                                  K, monkeypatch):
    """At or below 16 rows: the hidden stage through the decode kernel's
    chunked, warp-ordered 3xTF32 model at the wrapper's range count and
    at 3 ranges (summed in order by the second pass), then the down
    product's decode-kernel model (#2's, x_compact), against
    fused_ffn_2d."""
    from test_torch_tc_core import _close
    from test_torch_tc_opdx import _decode_model
    rng = np.random.default_rng(90 + block + nb + kb + M + gated)
    x, w_up, w_gate, w_down, keep, up, gate, wd = _operands(
        rng, gated, block, nb, kb, unsorted, M, K)
    ref = _reference(x, w_up, w_gate, w_down, keep, block, gelu)
    _sms(monkeypatch)
    dev = torch.device("cpu", 0)
    C = kb * block
    down_splits = tops._bpm_decode_splits(M, wd.shape[1], C, dev)
    for splits in (tops._ffn_decode_splits(M, K, C, dev), 3):
        h = _hidden(_ffn_decode_model, x, up, gate, gelu, splits)
        _close(_decode_model(h, wd, down_splits), ref)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 16, 17, 64, 520])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_pruned_ffn_matches_plain(cuda_device, M, dtype):
    """Each route, gated and ungated, at blocks 6, 8, 64 and 128 with
    unsorted keep ids, on contiguous operands and on strided views (x a
    column slice, the weights transposed copies read back transposed):
    within the tolerance of the plain version, the launches naming the
    route's function, and a second call with the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(M)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda_device)
                * scale).to(dtype)

    tol = 1e-4 if dtype == torch.float32 else 2e-2
    K, N = 200, 72
    names = []
    prev = tops.set_launch_hook(
        lambda name, launches: names.extend(ln.fn for ln in launches))
    try:
        for block, nb, kb in ((6, 20, 7), (8, 32, 9), (64, 5, 3),
                              (128, 4, 2)):
            H = nb * block
            keep = torch.randperm(nb, generator=torch.Generator().manual_seed(
                block))[:kb].to(torch.int32).to(cuda_device)
            for gated, strided in ((True, False), (False, True),
                                   (True, True), (False, False)):
                x = rnd(M, 2 * K)[:, ::2] if strided else rnd(M, K)
                w_up = (rnd(H, K, scale=0.1).t() if strided
                        else rnd(K, H, scale=0.1))
                w_gate = (rnd(K, H, scale=0.1) if gated else None)
                w_down = rnd(H, N, scale=0.1)
                act = tops.silu if gated else tops.gelu
                names.clear()
                got = tops.fused_pruned_ffn(x, w_up, w_down, keep, w_gate,
                                            act, block)
                again = tops.fused_pruned_ffn(x, w_up, w_down, keep, w_gate,
                                              act, block)
                ref = tops.fused_pruned_ffn_plain(x, w_up, w_down, keep,
                                                  w_gate, act, block)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                assert err <= tol * float(ref.float().abs().max()), (
                    block, gated, strided, err)
                assert torch.equal(got, again), (block, gated, strided)
                hidden = names[0]
                if M <= tops.BPM_DECODE_MAX_ROWS:
                    assert hidden.startswith("ffn_hidden_decode_kernel<"), \
                        names
                    assert hidden.endswith(f",{int(gated)}>")
                else:
                    policy = "FfnGatedPolicy" if gated else "FfnPolicy"
                    assert hidden.startswith(
                        f"pruned_gemm_tc_kernel<{policy},"), names
    finally:
        tops.set_launch_hook(prev)
