"""#1 (``fused_decode_attention``) and #4 (``fused_paged_decode_attention``)
in ``csrc/gqa_decode_attn.cu``, as far as the CPU can check them.

The kernel runs only on the card (``tests/test_torch_cuda.py``). Here: the
host's grid choice of both wrappers, the kernel's constants read from its
source, and a numpy model of the kernel's schedule held against the JAX
package's Pallas kernels in interpret mode (finite inputs) and against the
port's plain versions (NaN in every row the kernel must not read). The
model repeats what the kernel does in f32:

* a block per (slot, KV head, range) takes ``kRows`` rows counted from the
  tile that holds the slot's first attended row; a range past the slot's
  attended rows writes nothing;
* its warps own the 16-row tiles warp, warp + W, ... of the block's rows,
  each with its own online (m, l, acc) state in base 2, scores and P.V in
  the 3xTF32 form; a row outside [lo, hi] or in an absent page is zero
  and masked;
* the warps merge in warp order, then the ranges that hold rows merge in
  range order, one pass with a running maximum.

Tolerance: max |err| <= 1e-5 * max |ref| (f32 on both sides; the order of
the sums differs). Inputs from fixed numpy seeds.
"""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from test_torch_tc_core import H100_SMS, _three_tf32

torch.set_num_threads(1)

REL = 1e-5
INVALID = 2 ** 30
SOURCE = Path(tops.__file__).with_name("csrc") / "gqa_decode_attn.cu"
LOG2E = np.float32(1.4426950408889634)


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def _kernel_constants():
    src = SOURCE.read_text()
    rows = int(re.search(r"#define GQA_ROWS_PER_BLOCK (\d+)", src)[1])
    assert "constexpr int kRows = GQA_ROWS_PER_BLOCK;" in src
    return {"rows": rows, "tile": _const(src, "kTile"),
            "stages": _const(src, "kStages"), "warps": _const(src, "kWarps"),
            "group": _const(src, "kGroup")}


KERNEL = _kernel_constants()


# ---------------------------------------------------------------------------
# the numpy model of the kernel's schedule
# ---------------------------------------------------------------------------


def _span(cur: int, length: int, window: int):
    """The kernel's span_of: attended rows [lo, hi], the first row of the
    tile that holds lo, and the ranges of kRows rows that hold rows."""
    hi = min(cur, length - 1)
    lo = max(0, cur - window + 1) if window > 0 else 0
    first = lo // KERNEL["tile"] * KERNEL["tile"]
    ranges = (hi - first) // KERNEL["rows"] + 1 if hi >= lo else 0
    return lo, hi, first, ranges


def _warp_state(q, krows, vrows, ok, scale_log2):
    """One warp over its tiles: q [G, D] and per tile K [16, D], V [16,
    Dv] (zeros where a row is not read) and the mask of rows with data."""
    G, Dv = q.shape[0], vrows[0].shape[1]
    m = np.full(G, -np.inf, np.float32)
    l = np.zeros(G, np.float32)
    acc = np.zeros((G, Dv), np.float32)
    for kt, vt, okt in zip(krows, vrows, ok):
        s = _three_tf32(q, np.ascontiguousarray(kt.T)) * scale_log2
        s = np.where(okt[None, :], s, np.float32(-np.inf)).astype(np.float32)
        mn = np.maximum(m, s.max(axis=1))
        mu = np.where(np.isneginf(mn), np.float32(0), mn)
        corr = np.exp2(m - mu).astype(np.float32)
        p = np.exp2(s - mu[:, None]).astype(np.float32)
        l = (l * corr + p.sum(axis=1)).astype(np.float32)
        acc = (acc * corr[:, None] + _three_tf32(p, vt)).astype(np.float32)
        m = mn
    return m, l, acc


def _merge(states):
    """Merge the warps' (m, l, acc) states of a block in warp order, as
    the kernel does in shared memory: the largest m first, then the
    weighted sums; -inf marks a state with no row."""
    ms = np.stack([s[0] for s in states])
    M = ms.max(axis=0)
    L = np.zeros_like(states[0][1])
    A = np.zeros_like(states[0][2])
    for m, l, acc in states:
        w = np.where(np.isneginf(m) | np.isneginf(M), np.float32(0),
                     np.exp2(m - np.where(np.isneginf(M), 0, M)))
        w = w.astype(np.float32)
        L = (L + l * w).astype(np.float32)
        A = (A + acc * w[:, None]).astype(np.float32)
    return M, L, A


def _merge_ranges(states):
    """Merge the ranges' partials of a slot in range order, as the merge
    launch does: one pass, each rescaled into a running maximum."""
    G, Dv = states[0][2].shape
    M = np.full(G, -np.inf, np.float32)
    L = np.zeros(G, np.float32)
    A = np.zeros((G, Dv), np.float32)
    for m, l, acc in states:
        mn = np.maximum(M, m)
        live = ~np.isneginf(mn)
        safe = np.where(live, mn, 0)
        c = np.where(live, np.exp2(M - safe), 0).astype(np.float32)
        w = np.where(live, np.exp2(m - safe), 0).astype(np.float32)
        L = np.where(live, L * c + l * w, L).astype(np.float32)
        A = np.where(live[:, None], A * c[:, None] + acc * w[:, None],
                     A).astype(np.float32)
        M = mn
    return M, L, A


def _model_head(q, kslot, vslot, present, cur, window):
    """The kernel's schedule for one (slot, KV head): q [G, D]; the slot's
    rows kslot [L, D] / vslot [L, Dv] (as read through the row policy) and
    which of them exist (present [L]). Returns [G, Dv] f32."""
    G, D = q.shape
    length, Dv = kslot.shape[0], vslot.shape[1]
    scale_log2 = np.float32(1.0 / np.sqrt(D)) * LOG2E
    lo, hi, first, ranges = _span(cur, length, window)
    tile, W = KERNEL["tile"], KERNEL["warps"]
    parts = []
    for r in range(ranges):
        row0 = first + r * KERNEL["rows"]
        n_tiles = -(-(min(row0 + KERNEL["rows"], hi + 1) - row0) // tile)
        warps = []
        for w in range(W):
            kt, vt, okt = [], [], []
            for t in range(w, n_tiles, W):
                pos = row0 + t * tile + np.arange(tile)
                ok = (pos >= lo) & (pos <= hi)
                ok[ok] &= present[pos[ok]]
                idx = np.clip(pos, 0, length - 1)
                # a row the kernel does not read is a zero-filled copy
                kt.append(np.where(ok[:, None], kslot[idx], 0).astype(
                    np.float32))
                vt.append(np.where(ok[:, None], vslot[idx], 0).astype(
                    np.float32))
                okt.append(ok)
            if kt:
                warps.append(_warp_state(q, kt, vt, okt, scale_log2))
            else:
                warps.append((np.full(G, -np.inf, np.float32),
                              np.zeros(G, np.float32),
                              np.zeros((G, Dv), np.float32)))
        parts.append(_merge(warps))
    if not parts:
        return np.zeros((G, Dv), np.float32)
    _, L, A = _merge_ranges(parts)
    return (A / np.maximum(L, np.float32(1e-30))[:, None]).astype(np.float32)


def model_slot(q, k, v, cur, window):
    """#1: q [B, Hq, 1, D], k [B, Hkv, S, D], v [B, Hkv, S, Dv]."""
    B, Hq, _, D = q.shape
    Hkv, S, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D)
    out = np.zeros((B, Hkv, G, Dv), np.float32)
    for b in range(B):
        for h in range(Hkv):
            out[b, h] = _model_head(qg[b, h], k[b, h], v[b, h],
                                    np.ones(S, bool), int(cur[b]), window)
    return out.reshape(B, Hq, 1, Dv)


def model_paged(q, k_pool, v_pool, pages, cur, window):
    """#4: pools [num_pages, Hkv, ps, D|Dv] through pages [B, pps]."""
    B, Hq, _, D = q.shape
    num_pages, Hkv, ps = k_pool.shape[:3]
    Dv, pps = v_pool.shape[3], pages.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D)
    out = np.zeros((B, Hkv, G, Dv), np.float32)
    for b in range(B):
        pg = pages[b]
        present = np.repeat((pg >= 0) & (pg < num_pages), ps)
        safe = np.clip(pg, 0, num_pages - 1)
        for h in range(Hkv):
            ks = k_pool[safe, h].reshape(pps * ps, D)
            vs = v_pool[safe, h].reshape(pps * ps, Dv)
            out[b, h] = _model_head(qg[b, h], ks, vs, present, int(cur[b]),
                                    window)
    return out.reshape(B, Hq, 1, Dv)


def _close(got, ref, lanes=None):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if lanes is not None:
        got, ref = got[lanes], ref[lanes]
    assert np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    assert err <= REL * float(np.abs(ref).max()), err


def _arr(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the model against the JAX package's kernels (interpret mode)
# ---------------------------------------------------------------------------

# (G, D, S, window): S = 200 and 300 end mid-tile; every range count from
# 1 to 4 at kRows = 128
SLOT_CASES = [
    (1, 32, 200, 0),
    (2, 64, 256, 1),
    (3, 128, 300, 9),
    (8, 128, 256, 200),
    (8, 32, 500, 0),
    (3, 64, 200, 200),
    (2, 128, 384, 9),
    (1, 64, 128, 1),
]


@pytest.mark.parametrize("G,D,S,window", SLOT_CASES)
def test_slot_model_matches_jax(G, D, S, window):
    """Slots at cur_pos -1, 0, S - 1, the engine's invalid lane 2**30 and
    a middle row. The JAX wrapper pads the cache to 128 rows, and its
    invalid lane attends those zero rows (ROADMAP §C, invalid-lane
    padding): where S % 128 != 0 and window == 0 that lane is compared
    against the plain version instead (test_slot_model_matches_plain)."""
    rng = np.random.default_rng(100 * G + D + S + window)
    Hkv = 2
    cur = np.asarray([-1, 0, S - 1, INVALID, S // 2 + 3], np.int32)
    q = _arr(rng, (5, Hkv * G, 1, D))
    k, v = _arr(rng, (5, Hkv, S, D)), _arr(rng, (5, Hkv, S, D))
    ref = np.asarray(jops.fused_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        cur_pos=jnp.asarray(cur), window=window))
    got = model_slot(q, k, v, cur, window)
    lanes = [b for b in range(5)
             if not (cur[b] >= S and window == 0 and S % 128)]
    _close(got, ref, lanes)


def _page_table(rng, cur, ps, pps, num_pages, spare=2):
    """Shuffled pages up to each slot's cur_pos (the invalid lane all but
    its last ``spare``), -1 after; pool pages no table holds stay free."""
    perm = rng.permutation(num_pages)
    table = np.full((len(cur), pps), -1, np.int32)
    used = 0
    for b, c in enumerate(cur):
        n = pps - spare if c >= pps * ps else (c // ps + 1 if c >= 0 else 0)
        table[b, :n] = perm[used:used + n]
        used += n
    return table


# (G, D, ps, pps, window)
PAGED_CASES = [
    (1, 32, 8, 40, 0),
    (2, 64, 16, 16, 1),
    (3, 128, 16, 20, 9),
    (8, 128, 16, 24, 200),
    (8, 64, 8, 33, 0),
    (3, 32, 8, 17, 9),
]


@pytest.mark.parametrize("G,D,ps,pps,window", PAGED_CASES)
def test_paged_model_matches_jax(G, D, ps, pps, window):
    """Shuffled pages, trailing -1 entries, the invalid lane over all but
    its last two pages, an empty slot (cur_pos -1)."""
    rng = np.random.default_rng(7 * G + D + ps + pps + window)
    Hkv, L = 2, ps * pps
    cur = np.asarray([-1, 0, L - 1 - ps, INVALID, L // 2 + 1], np.int32)
    num_pages = 3 * pps
    table = _page_table(rng, cur, ps, pps, num_pages)
    q = _arr(rng, (5, Hkv * G, 1, D))
    kp = _arr(rng, (num_pages, Hkv, ps, D))
    vp = _arr(rng, (num_pages, Hkv, ps, D))
    ref = np.asarray(jops.fused_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        pages=jnp.asarray(table), cur_pos=jnp.asarray(cur), window=window))
    _close(model_paged(q, kp, vp, table, cur, window), ref)


# ---------------------------------------------------------------------------
# the model against the port's plain versions, with NaN wherever the
# kernel must not read (not against the JAX kernels: they multiply a
# masked row's V by p = 0, so a NaN past cur_pos in an attended tile
# reaches their output)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G,D,S,window", SLOT_CASES + [(2, 32, 37, 0)])
def test_slot_model_matches_plain(G, D, S, window):
    rng = np.random.default_rng(3 * G + D + S + window)
    Hkv = 2
    cur = np.asarray([-1, 0, S - 1, INVALID, S // 2 + 3, S // 3], np.int32)
    q = _arr(rng, (6, Hkv * G, 1, D))
    k, v = _arr(rng, (6, Hkv, S, D)), _arr(rng, (6, Hkv, S, 2 * D))
    ok = tops.attended_rows(S, torch.from_numpy(cur), window).numpy()
    k[np.broadcast_to(~ok[:, None, :, None], k.shape)] = np.nan
    v[np.broadcast_to(~ok[:, None, :, None], v.shape)] = np.nan
    ref = tops.gqa_decode_attn_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(cur), window).numpy()
    _close(model_slot(q, k, v, cur, window), ref)


@pytest.mark.parametrize("G,D,ps,pps,window", PAGED_CASES)
def test_paged_model_matches_plain(G, D, ps, pps, window):
    rng = np.random.default_rng(11 * G + D + ps + pps + window)
    Hkv, L = 2, ps * pps
    cur = np.asarray([-1, 0, L - 1 - ps, INVALID, L // 2 + 1, 5], np.int32)
    num_pages = 3 * pps + 2
    table = _page_table(rng, cur, ps, pps, num_pages)
    q = _arr(rng, (6, Hkv * G, 1, D))
    kp, vp = _arr(rng, (num_pages, Hkv, ps, D)), _arr(rng, (num_pages, Hkv,
                                                            ps, D))
    unref = np.ones(num_pages, bool)
    unref[table[table >= 0]] = False
    kp[unref] = np.nan
    vp[unref] = np.nan
    # rows past cur_pos (or before the window) in a referenced page: NaN
    ok = tops.paged_attended_rows(torch.from_numpy(table), ps, num_pages,
                                  torch.from_numpy(cur), window).numpy()
    for b in range(len(cur)):
        for p in range(L):
            page = table[b, p // ps]
            if page >= 0 and not ok[b, p]:
                kp[page, :, p % ps] = np.nan
                vp[page, :, p % ps] = np.nan
    ref = tops.gqa_paged_decode_attn_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(cur), window).numpy()
    _close(model_paged(q, kp, vp, table, cur, window), ref)


def test_model_schedule_covers_every_attended_row_once():
    """The blocks' ranges and the warps' tiles cover [first, hi] once, in
    order, and no range past the last holds a row, at the positions the
    smoke run and the decode step give (kRows from the source)."""
    tile, rows, W = KERNEL["tile"], KERNEL["rows"], KERNEL["warps"]
    for length in (1024, 300, 37):
        for cur in (-1, 0, 63, 64, 320, length - 1, INVALID):
            for window in (0, 1, 9, 200):
                lo, hi, first, ranges = _span(cur, length, window)
                assert ranges <= -(-length // rows)
                seen = []
                for r in range(ranges):
                    row0 = first + r * rows
                    n_tiles = -(-(min(row0 + rows, hi + 1) - row0) // tile)
                    assert n_tiles >= 1
                    for w in range(W):
                        seen += [row0 + t * tile for t in range(w, n_tiles,
                                                                W)]
                want = list(range(first, hi + 1, tile)) if hi >= lo else []
                assert sorted(seen) == want
                if hi >= lo:
                    assert first <= lo < first + tile


# ---------------------------------------------------------------------------
# the host side: grid, scratch and the kernel's constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,Hkv,G,length,Dv,ranges", [
    (8, 4, 8, 1024, 128, 8),      # Yi-6B, 8 slots, max_len 1024
    (8, 4, 8, 64 * 16, 128, 8),   # the paged pool: 64 pages of 16
    (4, 8, 4, 256, 128, 2),       # the analyzer's probe shapes
    (4, 2, 3, 200, 64, 2),
    (5, 2, 1, 37, 32, 1),
])
def test_grid_choice_reads_shapes_only(B, Hkv, G, length, Dv, ranges,
                                       monkeypatch):
    """Both wrappers size the grid as ceil(length / kRows) ranges per
    (slot, KV head), from the shapes: the same at 132 SMs as at any other
    count (the SM count is never asked), with no tensor among the inputs
    (which ranges hold rows is decided on the device from cur_pos)."""
    monkeypatch.setattr(tops, "_num_sms", lambda index: H100_SMS)
    got, ml, acc = tops._gqa_partials(B, Hkv, G, length, Dv,
                                      torch.device("cpu", 0))
    assert got == ranges == -(-length // KERNEL["rows"])
    assert tuple(ml.shape) == (2, B * Hkv * ranges * G)
    assert tuple(acc.shape) == (B * Hkv * ranges * G * Dv,)
    assert ml.dtype == acc.dtype == torch.float32

    def no_sms(index):
        raise AssertionError("the grid asked for the SM count")
    monkeypatch.setattr(tops, "_num_sms", no_sms)
    again = tops._gqa_partials(B, Hkv, G, length, Dv, torch.device("cpu", 0))
    assert again[0] == ranges
    params = list(inspect.signature(tops._gqa_partials).parameters)
    assert params == ["B", "Hkv", "G", "length", "Dv", "device"]


def test_kernel_constants_match_the_wrapper():
    """kRows is the wrapper's GQA_ROWS and whole tiles; the ring has at
    least two stages; 16 query heads per block are the mma's m; a tile is
    16 rows, one page of the main path."""
    assert KERNEL["rows"] == tops.GQA_ROWS
    assert KERNEL["rows"] % KERNEL["tile"] == 0
    assert KERNEL["tile"] == 16 and KERNEL["group"] == 16
    assert KERNEL["stages"] >= 2
    assert KERNEL["warps"] * 32 <= 1024


@pytest.mark.parametrize("D", [32, 64, 72, 128, 20, 256, 200])
def test_tile_layout(D):
    """Per element size: the K / q pitch and the V pitch are whole 16-byte
    copies and start each row on an odd multiple of 16 bytes modulo 128
    (ldmatrix's 8 rows on 8 bank groups); f32 V's scalar reads (rows 2 tg,
    column g) fall on 32 banks; the f32 merge rows take a warp's float2
    stores on two wavefronts; every copy loop of a tile has a multiple of
    32 trips, so its shuffles run on all lanes. A head of up to 128 takes
    the compile-time tile (zero-padded), a wider one D rounded up to 16."""
    src = SOURCE.read_text()
    assert "kPad = 16 / (int)sizeof(T);" in src
    assert "return HD ? HD : (D + 15) / 16 * 16;" in src
    assert "return D <= 128 && Dv <= 128 ? 128 : 0;" in src
    assert "kLdr = VT + 8;" in src
    dk = 128 if D <= 128 else -(-D // 16) * 16
    vt = 128                                 # output columns a block
    for size in (4, 2):
        pad = 16 // size
        for ld in (dk + pad, vt + pad):
            assert ld * size % 16 == 0 and (ld * size // 16) % 2 == 1
        if size == 4:
            banks = {(2 * tg * (vt + pad) + g) % 32 for g in range(8)
                     for tg in range(4)}
            assert len(banks) == 32
        vec = 16 // size
        for copies in (KERNEL["tile"] * dk // vec, KERNEL["tile"] * vt // vec,
                       KERNEL["tile"] * dk, KERNEL["tile"] * vt):
            assert copies % 32 == 0
    # float2 stores of lanes (g, tg) at word g * (vt + 8) + 2 tg: each
    # 8-byte bank pair taken by two lanes, the least for 256 bytes
    pairs = {}
    for g in range(8):
        for tg in range(4):
            w = (g * (vt + 8) + 2 * tg) % 32
            pairs[w] = pairs.get(w, 0) + 1
    assert max(pairs.values()) == 2 and len(pairs) == 16


def test_one_source_two_policies():
    """#1 and #4 are one templated kernel in one source (the paged copy is
    gone); the launch names carry the row policy, so the profiler can tell
    #1 from #4; every CUDA source is built."""
    src = SOURCE.read_text()
    csrc = SOURCE.parent
    assert not (csrc / "gqa_paged_decode_attn.cu").exists()
    assert sorted(tbuild.SOURCES) == sorted(p.name for p in csrc.glob("*.cu"))
    assert "gqa_paged_partial_kernel" not in src
    assert '"gqa_decode_partial_kernel<%s,%s,%d>", rn' in src
    assert 'paged ? "PagedRows" : "SlotRows"' in src
    for entry in ("repro_gqa_decode_attn", "repro_gqa_paged_decode_attn"):
        assert f'extern "C" int {entry}(' in src
        assert f'extern "C" int {entry}_launch_config(' in src
        assert tbuild.CONFIG_SIGNATURES[entry] == 7
