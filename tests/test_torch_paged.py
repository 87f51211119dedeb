"""The port's paged KV pool against the JAX package's, on the CPU.

* ``fused_paged_decode_attention`` (the plain version, on CPU tensors)
  against the JAX ``ops`` function (its Pallas kernel in interpret mode)
  in float32, max |err| <= 1e-5 * max |ref|: odd query-head groups,
  ragged positions, one invalid lane at the engine's 2**30, trailing -1
  table entries, a shuffled page order, and every page no table
  references filled with NaN (a kernel that reads one shows NaN).
* The paged Yi-6B smoke engine token-identical to the JAX paged engine,
  with identical per-step controller decisions (``max_bucket``,
  ``stragglers``) and preemptions, for the cases of
  ``tests/test_paged_serve.py`` under ZERO-resizing with contention
  chi = 4 over a simulated 8-rank group (the port's engine refuses SEMI
  at tp = 1, a later slice). The port serves the JAX engine's weights.
* The int8 K/V pool: decode logits within 1e-5 of the JAX int8 path and
  equal ``kv_cache_bytes``.
* A lane that must not write changes no byte of the pool.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import get_config, smoke_variant
from repro.control import ControlConfig as JControlConfig
from repro.core import paging as jpaging
from repro.kernels import ops as jops
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.config import get_config as tget_config
from repro_torch.config import smoke_variant as tsmoke_variant
from repro_torch.control import ControlConfig
from repro_torch.core import paging as tpaging
from repro_torch.kernels import ops as tops
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import lm as tlm

ZERO = dict(mode="zero", hetero_kind="contention", chi=4.0,
            contention_p=0.15, sim_ranks=8, seed=0, use_kernel=True)
INVALID = 2 ** 30


def _requests(cls, vocab, specs):
    """specs: (prompt_len, gen_len, arrival_step) per request."""
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                max_new_tokens=g, arrival_step=a)
            for i, (p, g, a) in enumerate(specs)]


def _decisions(history):
    return [(h.get("max_bucket"), h.get("stragglers"), h.get("preempted"))
            for h in history]


def _serve_pair(arch, specs, control, **kw):
    """(JAX engine, port engine, JAX tokens, port tokens): the same
    requests through both engines, the port on the JAX engine's
    weights."""
    jeng = JServeEngine(arch, seed=0, control=JControlConfig(**control),
                        **kw)
    jtok = {c.uid: c.tokens.tolist()
            for c in jeng.run(_requests(JRequest, jeng.cfg.vocab_size,
                                        specs))}
    jeng.close()
    teng = ServeEngine(arch, seed=0, control=ControlConfig(**control),
                       device="cpu", **kw)
    teng.params = bridge.params_from_jax(
        jax.tree.map(np.asarray, jeng.params), teng.cfg, device="cpu")
    ttok = {c.uid: c.tokens.tolist()
            for c in teng.run(_requests(Request, teng.cfg.vocab_size,
                                        specs))}
    teng.close()
    return jeng, teng, jtok, ttok


def _page_table(rng, cur, ps, pps, num_pages):
    """Shuffled pages for each slot up to its cur_pos (pps for the
    invalid lane's full table minus two trailing -1 entries)."""
    perm = rng.permutation(num_pages)
    table = np.full((len(cur), pps), -1, np.int32)
    used = 0
    for b, c in enumerate(cur):
        n = pps - 2 if c >= pps * ps else c // ps + 1
        table[b, :n] = perm[used:used + n]
        used += n
    return table


def _nan_unreferenced(pool, table):
    pool = pool.copy()
    unref = np.ones(pool.shape[0], bool)
    unref[table[table >= 0]] = False
    pool[unref] = np.nan
    return pool


# ---------------------------------------------------------------------------
# the kernel function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 5])
def test_fused_paged_decode_attention_matches_jax(window):
    rng = np.random.default_rng(0)
    B, Hkv, G, D, ps, pps = 4, 3, 3, 16, 8, 5         # odd groups: Hq = 9
    cur = np.asarray([0, 13, INVALID, 37], np.int32)
    num_pages = 24
    table = _page_table(rng, cur, ps, pps, num_pages)
    q = rng.standard_normal((B, Hkv * G, 1, D)).astype(np.float32)
    k = _nan_unreferenced(rng.standard_normal(
        (num_pages, Hkv, ps, D)).astype(np.float32), table)
    v = _nan_unreferenced(rng.standard_normal(
        (num_pages, Hkv, ps, D)).astype(np.float32), table)
    ref = np.asarray(jops.fused_paged_decode_attention(
        q, k, v, pages=table, cur_pos=cur, window=window))
    got = tops.fused_paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        pages=torch.from_numpy(table), cur_pos=torch.from_numpy(cur),
        window=window).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("case", ["page_size", "gqa_ratio", "batch"])
def test_fused_paged_errors_match_jax(case):
    q = np.ones((2, 4, 1, 8), np.float32)
    pool = np.ones((6, 2, 8, 8), np.float32)
    pages = np.zeros((2, 2), np.int32)
    if case == "page_size":
        pool = np.ones((6, 2, 4, 8), np.float32)
    elif case == "gqa_ratio":
        pool = np.ones((6, 3, 8, 8), np.float32)
    else:
        pages = np.zeros((3, 2), np.int32)
    cur = np.zeros((2,), np.int32)
    with pytest.raises(ValueError) as j:
        jops.fused_paged_decode_attention(q, pool, pool, pages=pages,
                                          cur_pos=cur)
    with pytest.raises(ValueError) as t:
        tops.fused_paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(pool),
            torch.from_numpy(pool), pages=torch.from_numpy(pages),
            cur_pos=torch.from_numpy(cur))
    assert str(t.value) == str(j.value)


# ---------------------------------------------------------------------------
# the engine (tests/test_paged_serve.py's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(page_size=4),
    dict(page_size=4, prefill_chunk=3),
    dict(page_size=8, prefill_chunk=3, fused=True),
], ids=["ps4", "ps4_chunk3", "ps8_chunk3_fused"])
def test_paged_engine_token_exact_against_jax(kw):
    kw = dict(kw)
    control = dict(ZERO, fused_attention=kw.pop("fused", False))
    specs = [(5, 6, 0), (7, 4, 2), (4, 5, 6)]
    jeng, teng, jtok, ttok = _serve_pair("yi-6b", specs, control,
                                         num_slots=2, max_len=16, **kw)
    assert ttok == jtok
    assert _decisions(teng.history) == _decisions(jeng.history)
    assert max(h["max_bucket"] for h in teng.history) > 0
    assert teng.kv_cache_bytes() == jeng.kv_cache_bytes()
    assert teng.alloc.free_pages == teng.paging.num_pages


def test_exhaustion_preempts_like_jax():
    specs = [(5, 6, 0), (7, 4, 0)]
    jeng, teng, jtok, ttok = _serve_pair("yi-6b", specs, ZERO, num_slots=2,
                                         max_len=16, page_size=4,
                                         num_pages=5)
    assert teng.preemptions == jeng.preemptions > 0
    assert ttok == jtok
    assert _decisions(teng.history) == _decisions(jeng.history)
    assert any("preempted" in h for h in teng.history)
    assert teng.alloc.free_pages == 5
    assert teng.load_snapshot().free_pages == 5


def test_exhaustion_with_no_victim_raises():
    eng = ServeEngine("yi-6b", num_slots=1, max_len=16, seed=0,
                      page_size=4, num_pages=2, device="cpu")
    req = _requests(Request, eng.cfg.vocab_size, [(6, 8, 0)])
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        eng.run(req)
    eng.close()


def test_zero_control_paged_matches_fixed_and_jax():
    """tests/test_paged_serve.py's SEMI case under ZERO: the paged engine
    follows the JAX paged engine, and the fixed-cache port engine."""
    specs = [(5, 4, 0), (6, 3, 2)]
    ctl = dict(ZERO, seed=3)
    kw = dict(num_slots=2, max_len=12, prefill_chunk=2)
    jeng, teng, jtok, ttok = _serve_pair("yi-6b", specs, ctl, page_size=4,
                                         **kw)
    assert ttok == jtok
    assert _decisions(teng.history) == _decisions(jeng.history)
    fixed = ServeEngine("yi-6b", seed=0, control=ControlConfig(**ctl),
                        device="cpu", **kw)
    fixed.params = teng.params
    ftok = {c.uid: c.tokens.tolist()
            for c in fixed.run(_requests(Request, fixed.cfg.vocab_size,
                                         specs))}
    fixed.close()
    assert ttok == ftok


def test_paging_copy_matches_the_reference():
    lay = tpaging.paged_layout(max_len=10, page_size=4, num_slots=3,
                               num_pages=7, kv_int8=True)
    jlay = jpaging.paged_layout(max_len=10, page_size=4, num_slots=3,
                                num_pages=7, kv_int8=True)
    assert (lay.page_size, lay.pages_per_slot, lay.num_pages, lay.kv_int8) \
        == (jlay.page_size, jlay.pages_per_slot, jlay.num_pages,
            jlay.kv_int8)
    al, jal = tpaging.PageAllocator(lay, 3), jpaging.PageAllocator(jlay, 3)
    for slot, upto in ((0, 5), (1, 0), (2, 9), (0, 7), (1, 3)):
        assert al.ensure(slot, upto) == jal.ensure(slot, upto)
        np.testing.assert_array_equal(al.table(), jal.table())
    al.free_slot(2)
    jal.free_slot(2)
    assert al.ensure(1, 9) == jal.ensure(1, 9)
    np.testing.assert_array_equal(al.table(), jal.table())
    assert tpaging.INVALID_POS == jpaging.INVALID_POS


# ---------------------------------------------------------------------------
# int8 K/V pool and invalid lanes, at the decode step
# ---------------------------------------------------------------------------


def _paged_models(kv_int8: bool, num_pages: int = 12, ps: int = 4):
    cfg = smoke_variant(get_config("yi-6b"))
    tcfg = tsmoke_variant(tget_config("yi-6b"))
    params, _ = jlm.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                     device="cpu")
    lay = jpaging.paged_layout(16, ps, 4, num_pages=num_pages,
                               kv_int8=kv_int8)
    tlay = tpaging.paged_layout(16, ps, 4, num_pages=num_pages,
                                kv_int8=kv_int8)
    return cfg, tcfg, params, tparams, lay, tlay


def _torch_tree(jtree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jtree)


def test_kv_int8_logits_match_jax():
    cfg, tcfg, params, tparams, lay, tlay = _paged_models(kv_int8=True)
    jcache = jlm.init_cache(cfg, 4, 16, jnp.float32, paging=lay)
    tcache = tlm.init_cache(tcfg, 4, 16, torch.float32, "cpu", paging=tlay)
    jbytes = sum(l.size * l.dtype.itemsize for l in jax.tree.leaves(jcache))
    assert sum(t.numel() * t.element_size()
               for t in jax.tree.leaves(tcache)) == jbytes
    table = np.asarray([[3, 0, -1, -1], [5, 1, 7, -1], [2, -1, -1, -1],
                        [11, 4, -1, -1]], np.int32)
    rng = np.random.default_rng(1)
    for step in range(3):
        cur = np.asarray([step + 2, step + 5, INVALID, step], np.int32)
        tok = rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32)
        jl, jcache = jlm.decode_step(params, cfg, jcache, jnp.asarray(tok),
                                     jnp.asarray(cur),
                                     pages=jnp.asarray(table))
        with torch.no_grad():
            tl, tcache = tlm.decode_step(tparams, tcfg, tcache,
                                         torch.from_numpy(tok),
                                         torch.from_numpy(cur),
                                         pages=torch.from_numpy(table))
        ok = cur < 16
        ref = np.asarray(jl)[ok]
        assert np.abs(tl.numpy()[ok] - ref).max() \
            <= 1e-5 * max(1.0, np.abs(ref).max())
    for name in ("k", "v", "k_scale", "v_scale"):
        got = tcache["scan"][0]["attn"][name].numpy().astype(np.float64)
        ref = np.asarray(jcache["scan"][0]["attn"][name]).astype(np.float64)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_kv_int8_engine_and_fused_refusal():
    specs = [(5, 4, 0), (6, 3, 2)]
    kw = dict(num_slots=2, max_len=12, page_size=4)
    q = ServeEngine("yi-6b", seed=0, kv_int8=True, device="cpu", **kw)
    comps = q.run(_requests(Request, q.cfg.vocab_size, specs))
    q.close()
    assert sorted(len(c.tokens) for c in comps) == [3, 4]
    jq = JServeEngine("yi-6b", seed=0, kv_int8=True, **kw)
    assert q.kv_cache_bytes() == jq.kv_cache_bytes()
    jq.close()
    f = ServeEngine("yi-6b", seed=0, device="cpu", **kw)
    assert q.kv_cache_bytes() < f.kv_cache_bytes() / 2
    f.close()


def test_invalid_lanes_change_no_pool_byte():
    """Lane 1 sits at 2**30 and lane 3 past its allocated pages: neither
    writes. Lane 1's clamped target (its last table entry is -1) is page
    0, offset 0 — the row lane 0 writes — so a write that lets an invalid
    lane land would clobber lane 0's row."""
    cfg, tcfg, params, tparams, lay, tlay = _paged_models(kv_int8=False)
    rng = np.random.default_rng(2)
    leaves = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(np.float32),
        jlm.init_cache(cfg, 4, 16, jnp.float32, paging=lay))
    table = np.asarray([[0, 6, -1, -1], [8, 9, 10, -1], [2, -1, -1, -1],
                        [4, -1, -1, -1]], np.int32)
    cur = np.asarray([0, INVALID, 3, 9], np.int32)   # lane 3: page 2 is -1
    tok = rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32)
    tcache = _torch_tree(leaves)
    before = jax.tree.map(lambda t: t.clone(), tcache)
    _, jcache = jlm.decode_step(params, cfg, jax.tree.map(jnp.asarray,
                                                         leaves),
                                jnp.asarray(tok), jnp.asarray(cur),
                                pages=jnp.asarray(table))
    with torch.no_grad():
        tlm.decode_step(tparams, tcfg, tcache, torch.from_numpy(tok),
                        torch.from_numpy(cur), pages=torch.from_numpy(table))
    written = np.zeros((lay.num_pages, lay.page_size), bool)
    written[0, 0] = written[2, 3] = True             # lanes 0 and 2
    for name in ("k", "v"):
        got = tcache["scan"][0]["attn"][name].numpy()
        old = before["scan"][0]["attn"][name].numpy()
        ref = np.asarray(jcache["scan"][0]["attn"][name])
        keep = ~written[None, :, None, :, None] \
            & np.ones(got.shape, bool)
        np.testing.assert_array_equal(got[keep], old[keep])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        assert not np.array_equal(got[:, 0, :, 0], old[:, 0, :, 0])


def test_paged_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve as tserve
    tserve.main(["--device", "cpu", "--arch", "deepseek-v2-lite-16b",
                 "--control", "zero", "--hetero", "contention",
                 "--sim-ranks", "8", "--use-kernel", "--fused-attn",
                 "--requests", "3", "--prompt-len", "8", "--gen-len", "8",
                 "--arrival-every", "0", "--prefill-chunk", "3",
                 "--page-size", "8", "--num-pages", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 24 tokens" in out
    assert "preemptions" in out and "preemptions 0" not in out
