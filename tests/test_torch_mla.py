"""The port's MLA + MoE decode path (DeepSeek-V2-Lite smoke) against the
JAX package's, on the CPU.

* ``fused_mla_decode_attention`` and ``fused_paged_mla_decode_attention``
  (the plain versions, on CPU tensors) against the JAX ``ops`` functions
  (their Pallas kernels in interpret mode) in float32, max |err| <= 1e-5
  * max |ref|: an odd head count, ragged positions, one invalid lane at
  the engine's 2**30, and for the paged pool trailing -1 table entries, a
  shuffled page order and NaN in every page no table references. The
  reference pads the slot cache's rows to its 128-row tile and an invalid
  lane attends that zero padding; the port's kernel has no padding, so
  the slot-cache case uses S = 128.
* ``moe_ffn`` against the JAX one with routing skewed past an expert's
  capacity (outputs and aux loss rtol 1e-5; dispatch ids exact).
* A decode step of the DeepSeek smoke model: logits atol 1e-5.
* The DeepSeek smoke engine over the slot cache and over the paged pool
  (oracle and fused attention) token-identical to the JAX engine, with
  identical per-step controller decisions under ZERO-resizing, and the
  paged and fixed port engines identical to each other.
* The bridge round trip of the DeepSeek tree (dense prefix, MLA, MoE).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import get_config, smoke_variant
from repro.control import ControlConfig as JControlConfig
from repro.kernels import ops as jops
from repro.layers import moe as jmoe
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.config import get_config as tget_config
from repro_torch.config import smoke_variant as tsmoke_variant
from repro_torch.control import ControlConfig
from repro_torch.kernels import ops as tops
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.layers import moe as tmoe
from repro_torch.models import lm as tlm

ARCH = "deepseek-v2-lite-16b"
ZERO = dict(mode="zero", hetero_kind="contention", chi=4.0,
            contention_p=0.15, sim_ranks=8, seed=0, use_kernel=True)
INVALID = 2 ** 30


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# the kernel functions
# ---------------------------------------------------------------------------


def _mla_inputs(rng, B, H, R, Dr):
    return (rng.standard_normal((B, H, R)).astype(np.float32),
            rng.standard_normal((B, H, Dr)).astype(np.float32))


def test_fused_mla_decode_attention_matches_jax():
    rng = np.random.default_rng(0)
    B, H, R, Dr, S = 4, 5, 32, 8, 128
    qa, qr = _mla_inputs(rng, B, H, R, Dr)
    lat = rng.standard_normal((B, S, R)).astype(np.float32)
    rope = rng.standard_normal((B, S, Dr)).astype(np.float32)
    cur = np.asarray([0, 17, INVALID, 100], np.int32)
    ref = np.asarray(jops.fused_mla_decode_attention(
        qa, qr, lat, rope, cur_pos=cur, head_dim_for_scale=12))
    got = tops.fused_mla_decode_attention(
        *_t(qa, qr, lat, rope), cur_pos=torch.from_numpy(cur),
        head_dim_for_scale=12).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_fused_mla_invalid_lane_contract_at_ragged_cache():
    # S = 200 is not a whole number of the reference's 128-row tiles: its
    # wrapper pads the rows to 256 with zeros, and the lane at INVALID
    # attends those padded rows; the port has no padding. That lane is
    # discarded by the engine (its tokens are never read), so it is
    # excluded here — the contract in ROADMAP.md, queue C. Every valid
    # lane must agree.
    rng = np.random.default_rng(2)
    B, H, R, Dr, S = 4, 5, 32, 8, 200
    qa, qr = _mla_inputs(rng, B, H, R, Dr)
    lat = rng.standard_normal((B, S, R)).astype(np.float32)
    rope = rng.standard_normal((B, S, Dr)).astype(np.float32)
    cur = np.asarray([0, 150, INVALID, S - 1], np.int32)
    ref = np.asarray(jops.fused_mla_decode_attention(
        qa, qr, lat, rope, cur_pos=cur, head_dim_for_scale=12))
    got = tops.fused_mla_decode_attention(
        *_t(qa, qr, lat, rope), cur_pos=torch.from_numpy(cur),
        head_dim_for_scale=12).numpy()
    valid = [0, 1, 3]
    assert np.isfinite(got).all()
    assert np.abs(got[valid] - ref[valid]).max() \
        <= 1e-5 * np.abs(ref[valid]).max()


def test_fused_paged_mla_decode_attention_matches_jax():
    rng = np.random.default_rng(1)
    B, H, R, Dr, ps, pps, num_pages = 4, 5, 32, 8, 8, 5, 24
    qa, qr = _mla_inputs(rng, B, H, R, Dr)
    cur = np.asarray([3, INVALID, 21, 39], np.int32)
    perm = rng.permutation(num_pages)
    table = np.full((B, pps), -1, np.int32)
    used = 0
    for b, c in enumerate(cur):
        n = pps - 2 if c >= pps * ps else c // ps + 1
        table[b, :n] = perm[used:used + n]
        used += n
    unref = np.ones(num_pages, bool)
    unref[table[table >= 0]] = False
    lat = rng.standard_normal((num_pages, ps, R)).astype(np.float32)
    rope = rng.standard_normal((num_pages, ps, Dr)).astype(np.float32)
    lat[unref] = np.nan
    rope[unref] = np.nan
    ref = np.asarray(jops.fused_paged_mla_decode_attention(
        qa, qr, lat, rope, pages=table, cur_pos=cur, head_dim_for_scale=12))
    got = tops.fused_paged_mla_decode_attention(
        *_t(qa, qr, lat, rope), pages=torch.from_numpy(table),
        cur_pos=torch.from_numpy(cur), head_dim_for_scale=12).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("case", ["q_rope", "page_size", "batch"])
def test_fused_mla_errors_match_jax(case):
    qa, qr = np.ones((2, 3, 16), np.float32), np.ones((2, 3, 4), np.float32)
    lat, rope = np.ones((6, 8, 16), np.float32), np.ones((6, 8, 4),
                                                          np.float32)
    pages, cur = np.zeros((2, 2), np.int32), np.zeros((2,), np.int32)
    if case == "q_rope":
        qr = np.ones((2, 2, 4), np.float32)
    elif case == "page_size":
        lat, rope = lat[:, :4], rope[:, :4]
    else:
        cur = np.zeros((3,), np.int32)
    with pytest.raises(ValueError) as j:
        jops.fused_paged_mla_decode_attention(
            qa, qr, lat, rope, pages=pages, cur_pos=cur,
            head_dim_for_scale=12)
    with pytest.raises(ValueError) as t:
        tops.fused_paged_mla_decode_attention(
            *_t(qa, qr, lat, rope), pages=torch.from_numpy(pages),
            cur_pos=torch.from_numpy(cur), head_dim_for_scale=12)
    assert str(t.value) == str(j.value)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def test_moe_ffn_matches_jax_at_capacity_overflow():
    cfg = smoke_variant(get_config(ARCH))
    mo = cfg.moe
    rng = np.random.default_rng(2)
    d, E, f, T = cfg.d_model, mo.num_experts, mo.d_expert, 96
    router = (rng.standard_normal((d, E)) * 0.02).astype(np.float32)
    router[:, 0] += 0.02      # with x's positive mean: expert 0 overflows
    params = {"router": router,
              "w_up": (rng.standard_normal((E, d, f)) * 0.05).astype(
                  np.float32),
              "w_gate": (rng.standard_normal((E, d, f)) * 0.05).astype(
                  np.float32),
              "w_down": (rng.standard_normal((E, f, d)) * 0.05).astype(
                  np.float32)}
    x = (rng.standard_normal((4, T // 4, d)) + 0.5).astype(np.float32)
    cap = tmoe.expert_capacity(T, tsmoke_variant(tget_config(ARCH)).moe)
    idx, _, _ = jmoe.router_topk(jnp.asarray(x.reshape(T, d)),
                                 jnp.asarray(router), mo)
    assert np.bincount(np.asarray(idx).ravel(), minlength=E).max() > cap
    yj, auxj = jmoe.moe_ffn(jnp.asarray(x), params, mo, jax.nn.silu)
    tmo = tsmoke_variant(tget_config(ARCH)).moe
    yt, auxt = tmoe.moe_ffn(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in
                             params.items()}, tmo, tops.silu)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    # which (token, choice) fills each expert's capacity: exact
    ji, jw, _ = jmoe.router_topk(jnp.asarray(x.reshape(T, d)),
                                 jnp.asarray(router), mo)
    gj, cj = jmoe._grouped_dispatch(ji, jw, T, E, cap)
    ti, tw, _ = tmoe.router_topk(torch.from_numpy(x.reshape(T, d)),
                                 torch.from_numpy(router), tmo)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    gt, ct, _ = tmoe.grouped_dispatch(ti, tw, T, E, cap)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5)


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------


def _models():
    cfg = smoke_variant(get_config(ARCH))
    tcfg = tsmoke_variant(tget_config(ARCH))
    params, _ = jlm.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    np_tree = jax.tree.map(np.asarray, params)
    return cfg, tcfg, params, np_tree


def test_deepseek_params_round_trip():
    _, tcfg, _, np_tree = _models()
    model = bridge.params_from_jax(np_tree, tcfg, device="cpu")
    assert model.num_prefix_layers == 1
    assert len(model.layers) == tcfg.num_layers
    back = bridge.params_to_numpy(model)
    flat_a, tree_a = jax.tree.flatten(np_tree)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_deepseek_decode_step_matches_jax():
    cfg, tcfg, params, np_tree = _models()
    tparams = bridge.params_from_jax(np_tree, tcfg, device="cpu")
    B, S = 4, 16
    rng = np.random.default_rng(3)
    cache0 = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(np.float32),
        jlm.init_cache(cfg, B, S, jnp.float32))
    jcache = jax.tree.map(jnp.asarray, cache0)
    tcache = jax.tree.map(lambda a: torch.from_numpy(a.copy()), cache0)
    for step in range(2):
        cur = np.asarray([step, 5 + step, INVALID, 15], np.int32)
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jl, jcache = jlm.decode_step(params, cfg, jcache, jnp.asarray(tok),
                                     jnp.asarray(cur))
        with torch.no_grad():
            tl, tcache = tlm.decode_step(tparams, tcfg, tcache,
                                         torch.from_numpy(tok),
                                         torch.from_numpy(cur))
        ok = cur < S
        np.testing.assert_allclose(tl.numpy()[ok], np.asarray(jl)[ok],
                                   rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree.leaves(jcache), jax.tree.leaves(tcache)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


def _requests(cls, vocab, specs):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                max_new_tokens=g, arrival_step=a)
            for i, (p, g, a) in enumerate(specs)]


def _decisions(history):
    return [(h.get("max_bucket"), h.get("stragglers"), h.get("preempted"))
            for h in history]


SPECS = [(5, 4, 0), (6, 3, 2)]


@pytest.mark.parametrize("kw", [
    dict(max_len=12),
    dict(max_len=12, page_size=4, prefill_chunk=3),
    dict(max_len=16, page_size=8, prefill_chunk=3, fused=True),
], ids=["fixed", "paged_ps4_chunk3", "paged_ps8_fused"])
def test_deepseek_engine_token_exact_against_jax(kw):
    kw = dict(kw)
    control = dict(ZERO, fused_attention=kw.pop("fused", False))
    jeng = JServeEngine(ARCH, num_slots=2, seed=0,
                        control=JControlConfig(**control), **kw)
    jtok = {c.uid: c.tokens.tolist()
            for c in jeng.run(_requests(JRequest, jeng.cfg.vocab_size,
                                        SPECS))}
    jeng.close()
    teng = ServeEngine(ARCH, num_slots=2, seed=0,
                       control=ControlConfig(**control), device="cpu", **kw)
    teng.params = bridge.params_from_jax(
        jax.tree.map(np.asarray, jeng.params), teng.cfg, device="cpu")
    ttok = {c.uid: c.tokens.tolist()
            for c in teng.run(_requests(Request, teng.cfg.vocab_size,
                                        SPECS))}
    teng.close()
    assert ttok == jtok
    assert _decisions(teng.history) == _decisions(jeng.history)
    assert max(h["max_bucket"] for h in teng.history) > 0
    assert teng.kv_cache_bytes() == jeng.kv_cache_bytes()
    # the fixed and the paged port engines agree with each other
    fixed = ServeEngine(ARCH, num_slots=2, max_len=kw["max_len"], seed=0,
                        control=ControlConfig(**control), device="cpu",
                        prefill_chunk=kw.get("prefill_chunk", 1))
    fixed.params = teng.params
    ftok = {c.uid: c.tokens.tolist()
            for c in fixed.run(_requests(Request, fixed.cfg.vocab_size,
                                         SPECS))}
    fixed.close()
    assert ftok == ttok


def test_deepseek_int8_paging_raises_like_jax():
    with pytest.raises(ValueError) as j:
        JServeEngine(ARCH, num_slots=2, max_len=12, page_size=4,
                     kv_int8=True)
    with pytest.raises(ValueError) as t:
        ServeEngine(ARCH, num_slots=2, max_len=12, page_size=4,
                    kv_int8=True, device="cpu")
    assert str(t.value) == str(j.value)
