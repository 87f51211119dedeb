"""The port's Yi-6B smoke decode step against the JAX package's.

The JAX model's parameters go through ``repro_torch.bridge.params_from_jax``;
both models decode the same tokens at ragged positions against the same
pre-filled cache, in float32. Logits of the valid lanes agree to
atol = 1e-5, and so do the caches after the step (the lane at the
engine's invalid position 2**30 writes nothing in either). Run once with
no control context and once with a fixed non-zero γ-bucket and a shuffled
priority list on every controlled scope, with the kernel paths on.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import ShapeConfig, get_config, smoke_variant
from repro.control import scopes as jscopes
from repro.core.workload import PlanStatic as JPlanStatic
from repro.launch import steps as jsteps
from repro.launch.mesh import make_small_mesh
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.config import get_config as tget_config
from repro_torch.config import smoke_variant as tsmoke_variant
from repro_torch.control import scopes as tscopes
from repro_torch.core.workload import PlanStatic
from repro_torch.layers.tp_linear import ControlContext
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

B, S = 4, 16
CUR = np.asarray([0, 5, 2 ** 30, 15], np.int32)
VALID = CUR < S


def _setup():
    cfg = smoke_variant(get_config("yi-6b"))
    params, _ = jlm.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(0)
    shape = (cfg.num_layers, B, cfg.num_kv_heads, S, cfg.resolved_head_dim)
    k0 = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    v0 = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
    return cfg, params, k0, v0, tokens


def _cache_j(k0, v0):
    return {"scan": ({"attn": {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}},)}


def _cache_t(k0, v0):
    return {"scan": ({"attn": {"k": torch.from_numpy(k0.copy()),
                               "v": torch.from_numpy(v0.copy())}},)}


def _check(logits_j, cache_j, logits_t, cache_t):
    np.testing.assert_allclose(logits_t.numpy()[VALID],
                               np.asarray(logits_j)[VALID],
                               rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            cache_t["scan"][0]["attn"][name].numpy(),
            np.asarray(cache_j["scan"][0]["attn"][name]),
            rtol=1e-5, atol=1e-5)


def test_params_round_trip():
    cfg, params, _, _, _ = _setup()
    np_tree = jax.tree.map(np.asarray, params)
    tcfg = tsmoke_variant(tget_config("yi-6b"))
    back = bridge.params_to_numpy(
        bridge.params_from_jax(np_tree, tcfg, device="cpu"))
    flat_a, tree_a = jax.tree.flatten(np_tree)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
def test_decode_step_matches_jax_without_control(fused):
    import dataclasses
    cfg, params, k0, v0, tokens = _setup()
    cfg = dataclasses.replace(cfg, fused_decode_attn=fused)
    logits_j, cache_j = jlm.decode_step(params, cfg, _cache_j(k0, v0),
                                        jnp.asarray(tokens),
                                        jnp.asarray(CUR))
    tcfg = dataclasses.replace(tsmoke_variant(tget_config("yi-6b")),
                               fused_decode_attn=fused)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    cache_t = _cache_t(k0, v0)
    with torch.no_grad():
        logits_t, cache_t = tlm.decode_step(tp, tcfg, cache_t,
                                            torch.from_numpy(tokens),
                                            torch.from_numpy(CUR))
    _check(logits_j, cache_j, logits_t, cache_t)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_step_matches_jax_under_a_resizing_plan(use_kernel):
    """Bucket 3 (γ = 0.375) on every scope, shuffled keep-first lists."""
    import dataclasses
    cfg, params, k0, v0, tokens = _setup()
    mesh = make_small_mesh(1, 1)
    jstatic = JPlanStatic(block_size=8, tp_size=1)
    scopes = jscopes.control_scopes(cfg, jstatic)
    assert set(scopes) == {"ffn", "qkv", "attn_out"}
    rng = np.random.default_rng(1)
    pri_np = {name: rng.permutation(nb).astype(np.int32)
              for name, nb in scopes.items()}
    # layouts: "col" scopes carry [nb], "row" scopes [tp, nb]
    pri_np = {n: (p if jscopes.SCOPE_LAYOUT[n] == "col" else p[None])
              for n, p in pri_np.items()}
    bucket = np.asarray([3], np.int32)
    plan = {"bucket_by_rank": jnp.asarray(bucket),
            "mig_src": jnp.asarray([-1], jnp.int32),
            "pri": {n: jnp.asarray(p) for n, p in pri_np.items()}}
    step, _, _, _ = jsteps.build_serve_step(
        cfg, ShapeConfig("serve", S, B, "decode"), mesh, jnp.float32,
        control_static=jstatic, use_kernel=use_kernel,
        fused_attention=use_kernel)
    logits_j, cache_j = jax.jit(step)(params, _cache_j(k0, v0),
                                      jnp.asarray(tokens), jnp.asarray(CUR),
                                      plan)

    tcfg = dataclasses.replace(tsmoke_variant(tget_config("yi-6b")),
                               fused_decode_attn=use_kernel)
    tstatic = PlanStatic(block_size=8, tp_size=1)
    tstatic = dataclasses.replace(
        tstatic, scope_blocks=tscopes.scope_block_table(tcfg, tstatic))
    tctx = ControlContext(
        static=tstatic, bucket_by_rank=torch.from_numpy(bucket),
        pri={n: torch.from_numpy(p) for n, p in pri_np.items()},
        use_kernel=use_kernel)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    cache_t = _cache_t(k0, v0)
    with torch.no_grad():
        logits_t, cache_t = tlm.decode_step(tp, tcfg, cache_t,
                                            torch.from_numpy(tokens),
                                            torch.from_numpy(CUR), ctx=tctx)
    _check(logits_j, cache_j, logits_t, cache_t)


@pytest.mark.parametrize("bucket", [0, 2, 7])
def test_resizing_primitives_match_jax(bucket):
    """gather/keep-mask/switched products of ``core.resizing`` against the
    reference's, f32, a shuffled keep-first list, block 8."""
    from repro.core import resizing as jres
    from repro.core.workload import DEFAULT_BUCKETS
    from repro_torch.core import resizing as tres
    from repro_torch.kernels import ops as tops
    rng = np.random.default_rng(bucket)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    wd = rng.standard_normal((40, 64)).astype(np.float32)
    pri = rng.permutation(8).astype(np.int32)
    keep = np.sort(pri[:5])
    tx, tw, tk = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(keep)
    np.testing.assert_array_equal(
        tres.gather_cols(tx, tk, 8).numpy(),
        np.asarray(jres.gather_cols(jnp.asarray(x), jnp.asarray(keep), 8)))
    np.testing.assert_array_equal(
        tres.gather_rows(tw, tk, 8).numpy(),
        np.asarray(jres.gather_rows(jnp.asarray(w), jnp.asarray(keep), 8)))
    np.testing.assert_array_equal(
        tres.keep_mask(tk, 8, 8).numpy(),
        np.asarray(jres.keep_mask(jnp.asarray(keep), 8, 8)))
    for use_kernel in (False, True):
        got = tres.switched_matmul(tx, tw, torch.from_numpy(pri), bucket,
                                   buckets=DEFAULT_BUCKETS, block=8,
                                   use_kernel=use_kernel)
        ref = jres.switched_matmul(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(pri), jnp.asarray(bucket),
                                   buckets=DEFAULT_BUCKETS, block=8,
                                   use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    wk = rng.standard_normal((64, 40)).astype(np.float32)
    keep_h = np.asarray([0, 3, 4], np.int32)
    got = tres.resized_ffn(tx, torch.from_numpy(wk), torch.from_numpy(wd),
                           torch.from_numpy(keep_h), tops.silu, tw, block=8)
    ref = jres.resized_ffn(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(wd),
                           jnp.asarray(keep_h), jax.nn.silu, jnp.asarray(w),
                           block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
