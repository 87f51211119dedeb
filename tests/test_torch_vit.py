"""The port's ViT, AdamW and bridge against the JAX package, on the CPU.

Same inputs (numpy, from a seed) through the JAX functions and the port's,
float32. Tolerances: logits, loss and gradients of the dense model to
max |err| <= 1e-5 * max |ref| (only the summation order differs); AdamW
parameters after three updates to 1e-6 absolute (the same elementwise
arithmetic, in f32, on O(1) values); the learning-rate schedule exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_config as jget_config
from repro.config import smoke_variant as jsmoke
from repro.models import vit as jvit
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.config import TrainConfig, get_config, smoke_variant
from repro_torch.data import pipeline as tpipe
from repro_torch.models import vit as tvit
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(1)

REL = 1e-5


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= rel * float(np.abs(ref).max())


@pytest.fixture(scope="module")
def vit_pair():
    jcfg = jsmoke(jget_config("vit-1b"))
    params, _ = jvit.init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    np_tree = jax.tree.map(np.asarray, params)
    tcfg = smoke_variant(get_config("vit-1b"))
    return jcfg, params, np_tree, tcfg


def _batch(seed=0, batch=4):
    img = next(iter(tpipe.PatternImageStream(batch_size=batch, seed=seed)))
    return tpipe.patchify(img["images"]), img["labels"]


def test_vit_bridge_round_trip(vit_pair):
    _, _, np_tree, tcfg = vit_pair
    model = bridge.vit_params_from_jax(np_tree, tcfg, device="cpu")
    back = bridge.vit_params_to_numpy(model)
    flat_a, tree_a = jax.tree.flatten(np_tree)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert all(p.requires_grad for p in model.parameters())


def test_vit_forward_and_loss_match_jax(vit_pair):
    jcfg, params, np_tree, tcfg = vit_pair
    patches, labels = _batch()
    ref = np.asarray(jvit.forward(params, jcfg, jnp.asarray(patches)))
    model = bridge.vit_params_from_jax(np_tree, tcfg, device="cpu")
    with torch.inference_mode():
        got = tvit.forward(model, tcfg, torch.from_numpy(patches))
    _close(got.numpy(), ref)
    jl, jm = jvit.loss_fn(params, jcfg, {"patches": jnp.asarray(patches),
                                         "labels": jnp.asarray(labels)})
    tl, tm = tvit.loss_fn(model, tcfg, {"patches": torch.from_numpy(patches),
                                        "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert float(tm["acc"]) == float(jm["acc"])


def test_dense_vit_gradients_match_jax(vit_pair):
    jcfg, params, np_tree, tcfg = vit_pair
    patches, labels = _batch(seed=1)
    jb = {"patches": jnp.asarray(patches), "labels": jnp.asarray(labels)}
    grads = jax.grad(lambda p: jvit.loss_fn(p, jcfg, jb)[0])(params)
    model = bridge.vit_params_from_jax(np_tree, tcfg, device="cpu")
    loss, _ = tvit.loss_fn(model, tcfg, {"patches": torch.from_numpy(patches),
                                         "labels": torch.from_numpy(labels)})
    loss.backward()
    ghost = tvit.init(None, tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for g, p in zip(ghost.parameters(), model.parameters()):
            g.copy_(p.grad)
    got = bridge.vit_params_to_numpy(ghost)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(grads)):
        _close(a, b)


def test_adamw_matches_jax():
    rng = np.random.default_rng(0)
    params = {f"w{i}": rng.standard_normal((5 + i, 3)).astype(np.float32)
              for i in range(40)}
    grads = [{k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    for wd, clip in ((0.0, 1.0), (0.01, 1.0), (0.0, 0.0)):
        jcfg = JTrainConfig(weight_decay=wd, grad_clip=clip)
        tcfg = TrainConfig(weight_decay=wd, grad_clip=clip)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        js = jadamw.init(jp)
        tp = {k: torch.tensor(v) for k, v in params.items()}
        ts = tadamw.init(tp)
        japply = jax.jit(lambda p, g, s, c=jcfg: jadamw.apply(p, g, s, c, 12))
        for g in grads:
            jp, js, jm = japply(
                jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
            ts, tm = tadamw.apply(
                tp, {k: torch.tensor(v) for k, v in g.items()}, ts, tcfg, 12)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-6)
            assert tm["lr"] == float(jm["lr"])
        assert ts.step == int(js.step) == 3
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("total", [0, 5, 12, 200])
def test_lr_schedule_matches_jax(total):
    cfg = TrainConfig()
    for step in range(0, 30):
        ref = float(jadamw.lr_at(jnp.int32(step), JTrainConfig(), total))
        assert tadamw.lr_at(step, cfg, total) == ref


def test_adamw_state_bridge_round_trip(vit_pair):
    _, _, np_tree, tcfg = vit_pair
    rng = np.random.default_rng(1)
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), np_tree)
    nu = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32),
                      np_tree)
    js = jadamw.AdamWState(step=np.int32(7), mu=mu, nu=nu)
    ts = bridge.adamw_state_from_jax(tuple(js), tcfg, device="cpu")
    assert ts.step == 7
    model = bridge.vit_params_from_jax(np_tree, tcfg, device="cpu")
    assert set(ts.mu) == {n for n, _ in model.named_parameters()}
    step, mu2, nu2 = bridge.adamw_state_to_numpy(ts, tcfg)
    assert int(step) == 7
    for a, b in zip(jax.tree.leaves((mu, nu)), jax.tree.leaves((mu2, nu2))):
        np.testing.assert_array_equal(a, b)


def test_pipeline_is_the_reference_copy():
    from repro.data import pipeline as jpipe
    a = next(iter(jpipe.PatternImageStream(batch_size=3, seed=9)))
    b = next(iter(tpipe.PatternImageStream(batch_size=3, seed=9)))
    np.testing.assert_array_equal(a["images"], b["images"])
    np.testing.assert_array_equal(jpipe.patchify(a["images"]),
                                  tpipe.patchify(b["images"]))
    ja = iter(jpipe.TokenTaskStream(64, 16, 2, seed=1))
    ta = iter(tpipe.TokenTaskStream(64, 16, 2, seed=1))
    jpipe.skip_batches(ja, 2)
    tpipe.skip_batches(ta, 2)
    np.testing.assert_array_equal(next(ja)["tokens"], next(ta)["tokens"])


def test_dense_training_matches_jax_at_a_wider_config():
    """Four dense AdamW steps of a 6-layer, d_model-512 ViT at lr 1e-4
    (wider and deeper than the smoke variant): the port's losses follow
    the reference's step by step (rtol 1e-5). At this width the
    reference's own loss rises after the first update (Adam's first,
    sign-like step moves every weight at once), which the full-width run
    on the card shows too."""
    import dataclasses
    kw = dict(num_layers=6, d_model=512, num_heads=4, num_kv_heads=4,
              head_dim=128, d_ff=2048)

    def wider(cfg):
        cfg = dataclasses.replace(cfg, **kw)
        return dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, embed_dim=512))
    jc, tc = wider(jget_config("vit-1b")), wider(get_config("vit-1b"))
    steps, lr = 4, 1e-4
    params, _ = jvit.init(jax.random.PRNGKey(0), jc, jnp.float32)
    model = bridge.vit_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                       device="cpu")
    jcfg = JTrainConfig(learning_rate=lr, steps=steps)
    tcfg = TrainConfig(learning_rate=lr, steps=steps)

    @jax.jit
    def jstep(p, s, b):
        loss, g = jax.value_and_grad(lambda q: jvit.loss_fn(q, jc, b)[0])(p)
        p, s, _ = jadamw.apply(p, g, s, jcfg, steps)
        return loss, p, s
    js = jadamw.init(params)
    named = dict(model.named_parameters())
    ts = tadamw.init(named)
    stream = iter(tpipe.PatternImageStream(batch_size=8, seed=0))
    j_loss, t_loss = [], []
    for _ in range(steps):
        img = next(stream)
        b = {"patches": tpipe.patchify(img["images"]),
             "labels": img["labels"]}
        loss, params, js = jstep(params, js,
                                 {k: jnp.asarray(v) for k, v in b.items()})
        j_loss.append(float(loss))
        for p in named.values():
            p.grad = None
        tl, _ = tvit.loss_fn(model, tc, {k: torch.from_numpy(np.array(v))
                                         for k, v in b.items()})
        tl.backward()
        ts, _ = tadamw.apply(named, {n: p.grad for n, p in named.items()},
                             ts, tcfg, steps)
        t_loss.append(float(tl.detach()))
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    assert j_loss[1] > j_loss[0]
