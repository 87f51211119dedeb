"""One training step of the port under a ragged static shard geometry,
against ``jax.grad`` of the JAX package's ViT, on the CPU.

ONE subprocess (four host devices, the ``run_py`` pattern of
``tests/test_torch_train.py``) takes ``jax.grad`` of the reference ViT
smoke's loss at tp 4 under one plan of each geometry of
``tests/test_torch_geometry_train.py`` — the χ-seeded (9, 19, 18, 18) at
buckets 0, and (20, 12, 20, 12) with rank 0 the source of a 2-block shed
and ranks 1 and 3 resized to γ 0.5 — with two gamma buckets so that it
compiles in seconds (XLA's cheaper passes, which change how the step is
compiled, not what it computes beyond the tolerances below), from
canonical parameters drawn here with numpy and expanded by each package;
then three AdamW steps under the same plan.

What must hold (f32): the port's loss agrees to rtol 1e-5 and every
gradient within 1e-4·max|ref|, on the plain and the kernel path (whose
plain kernel versions run here), and the padded lanes' gradients are
exactly 0 in both packages; the three steps' losses (the port's train
step on the kernel path) agree to rtol 1e-3, and the port's padding of
weights and AdamW moments stays exactly 0.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.config import get_config, smoke_variant
from repro_torch.control import scopes as scopes_lib
from repro_torch.core import geometry as tgeom
from repro_torch.core.workload import PlanStatic
from repro_torch.layers.tp_linear import ControlContext
from repro_torch.models import vit as tvit

from test_torch_geometry_train import _flat, padding_lanes

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_REL = 1e-4
LOSS_RTOL = 1e-3
TRAIN_STEPS, TRAIN_LR = 3, 1e-3
GRAD_BUCKETS = (0.0, 0.5)
# name -> (sizes, bucket by rank, sources, sheds) of the one-step check
GRAD_PLANS = {"chi": ((9, 19, 18, 18), [0, 0, 0, 0], [-1], ()),
              "mig": ((20, 12, 20, 12), [0, 1, 0, 1], [0], (2,))}

# ---------------------------------------------------------------------------
# one step's loss and gradients against jax.grad
# ---------------------------------------------------------------------------

REFERENCE = r"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.config import ShapeConfig, get_config, smoke_variant
from repro.control import scopes as scopes_lib
from repro.core import geometry as geom
from repro.core.workload import PlanStatic
from repro.data.pipeline import PatternImageStream, patchify
from repro.launch import specs as specs_lib
from repro.launch import steps as steps_lib
from repro.launch.mesh import make_small_mesh
from repro.models import get_api
from repro.optim import adamw
from repro import sharding as sh
from repro.config import TrainConfig

out, gb, plans = sys.argv[1], tuple(json.loads(sys.argv[2])), json.loads(
    sys.argv[3])
n_steps, lr = int(sys.argv[4]), float(sys.argv[5])
train = TrainConfig(learning_rate=lr, steps=n_steps)
update = jax.jit(lambda p, g, s: adamw.apply(p, g, s, train, n_steps)[:2])
with np.load(out + "/canon.npz") as z:
    flat = dict(z)
canon = {}
for key, v in flat.items():
    *path, last = key.split("/")
    node = canon
    for p in path:
        node = node.setdefault(p, {})
    node[last] = v
canon["stack"]["scan"] = (canon["stack"]["scan"]["0"],)
cfg = smoke_variant(get_config("vit-1b"))
api = get_api(cfg)
mesh = make_small_mesh(1, 4)
img = next(iter(PatternImageStream(batch_size=8, seed=5)))
batch = {"patches": jnp.asarray(patchify(img["images"])),
         "labels": jnp.asarray(img["labels"])}
res = {"patches": np.asarray(batch["patches"]),
       "labels": np.asarray(batch["labels"])}
for name, (sizes, buckets, srcs, sheds) in plans.items():
    sizes = tuple(sizes)
    geo = geom.ShardGeometry(sizes, 8)
    pcfg = geom.apply_geometry_cfg(cfg, geo)
    params = geom.expand_ffn_params(canon, geo)
    rules = specs_lib.rules_for(ShapeConfig("trainer", 64, 8, "train"),
                                mesh, pcfg)
    st = PlanStatic(buckets=gb, block_size=8, tp_size=4,
                    mig_shed=tuple(sheds), geometry=sizes)
    st = dataclasses.replace(
        st, scope_blocks=scopes_lib.scope_block_table(pcfg, st))
    scopes = scopes_lib.control_scopes(pcfg, st)
    rng = np.random.default_rng(3)
    # shuffled lists for the attention scopes; the FFN keeps the
    # canonical order under a geometry (as the control plane dispatches)
    pri_lists = {n: rng.permutation(
        nb * (1 if scopes_lib.SCOPE_LAYOUT[n] == "col" else 4)).astype(
            np.int32) for n, nb in sorted(scopes.items()) if n != "ffn"}
    plan = {"bucket_by_rank": jnp.asarray(buckets, jnp.int32),
            "mig_src": jnp.asarray(srcs, jnp.int32),
            "pri": scopes_lib.plan_pri_arrays(scopes, pri_lists, 4,
                                              geometry=sizes)}
    with sh.use_mesh(mesh), sh.use_rules(rules):
        ctx = steps_lib.make_ctx(mesh, st, plan)
        step = jax.jit(jax.value_and_grad(
            lambda p: api.loss_fn(p, pcfg, batch, ctx=ctx)[0]))
        # host arrays in, every step, so that each function compiles once
        host = lambda t: jax.tree.map(np.asarray, t)
        p, opt = params, host(adamw.init(params))
        losses = []
        for k in range(n_steps):
            loss, g = step(p)
            if k == 0:
                grads = g
            losses.append(np.asarray(loss))
            p, opt = host(update(p, g, opt))
    res[name + "/loss"] = losses[0]
    res[name + "/losses"] = np.stack(losses)
    for n, v in pri_lists.items():
        res[name + "/pri/" + n] = v
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        res[name + "/grad/" + jax.tree_util.keystr(path)] = np.asarray(leaf)
np.savez(out + "/grads.npz", **res)
"""


def _canonical_params():
    """ViT smoke parameters in the JAX layout, drawn with numpy."""
    cfg = smoke_variant(get_config("vit-1b"))
    tree = bridge.vit_params_to_numpy(tvit.init(None, cfg, torch.float32,
                                                "cpu"))
    rng = np.random.default_rng(11)
    return {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
            for k, v in _flat(tree)}


def _tree(flat):
    tree = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    tree["stack"]["scan"] = (tree["stack"]["scan"]["0"],)
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_geometry_grads"))
    canon = _canonical_params()
    np.savez(os.path.join(out, "canon.npz"), **canon)
    env = dict(os.environ)
    # XLA's cheaper optimization passes: they change how the reference's
    # step is compiled (in half the time), not what it computes beyond
    # the tolerances below
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_backend_optimization_level=0 "
                        "--xla_llvm_disable_expensive_passes=true")
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), out,
         json.dumps(GRAD_BUCKETS), json.dumps(GRAD_PLANS),
         str(TRAIN_STEPS), str(TRAIN_LR)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(os.path.join(out, "grads.npz")) as z:
        ref = dict(z)
    return canon, ref


def _keyed(tree, p=""):
    """Leaves keyed as ``jax.tree_util.keystr`` spells their paths."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _keyed(v, f"{p}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _keyed(v, f"{p}[{i}]")
    else:
        yield p, np.asarray(tree)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", sorted(GRAD_PLANS))
def test_geometry_step_gradients_match_jax(reference, name, use_kernel):
    canon, ref = reference
    sizes, buckets, srcs, sheds = GRAD_PLANS[name]
    cfg = smoke_variant(get_config("vit-1b"))
    geo = tgeom.ShardGeometry(sizes, 8)
    pcfg = tgeom.apply_geometry_cfg(cfg, geo)
    model = bridge.expand_ffn_modules(
        bridge.vit_params_from_jax(_tree(canon), cfg, "cpu"), geo)
    st = PlanStatic(buckets=GRAD_BUCKETS, block_size=8, tp_size=4,
                    mig_shed=sheds, geometry=sizes)
    st = dataclasses.replace(
        st, scope_blocks=scopes_lib.scope_block_table(pcfg, st))
    scopes = scopes_lib.control_scopes(pcfg, st)
    pri = scopes_lib.plan_pri_arrays(
        scopes, {n: ref[f"{name}/pri/{n}"] for n in scopes if n != "ffn"},
        4, geometry=sizes)
    ctx = ControlContext(static=st, bucket_by_rank=buckets, pri=pri,
                         use_kernel=use_kernel, mig_src=srcs)
    batch = {"patches": torch.from_numpy(ref["patches"]),
             "labels": torch.from_numpy(ref["labels"])}
    loss, _ = tvit.loss_fn(model, pcfg, batch, ctx=ctx)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref[f"{name}/loss"],
                               rtol=1e-5)
    trained = dict(model.named_parameters())
    grads = tvit.init(None, pcfg, torch.float32, "cpu")
    with torch.no_grad():
        for n, g in grads.named_parameters():
            g.copy_(trained[n].grad)
    pad = padding_lanes(geo)
    n_ffn = 0
    for path, leaf in _keyed(bridge.vit_params_to_numpy(grads)):
        r = ref[f"{name}/grad/{path}"]
        assert leaf.shape == r.shape, path
        err = float(np.abs(leaf - r).max())
        assert err <= GRAD_REL * float(np.abs(r).max()), (path, err)
        if "['ffn']" in path:
            for t in (leaf, r):
                lanes = t[:, pad] if "w_down" in path else t[..., pad]
                assert not lanes.any(), path
            n_ffn += 1
    assert n_ffn == 2                          # w_up, w_down (ungated)


@pytest.mark.parametrize("name", sorted(GRAD_PLANS))
def test_geometry_training_steps_match_jax(reference, name):
    """A few AdamW steps under the plan (the port's train step on its
    kernel path against jax.grad + the reference's AdamW): the losses agree
    to rtol 1e-3, and the padding stays exactly 0 in both packages'
    weights and moments (here: the port's)."""
    from repro_torch.config import TrainConfig
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw
    canon, ref = reference
    sizes, buckets, srcs, sheds = GRAD_PLANS[name]
    cfg = smoke_variant(get_config("vit-1b"))
    geo = tgeom.ShardGeometry(sizes, 8)
    pcfg = tgeom.apply_geometry_cfg(cfg, geo)
    model = bridge.expand_ffn_modules(
        bridge.vit_params_from_jax(_tree(canon), cfg, "cpu"), geo)
    st = PlanStatic(buckets=GRAD_BUCKETS, block_size=8, tp_size=4,
                    mig_shed=sheds, geometry=sizes)
    step = steps_lib.build_train_step(
        pcfg, TrainConfig(learning_rate=TRAIN_LR, steps=TRAIN_STEPS), st,
        total_steps=TRAIN_STEPS, use_kernel=True)
    scopes = scopes_lib.control_scopes(pcfg, st)
    plan = {"bucket_by_rank": np.asarray(buckets, np.int32),
            "mig_src": np.asarray(srcs, np.int32),
            "pri": scopes_lib.plan_pri_arrays(
                scopes, {n: ref[f"{name}/pri/{n}"] for n in scopes
                         if n != "ffn"}, 4, geometry=sizes)}
    batch = {"patches": torch.from_numpy(ref["patches"]),
             "labels": torch.from_numpy(ref["labels"])}
    opt = adamw.init(dict(model.named_parameters()))
    losses = []
    for _ in range(TRAIN_STEPS):
        opt, metrics = step(model, opt, batch, plan)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref[f"{name}/losses"],
                               rtol=LOSS_RTOL)
    pad = torch.from_numpy(padding_lanes(geo))
    for n, p in model.named_parameters():
        if ".ffn." in n:
            for t in (p.detach(), opt.mu[n], opt.nu[n]):
                lanes = t[pad] if n.endswith("w_down") else t[:, pad]
                assert not lanes.any(), n
