"""The port's training path against the JAX package, on the CPU.

One subprocess (four host devices, the ``run_py`` pattern of
``tests/test_multi_straggler.py``) runs the reference: its
``run_training`` on ViT smoke at tp=4 under SEMI (round-robin χ=4
straggler, ``mig_blocks=2``) for 12 steps, the same for 3 steps with
``use_kernel=True`` (Pallas in interpret mode), its initial parameters
(a ``steps=0`` run with ``ckpt_dir`` saves exactly those), and
``jax.grad`` of its ViT ``loss_fn`` under one fixed plan with a resized
straggler and a migration source. The port runs in process on the CPU
from the same initial parameters.

What must hold, and to what tolerance:

* the controller's trajectory — per-step ``signatures``, ``buckets``,
  ``mig_shed``, ``gammas``, and the build-cache counts — is identical;
* the loss curve agrees to rtol 1e-3 (f32 throughout; the two differ only
  in summation order, which AdamW's normalised steps carry forward);
  the largest gap reached is asserted below its bound and printed;
* every parameter gradient of one step agrees with ``jax.grad`` to
  max |err| <= 1e-4 * max |ref| per leaf, on the plain path and on the
  kernel path (whose plain kernel versions run here).

The losslessness of migration (forward and gradients equal to the dense
pair, 1-3 concurrent sources) and the small ported pieces
(``chunked_psum``, the helper partition, the imputation policies) are
checked here too.
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
from repro_torch.core import migration as tmig
from repro_torch.core import resizing as tres
from repro_torch.core.workload import PlanStatic
from repro_torch.launch.train import run_training
from repro_torch.layers.tp_linear import ControlContext, controlled_ffn
from repro_torch.kernels import ops as tops
from repro_torch.models import vit as tvit
from repro_torch.parallel import TPGroup

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(tp=4, control_mode="semi", hetero_kind="round_robin", chi=4.0,
           mig_blocks=2, batch=8, seed=0)
STEPS, KERNEL_STEPS = 12, 3
LOSS_RTOL = 1e-3
GRAD_REL = 1e-4

# the plan of the one-step gradient check: rank 0 resized to bucket 5 and
# the migration source of a 2-block shed, rank 2 at bucket 2
GRAD_PLAN = dict(buckets=[5, 0, 2, 0], mig_src=[0], sheds=(2,), pri_seed=3)

REFERENCE = r"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.checkpoint import store
from repro.config import ShapeConfig, get_config, smoke_variant
from repro.control import scopes as scopes_lib
from repro.core.workload import PlanStatic
from repro.data.pipeline import PatternImageStream, patchify
from repro.launch import specs as specs_lib
from repro.launch import steps as steps_lib
from repro.launch.mesh import make_small_mesh
from repro.launch.train import run_training
from repro.models import get_api
from repro import sharding as sh

out, run, steps, ksteps, gp = sys.argv[1], json.loads(sys.argv[2]), \
    int(sys.argv[3]), int(sys.argv[4]), json.loads(sys.argv[5])
keys = ["loss", "gammas", "mig", "mig_shed", "buckets", "signatures",
        "plan_compiles", "plan_cache_hits"]
res = {}
h = run_training("vit-1b", steps=steps, quiet=True, **run)
res["plain"] = {k: h[k] for k in keys}
h = run_training("vit-1b", steps=ksteps, quiet=True, use_kernel=True, **run)
res["kernel"] = {k: h[k] for k in keys}
run_training("vit-1b", steps=0, quiet=True, ckpt_dir=out + "/ck", **run)
with open(out + "/hist.json", "w") as f:
    json.dump(res, f)

# one-step gradients of the ViT loss under a fixed plan
params = store.load_arrays(out + "/ck", 0, prefix="params")
params["stack"]["scan"] = (params["stack"]["scan"]["0"],)
cfg = smoke_variant(get_config("vit-1b"))
api = get_api(cfg)
mesh = make_small_mesh(1, 4)
shape = ShapeConfig("trainer", 64, 8, "train")
rules = specs_lib.rules_for(shape, mesh, cfg)
st = PlanStatic(block_size=8, tp_size=4, mig_shed=tuple(gp["sheds"]))
st = dataclasses.replace(st, scope_blocks=scopes_lib.scope_block_table(cfg, st))
scopes = scopes_lib.control_scopes(cfg, st)
rng = np.random.default_rng(gp["pri_seed"])
pri_lists = {n: rng.permutation(nb * (1 if scopes_lib.SCOPE_LAYOUT[n] == "col"
                                      else 4)).astype(np.int32)
             for n, nb in sorted(scopes.items())}
plan = {"bucket_by_rank": jnp.asarray(gp["buckets"], jnp.int32),
        "mig_src": jnp.asarray(gp["mig_src"], jnp.int32),
        "pri": scopes_lib.plan_pri_arrays(scopes, pri_lists, 4)}
img = next(iter(PatternImageStream(batch_size=8, seed=5)))
batch = {"patches": jnp.asarray(patchify(img["images"])),
         "labels": jnp.asarray(img["labels"])}
with sh.use_mesh(mesh), sh.use_rules(rules):
    ctx = steps_lib.make_ctx(mesh, st, plan)
    jp = jax.tree.map(jnp.asarray, params)
    loss, grads = jax.value_and_grad(
        lambda p: api.loss_fn(p, cfg, batch, ctx=ctx)[0])(jp)
flat = {"loss": np.asarray(loss), "patches": np.asarray(batch["patches"]),
        "labels": np.asarray(batch["labels"])}
for n, v in pri_lists.items():
    flat["pri/" + n] = v
for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
    flat["grad/" + jax.tree_util.keystr(path)] = np.asarray(leaf)
np.savez(out + "/grads.npz", **flat)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_reference"))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), out,
         json.dumps(RUN), str(STEPS), str(KERNEL_STEPS),
         json.dumps(GRAD_PLAN)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(out, "hist.json")) as f:
        hist = json.load(f)
    from repro.checkpoint import store
    params = store.load_arrays(os.path.join(out, "ck"), 0, prefix="params")
    params["stack"]["scan"] = (params["stack"]["scan"]["0"],)
    with np.load(os.path.join(out, "grads.npz")) as g:
        grads = {k: g[k] for k in g.files}
    return {"hist": hist, "params": params, "grads": grads}


def _port_run(reference, steps, use_kernel):
    return run_training("vit-1b", steps=steps, quiet=True, device="cpu",
                        use_kernel=use_kernel,
                        init_params=reference["params"], **RUN)


def _assert_same_trajectory(got, ref):
    for key in ("signatures", "buckets", "mig_shed", "mig",
                "plan_compiles", "plan_cache_hits"):
        assert got[key] == ref[key], key
    assert [{str(k): v for k, v in g.items()} for g in got["gammas"]] \
        == ref["gammas"]
    gap = np.max(np.abs(np.asarray(got["loss"]) - ref["loss"])
                 / np.abs(ref["loss"]))
    print(f"largest relative loss gap over {len(ref['loss'])} steps: "
          f"{gap:.2e}")
    assert gap <= LOSS_RTOL


def test_semi_training_matches_jax(reference):
    """12 steps: the straggler is resized (bucket 7) and migrates 2
    blocks at every step, moves from rank 0 to rank 1 at step 10, and
    the priority lists switch to the observed weights at step 10."""
    ref = reference["hist"]["plain"]
    assert any(max(b) > 0 for b in ref["buckets"])
    assert any(srcs for srcs, _ in ref["mig_shed"])
    _assert_same_trajectory(_port_run(reference, STEPS, False), ref)


def test_semi_training_kernel_path_matches_jax(reference):
    _assert_same_trajectory(_port_run(reference, KERNEL_STEPS, True),
                            reference["hist"]["kernel"])


def _port_grads(reference, use_kernel):
    cfg = smoke_variant(get_config("vit-1b"))
    ref = reference["grads"]
    model = bridge.vit_params_from_jax(reference["params"], cfg, "cpu")
    st = PlanStatic(block_size=8, tp_size=4, mig_shed=GRAD_PLAN["sheds"])
    st = dataclasses.replace(
        st, scope_blocks=scopes_lib.scope_block_table(cfg, st))
    scopes = scopes_lib.control_scopes(cfg, st)
    pri = scopes_lib.plan_pri_arrays(
        scopes, {n: ref["pri/" + n] for n in scopes}, 4)
    ctx = ControlContext(static=st, bucket_by_rank=GRAD_PLAN["buckets"],
                         pri=pri, use_kernel=use_kernel,
                         mig_src=GRAD_PLAN["mig_src"])
    batch = {"patches": torch.from_numpy(ref["patches"]),
             "labels": torch.from_numpy(ref["labels"])}
    loss, _ = tvit.loss_fn(model, cfg, batch, ctx=ctx)
    loss.backward()
    got = {}
    for name in ("patch_proj", "cls", "pos", "norm_f", "head"):
        got[f"['{name}']"] = getattr(model, name).grad.numpy()
    for i, blk in enumerate(model.layers):
        for grp in ("attn", "ffn"):
            for n, t in getattr(blk, grp).named_parameters():
                key = f"['stack']['scan'][0]['{grp}']['{n}']"
                got.setdefault(key, []).append(t.grad.numpy())
        for n in ("norm1", "norm2"):
            got.setdefault(f"['stack']['scan'][0]['{n}']", []).append(
                getattr(blk, n).grad.numpy())
    return float(loss.detach()), {k: np.stack(v) if isinstance(v, list) else v
                         for k, v in got.items()}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_one_step_gradients_match_jax_grad(reference, use_kernel):
    ref = reference["grads"]
    loss, got = _port_grads(reference, use_kernel)
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    ref_keys = {k[len("grad/"):] for k in ref if k.startswith("grad/")}
    assert set(got) == ref_keys
    for key, g in got.items():
        r = ref["grad/" + key]
        assert g.shape == r.shape, key
        err = float(np.abs(g - r).max())
        assert err <= GRAD_REL * float(np.abs(r).max()), (key, err)


# ---------------------------------------------------------------------------
# migration is lossless: 1-3 concurrent sources at bucket 0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("srcs,sheds", [([2], (3,)), ([0, 3], (2, 2)),
                                        ([1, 2, 3], (3, 2, 1))])
def test_controlled_ffn_migration_is_lossless(srcs, sheds, gated):
    e, block, d, T = 4, 8, 24, 10
    H = e * 6 * block
    rng = np.random.default_rng(len(srcs) + 10 * gated)

    def leaf(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * 0.3).astype(np.float32)
        ).requires_grad_()
    x, w_up, w_down = leaf(T, d), leaf(d, H), leaf(H, d)
    w_gate = leaf(d, H) if gated else None
    act = tops.silu if gated else tops.gelu
    st = PlanStatic(buckets=(0.0, 0.5), block_size=block, tp_size=e,
                    mig_shed=sheds)
    pri = torch.from_numpy(np.stack([rng.permutation(6) for _ in range(e)])
                           .astype(np.int32))
    ctx = ControlContext(static=st, bucket_by_rank=[0] * e,
                         pri={"ffn": pri}, mig_src=srcs)
    leaves = [x, w_up, w_down] + ([w_gate] if gated else [])
    y = controlled_ffn(x, w_up, w_down, ctx, "ffn", act, w_gate=w_gate)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    got = torch.autograd.grad(y, leaves, dy)
    h = x @ w_up
    h = act(x @ w_gate) * h if gated else act(h)
    y_ref = h @ w_down
    want = torch.autograd.grad(y_ref, leaves, dy)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_migration_assignment_matches_jax():
    import jax.numpy as jnp
    from repro.core import migration as jmig
    for e, srcs, sheds in ((4, [2], (3,)), (4, [0, 3], (2, 5)),
                           (8, [1, -1, 6], (4, 3, 2)), (4, [1, 2, 3],
                                                        (3, 2, 1))):
        for r in range(e):
            got = tmig.multi_migration_assignment(r, srcs, e, sheds)
            los, mp, helps = jmig.multi_migration_assignment(
                jnp.int32(r), jnp.asarray(srcs, jnp.int32), e, sheds)
            assert got[0] == [int(v) for v in los]
            assert got[1] == tuple(int(v) for v in mp)
            assert got[2] == [bool(v) for v in helps]


def test_group_collectives():
    g = TPGroup(4)
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.standard_normal((3, 12)).astype(np.float32))
             for _ in range(4)]
    want = parts[0] + parts[1] + parts[2] + parts[3]
    assert torch.equal(g.psum(parts), want)
    for n in (1, 3, 5, 12, 40):            # 5 falls back to 4, 40 to 12
        torch.testing.assert_close(g.chunked_psum(parts, n), want)
    w = torch.arange(48.0).reshape(4, 12)
    assert torch.equal(g.cols(w, 2), w[:, 6:9])
    assert torch.equal(g.rows(w.t(), 1), w.t()[3:6])
    # the grouped masked broadcast: each slot gets its source's buffers
    # (only the source's are computed), an idle slot (-1) zeros
    asked = []

    def value_of(r, s):
        asked.append((r, s))
        return parts[r], None
    got = g.bcast_grouped([3, -1], value_of)
    assert got[0][0] is parts[3] and got[0][1] is None
    assert torch.equal(got[1][0], torch.zeros_like(parts[0]))
    assert got[1][1] is None and asked == [(3, 0), (0, 1)]
    for bad in (-2, 4):
        with pytest.raises(ValueError):
            g.bcast_grouped([bad], value_of)
    with pytest.raises(ValueError):
        g.psum(parts[:3])


# ---------------------------------------------------------------------------
# resizing: scatter and the imputation policies against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["zero", "average", "same"])
def test_imputation_matches_jax(mode):
    import jax.numpy as jnp
    from repro.core import resizing as jres
    rng = np.random.default_rng(7)
    g = rng.standard_normal((32, 6)).astype(np.float32)
    prev = rng.standard_normal((32, 6)).astype(np.float32)
    keep = np.array([3, 0], np.int32)
    kept = np.asarray(jres.keep_mask(jnp.asarray(keep), 4, 8))
    np.testing.assert_array_equal(
        tres.keep_mask(torch.from_numpy(keep), 4, 8).numpy(), kept)
    ref = np.asarray(jres.impute_rows(jnp.asarray(g), jnp.asarray(kept),
                                      mode, jnp.asarray(prev)))
    got = tres.impute_gradients(
        {"w": torch.from_numpy(g), "b": torch.ones(6)},
        {"w": torch.from_numpy(np.array(kept)), "b": None}, mode,
        {"w": torch.from_numpy(prev)})
    np.testing.assert_allclose(got["w"].numpy(), ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(got["b"], torch.ones(6))
    xk = rng.standard_normal((2, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        tres.scatter_cols(torch.from_numpy(xk), torch.from_numpy(keep), 8,
                          32).numpy(),
        np.asarray(jres.scatter_cols(jnp.asarray(xk), jnp.asarray(keep), 8,
                                     32)))


def test_trainer_refuses_what_later_slices_bring():
    for kw in ({"selection": "priority_diff"}, {"dp": 2}):
        with pytest.raises(NotImplementedError, match="slice"):
            run_training("vit-1b", steps=1, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="language model"):
        run_training("yi-6b", steps=1, device="cpu")


def test_train_cli_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = tmp_path / "hist.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "2", "--tp", "4", "--control", "semi", "--hetero",
         "round_robin", "--chi", "4", "--mig-blocks", "2", "--use-kernel",
         "--out", str(out)], capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    hist = json.loads(out.read_text())
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    assert hist["signatures"] == ["tp4b8shed[2]"] * 2


def test_measured_mode_gathers_rank_times_every_step():
    """times="measured": the estimator consumes the captured per-rank
    times, gathered over the emulated group once per control interval
    (here every step), as the reference counts its all-gathers."""
    hist = run_training("vit-1b", steps=3, quiet=True, device="cpu",
                        times="measured", **RUN)
    assert hist["times_mode"] == "measured"
    assert hist["rank_gathers"] == 3
    assert len(hist["chi_hat"]) == 4
    assert np.isfinite(hist["loss"]).all()
