"""The port's trainer under a ragged static shard geometry, against the
JAX package's plans, on the CPU.

Two settings of ViT smoke at tp 4 under SEMI (64 FFN blocks of 8):

* ``geometry="chi"`` with a static χ 2 straggler on rank 0: the split is
  (9, 19, 18, 18), padded to 4 x 19 x 8 = 608 lanes, and absorbs the
  straggler, so the controller must plan nothing (as the reference's
  ``TestResidualController`` says);
* ``geometry="20,12,20,12"`` with a round-robin χ 4 straggler that moves
  every 2 steps and ``mig_blocks`` 2: the plans migrate (the test
  asserts it of the reference's own plans, every shed below the smallest
  rank's 12 blocks, so the comparison is not vacuous).

The reference's trainer needs 40-66 s of a CPU core to trace and compile
one step under a geometry (its branch tables: size classes x 8 buckets x
source slots per FFN layer), more than a test file's share of the
suite's time. So its plans are taken from its own ``ControlPlane``
(controller, χ schedule, geometry mode, projection, build cache) driven
in process through the control loop of ``repro.launch.train.
run_training``, with a builder that compiles nothing
(``reference_trajectory``); its numbers under both geometries are
``tests/test_torch_geometry_step.py``'s. The port's ``run_training``
must give identical per-step ``signatures``, ``buckets``, ``mig_shed``,
``mig``, ``gammas``, build counts and ``history["geometry"]``.

And, the port alone: an equal geometry reproduces the geometry-free run
bit for bit; a resumed run under a geometry is bit-identical to an
uninterrupted one (losses, plans, every parameter and moment), and a
resume across geometries raises the reference's ``ValueError``; the
padded lanes of every FFN weight and of both AdamW moments stay exactly
0 through the steps.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store as tstore
from repro_torch.core import geometry as tgeom
from repro_torch.launch.train import run_training

torch.set_num_threads(2)

BASE = dict(tp=4, control_mode="semi", mig_blocks=2, batch=8, seed=0)
CHI_RUN = dict(BASE, hetero_kind="static", chi=2.0, hetero_period=10,
               geometry="chi")
MIG_RUN = dict(BASE, hetero_kind="round_robin", chi=4.0, hetero_period=2,
               geometry="20,12,20,12")
STEPS = 4
TRAJECTORY = ("signatures", "buckets", "mig_shed", "mig", "gammas",
              "plan_compiles", "plan_cache_hits", "geometry")


def reference_trajectory(run, steps):
    """The reference trainer's plan history for ``run``: its control loop
    (``repro.launch.train.run_training``) over its own ControlPlane, with
    a builder that compiles nothing."""
    from repro.config import ShapeConfig, get_config as jget, \
        smoke_variant as jsmoke
    from repro.control import ControlConfig
    from repro.control.plane import ControlPlane
    from repro.core import geometry as jgeom
    from repro.core import hetero as jhetero
    from repro.launch.train import TRAIN_BLOCK, _resolve_geometry

    tp, mig_blocks, max_sources = run["tp"], run["mig_blocks"], 3
    cfg = jsmoke(jget("vit-1b"))
    geo = _resolve_geometry(run["geometry"], cfg, tp,
                            hetero_kind=run["hetero_kind"], chi=run["chi"],
                            period=run["hetero_period"], seed=run["seed"],
                            trace_in=None)
    control = ControlConfig(
        mode=run["control_mode"], hetero_kind=run["hetero_kind"],
        chi=run["chi"], period=run["hetero_period"], block_size=TRAIN_BLOCK,
        max_sources=max_sources, shed_cap=mig_blocks, beta_policy="eq2",
        seed=run["seed"], geometry=geo.sizes,
    ).to_workload(enabled=True,
                  migration_sources=max_sources if mig_blocks > 0 else 0)
    it_model = jhetero.iteration_model(
        cfg, ShapeConfig("trainer", 64, run["batch"], "train"), tp,
        peak_flops=5e9, mfu=1.0)
    plane = ControlPlane(
        jgeom.apply_geometry_cfg(cfg, geo), control, mesh=None, tp=tp,
        builder=lambda st: (None, max(1, st.num_sources)
                            if st is not None else 0, None),
        it_model=it_model, controller_blocks="global",
        hetero_kind=run["hetero_kind"], chi=run["chi"],
        period=run["hetero_period"], seed=run["seed"], geometry=geo.sizes)
    hist = {"gammas": [], "mig": [], "mig_shed": [], "buckets": [],
            "signatures": []}
    for it in range(steps):
        chis = plane.chis(it)
        plan, report = plane.decide(plane.controller_times(chis))
        plane.dispatch(plan)
        work_frac = plane.work_frac(plan)
        plane.capture(chis, work_frac, step=it, plan=plan, wall=0.0)
        hist["gammas"].append(
            {int(k): float(v) for k, v in report.gammas.items()})
        hist["mig"].append(int(report.mig_src))
        hist["mig_shed"].append([list(map(int, report.mig_srcs)),
                                 list(map(int, report.mig_shed))])
        hist["buckets"].append([int(x) for x in report.bucket_by_rank])
        hist["signatures"].append(plan.static.signature_str())
    hist["plan_compiles"] = plane.cache.compile_count
    hist["plan_cache_hits"] = plane.cache.hit_count
    hist["geometry"] = list(geo.sizes)
    return hist


def _assert_port_plans(run, ref):
    got = run_training("vit-1b", steps=STEPS, quiet=True, device="cpu",
                       **run)
    for key in TRAJECTORY:
        assert got[key] == ref[key], key
    assert np.isfinite(got["loss"]).all()


def test_chi_geometry_plans_nothing_as_jax():
    ref = reference_trajectory(CHI_RUN, STEPS)
    assert ref["geometry"] == [9, 19, 18, 18]
    assert all(max(b) == 0 for b in ref["buckets"])
    assert not any(srcs for srcs, _ in ref["mig_shed"])
    _assert_port_plans(CHI_RUN, ref)


def test_migrating_geometry_plans_match_jax():
    ref = reference_trajectory(MIG_RUN, STEPS)
    migrating = [sheds for srcs, sheds in ref["mig_shed"] if srcs]
    assert migrating and all(max(s) < 12 for s in migrating)
    assert len({srcs[0] for srcs, _ in ref["mig_shed"] if srcs}) == 2
    _assert_port_plans(MIG_RUN, ref)


def _flat(tree, p=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{p}/{k}" if p else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{p}/{i}")
    else:
        yield p, np.asarray(tree)


def padding_lanes(geo):
    """Boolean mask of the padded layout's padding lanes."""
    pad = np.ones(geo.padded_blocks, bool)
    for r, L in enumerate(geo.sizes):
        pad[r * geo.max_blocks:r * geo.max_blocks + L] = False
    return np.repeat(pad, geo.block)


# ---------------------------------------------------------------------------
# the port alone: equal geometry, resume, padding
# ---------------------------------------------------------------------------


def padded_lanes_are_zero(tree, geo):
    """Every FFN weight of a padded-layout tree (params, or an AdamW
    moment) holds exact zeros in its padding lanes; returns the number of
    leaves checked."""
    pad = padding_lanes(geo)
    n = 0
    for path, leaf in _flat(tree):
        name = path.rsplit("/", 1)[-1]
        if "/ffn/" not in path or name not in ("w_up", "w_gate", "w_down"):
            continue
        lanes = leaf[..., pad, :] if name == "w_down" else leaf[..., pad]
        assert lanes.size and not lanes.any(), path
        n += 1
    return n


def _ckpt_leaves(path, step):
    return dict(_flat(tstore.load_arrays(path, step)))


def test_equal_geometry_is_the_geometry_free_run(tmp_path):
    kw = dict(BASE, hetero_kind="round_robin", chi=4.0, quiet=True,
              device="cpu")
    a = run_training("vit-1b", steps=3, ckpt_dir=str(tmp_path / "eq"),
                     geometry="16,16,16,16", **kw)
    b = run_training("vit-1b", steps=3, ckpt_dir=str(tmp_path / "none"),
                     geometry=None, **kw)
    assert "geometry" not in a
    for key in ("loss", "signatures", "buckets", "mig_shed"):
        assert a[key] == b[key], key
    la, lb = (_ckpt_leaves(str(tmp_path / "eq"), 3),
              _ckpt_leaves(str(tmp_path / "none"), 3))
    assert la.keys() == lb.keys()
    assert all(la[k].tobytes() == lb[k].tobytes() for k in la)


def test_geometry_resume_is_bit_identical(tmp_path):
    kw = dict(MIG_RUN, quiet=True, device="cpu", ckpt_every=1000)
    full = run_training("vit-1b", steps=4, ckpt_dir=str(tmp_path / "full"),
                        **kw)
    first = run_training("vit-1b", steps=2, ckpt_dir=str(tmp_path / "cut"),
                         **kw)
    rest = run_training("vit-1b", steps=4, resume=True,
                        ckpt_dir=str(tmp_path / "cut"), **kw)
    for key in ("loss", "signatures", "buckets", "mig_shed"):
        assert first[key] + rest[key] == full[key], key
    assert any(srcs for srcs, _ in full["mig_shed"])
    la, lb = (_ckpt_leaves(str(tmp_path / "full"), 4),
              _ckpt_leaves(str(tmp_path / "cut"), 4))
    assert la.keys() == lb.keys()
    assert all(la[k].tobytes() == lb[k].tobytes() for k in la)
    manifest = tstore.read_manifest(str(tmp_path / "cut"), 4)
    assert manifest["extra"]["geometry"] == [20, 12, 20, 12]
    geo = tgeom.ShardGeometry((20, 12, 20, 12), 8)
    state = tstore.load_arrays(str(tmp_path / "cut"), 4)
    # params, mu, nu: two FFN weights each (stacked layers; ViT is ungated)
    assert padded_lanes_are_zero(state["params"], geo) == 2
    assert padded_lanes_are_zero(state["opt"], geo) == 4
    # the checkpoint's layout belongs to its geometry
    for other in ("12,20,12,20", None):
        with pytest.raises(ValueError, match="resuming across geometries"):
            run_training("vit-1b", steps=5, resume=True,
                         ckpt_dir=str(tmp_path / "cut"),
                         **dict(kw, geometry=other))
