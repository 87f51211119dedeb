"""The port's ragged static shard geometry against the JAX package's, on
the CPU: ``repro_torch.core.geometry``, the bridge's torch layout
transforms, the control plane's geometry mode and the ragged
``controlled_ffn``.

What must hold, and to what tolerance:

* every public function of ``core/geometry.py`` gives the reference's
  result (or raises its exception, type and message) on the same inputs:
  seeded random partitions, a seeded grid of χ vectors and totals, the
  model configs, the CLI forms, and the expand / restrict transforms on
  Yi-6B and ViT smoke parameter trees (identical arrays, exact round
  trip). ``geometry_from_chi`` keeps the sum and the minimum everywhere;
  it is NOT monotone in χ: ``([1, 1, 1, 2], 5, 8)`` gives the slowest rank
  the most blocks in both packages (the reference's ``min_blocks``
  clamp), and the port keeps that result on purpose;
* the bridge's torch transform gives the numpy transform's arrays;
* the control plane's geometry-mode validations raise what the
  reference's raise, and a valid plane gives the reference's controller
  times, identity priority rows and dispatched plans;
* the ragged ``controlled_ffn`` — sizes of two and three size classes,
  gated and ungated, under a neutral plan and a migrating plan that also
  resizes (one and two sources) — matches the reference's forward within 1e-5·max|ref|
  (f32), on the plain and the kernel path (whose plain versions run
  here), and one plan's gradients, restricted to canonical space, within
  1e-4·max|ref|; the padded lanes' gradients are exactly 0. The
  reference runs in ONE subprocess with four host devices (the
  ``run_py`` pattern of ``tests/test_torch_train.py``), with three gamma
  buckets so that its branch tables compile quickly.
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

from repro.core import geometry as jgeom
from repro_torch import bridge
from repro_torch.config import get_config, smoke_variant
from repro_torch.core import geometry as tgeom
from repro_torch.core.workload import PlanStatic
from repro_torch.kernels import ops as tops
from repro_torch.layers.tp_linear import ControlContext, controlled_ffn
from repro_torch.models import lm as tlm
from repro_torch.models import vit as tvit
from repro_torch.parallel import TPGroup, ragged_local_width

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_REL, GRAD_REL = 1e-5, 1e-4


def _outcome(fn, *args, **kw):
    """("ok", result) or (exception type name, message)."""
    try:
        return "ok", fn(*args, **kw)
    except (ValueError, AssertionError) as e:
        return type(e).__name__, str(e)


def _same_geo(a, b):
    """Two ShardGeometry results (or two raises) agree."""
    assert a[0] == b[0], (a, b)
    if a[0] != "ok":
        assert a[1] == b[1]
        return
    ga, gb = a[1], b[1]
    for attr in ("sizes", "block", "tp", "total_blocks", "max_blocks",
                 "min_blocks", "offsets", "padded_blocks", "padded_width",
                 "width", "is_equal"):
        assert getattr(ga, attr) == getattr(gb, attr), attr
    assert ga.describe() == gb.describe()


# ---------------------------------------------------------------------------
# core/geometry.py against the reference
# ---------------------------------------------------------------------------


def _random_sizes(rng, tp, total):
    """A random partition of ``total`` blocks over ``tp`` ranks, each >= 1
    (``total >= tp``, so the draw's range is never empty)."""
    return tuple(int(v) for v in
                 1 + rng.multinomial(total - tp, np.ones(tp) / tp))


def test_shard_geometry_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(60):
        tp = int(rng.integers(1, 7))
        total = int(rng.integers(tp, 65))
        sizes = _random_sizes(rng, tp, total)
        block = int(rng.choice([1, 8, 64]))
        a = _outcome(tgeom.ShardGeometry, sizes=sizes, block=block)
        b = _outcome(jgeom.ShardGeometry, sizes=sizes, block=block)
        _same_geo(a, b)
        g = a[1]
        assert sum(g.sizes) == g.total_blocks == total
        assert g.offsets[0] == 0 and all(
            g.offsets[r + 1] - g.offsets[r] == g.sizes[r]
            for r in range(tp - 1))
        assert g.padded_blocks == tp * max(sizes)
        owners = [g.rank_of_block(i) for i in range(total)]
        assert owners == [jgeom.ShardGeometry(sizes, block).rank_of_block(i)
                          for i in range(total)]
    for sizes, block in (((), 8), ((0, 3), 8), ((2, 2), 0)):
        _same_geo(_outcome(tgeom.ShardGeometry, sizes=sizes, block=block),
                  _outcome(jgeom.ShardGeometry, sizes=sizes, block=block))
    for args in ((32, 4, 8), (30, 4, 8), (7, 1, 64)):
        _same_geo(_outcome(tgeom.equal_geometry, *args),
                  _outcome(jgeom.equal_geometry, *args))


def test_geometry_from_chi_matches_reference():
    rng = np.random.default_rng(1)
    grid = [([1, 1, 1, 2], 5, 8, {}), ([2, 1, 1, 1], 32, 8, {}),
            ([2, 1, 1, 1], 172, 64, {}), ([2, 1, 1, 1], 1024, 8, {}),
            ([1.1, 1.0], 64, 8, {}), ([3.0, 1.0], 64, 8, {}),
            ([1, 1, 1, 2], 5, 8, {"min_blocks": 2}),
            ([0.0, 1.0], 8, 8, {}), ([1.0, float("nan")], 8, 8, {}),
            ([], 8, 8, {}), ([1, 1, 1], 2, 8, {})]
    for _ in range(80):
        tp = int(rng.integers(1, 7))
        chis = rng.choice([1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 7.3], tp)
        total = int(rng.integers(tp, 300))
        kw = {"chi_quantum": float(rng.choice([0.25, 0.5, 1.0]))}
        grid.append((list(chis), total, 8, kw))
    for chis, total, block, kw in grid:
        a = _outcome(tgeom.geometry_from_chi, chis, total, block, **kw)
        b = _outcome(jgeom.geometry_from_chi, chis, total, block, **kw)
        _same_geo(a, b)
        if a[0] == "ok":
            assert sum(a[1].sizes) == total
            assert min(a[1].sizes) >= kw.get("min_blocks", 1)
    # the reference's clamp gives the slowest rank the MOST blocks here;
    # the port keeps the reference's result (no monotonicity asserted)
    assert tgeom.geometry_from_chi([1, 1, 1, 2], 5, 8).sizes == (1, 1, 1, 2)


def test_cfg_plumbing_matches_reference():
    from repro.config import get_config as jget_config
    from repro.config import smoke_variant as jsmoke
    for arch in ("yi-6b", "vit-1b", "deepseek-v2-lite-16b",
                 "falcon-mamba-7b"):
        tc, jc = smoke_variant(get_config(arch)), jsmoke(jget_config(arch))
        assert tgeom.geometry_unsupported_reason(tc) \
            == jgeom.geometry_unsupported_reason(jc)
        nb = max(tc.d_ff // 8, 4)
        for sizes in ((nb // 2, nb - nb // 2), (nb // 4,) * 4,
                      (nb // 2 + 1, nb - nb // 2 - 1), (3, 1)):
            a = _outcome(tgeom.geometry_for_cfg, tc, sizes, 8)
            b = _outcome(jgeom.geometry_for_cfg, jc, sizes, 8)
            _same_geo(a, b)
            if a[0] != "ok":
                continue
            ca = _outcome(tgeom.apply_geometry_cfg, tc, a[1])
            cb = _outcome(jgeom.apply_geometry_cfg, jc, b[1])
            assert ca[0] == cb[0]
            if ca[0] == "ok":
                assert ca[1].d_ff == cb[1].d_ff
                assert (ca[1] is tc) == (cb[1] is jc)
            else:
                assert ca[1] == cb[1]


def test_cli_and_helpers_match_reference():
    from repro.core.hetero import HeteroSchedule as JSchedule
    from repro_torch.core.hetero import HeteroSchedule as TSchedule
    for spec, tp in (("none", 2), ("", 4), ("OFF", 1), (None, 2),
                     ("12,12,4,4", 4), (" 40,24 ", 2), ("3,1", 4),
                     ("a,b", 2), ("5", 1)):
        assert _outcome(tgeom.parse_geometry_arg, spec, tp) \
            == _outcome(jgeom.parse_geometry_arg, spec, tp)
    for kind, chis, step in (("static", (2.0,), 0), ("round_robin", (4.0,),
                                                       3)):
        kw = dict(num_ranks=4, kind=kind, chis=chis, period=2, seed=0)
        _same_geo(_outcome(tgeom.geometry_from_schedule, TSchedule(**kw),
                           64, 8, step=step),
                  _outcome(jgeom.geometry_from_schedule, JSchedule(**kw),
                           64, 8, step=step))
    for w, b in ((512, 8), (11008, 64), (100, 8)):
        assert _outcome(tgeom.blocks_for_width, w, b) \
            == _outcome(jgeom.blocks_for_width, w, b)
    g = (9, 19, 18, 18)
    for tp in (4, 2):
        assert _outcome(tgeom.validate_even_padding,
                        tgeom.ShardGeometry(g, 8), tp) \
            == _outcome(jgeom.validate_even_padding,
                        jgeom.ShardGeometry(g, 8), tp)
    assert ragged_local_width(608, TPGroup(4)) == 152
    with pytest.raises(ValueError, match="does not equal-split"):
        ragged_local_width(610, TPGroup(4))


def _trees():
    """Yi-6B and ViT smoke parameter trees in the JAX layout (numpy), with
    a geometry of three size classes each."""
    yi = smoke_variant(get_config("yi-6b"))              # d_ff 512
    vit = smoke_variant(get_config("vit-1b"))            # d_ff 512
    g = torch.Generator().manual_seed(0)
    return [("yi", yi, tlm.init(g, yi, torch.float32, "cpu"),
             bridge.params_to_numpy, (20, 12, 16, 16)),
            ("vit", vit, tvit.init(g, vit, torch.float32, "cpu"),
             bridge.vit_params_to_numpy, (9, 19, 18, 18))]


def _leaves(t, p=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, f"{p}/{k}")
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _leaves(v, f"{p}/{i}")
    else:
        yield p, np.asarray(t)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].shape == lb[k].shape and np.array_equal(la[k], lb[k]), k


@pytest.mark.parametrize("which", [0, 1], ids=["yi", "vit"])
def test_param_transforms_match_reference(which):
    name, cfg, model, to_np, sizes = _trees()[which]
    tg, jg = tgeom.ShardGeometry(sizes, 8), jgeom.ShardGeometry(sizes, 8)
    canon = to_np(model)
    padded = tgeom.expand_ffn_params(canon, tg)
    _assert_trees_equal(padded, jgeom.expand_ffn_params(canon, jg))
    _assert_trees_equal(tgeom.restrict_ffn_params(padded, tg), canon)
    _assert_trees_equal(jgeom.restrict_ffn_params(padded, jg), canon)
    # the padding is zero, each rank's real blocks first in its slice
    w = padded["stack"]["scan"][0]["ffn"]["w_up"]
    blocks = w.reshape(w.shape[:-1] + (tg.padded_blocks, 8))
    for r, L in enumerate(sizes):
        lo = r * tg.max_blocks
        assert not blocks[..., lo + L:lo + tg.max_blocks, :].any()
    # the bridge's torch transform gives the same arrays
    bridge.expand_ffn_modules(model, tg)
    _assert_trees_equal(to_np(model), padded)
    # an equal geometry changes nothing; a tree without the width raises
    eq = tgeom.ShardGeometry((16,) * 4, 8)
    assert tgeom.expand_ffn_params(canon, eq) is canon
    for geo_lib, G in ((tgeom, tg), (jgeom, jg)):
        with pytest.raises(ValueError, match="no FFN pair"):
            geo_lib.expand_ffn_params({"w_up": np.zeros((4, 8))}, G)


# ---------------------------------------------------------------------------
# the control plane's geometry mode against the reference's
# ---------------------------------------------------------------------------


def _planes(arch, tp, geometry, *, pad=True, sim_ranks=0, mode="semi",
            block=8, chi=(2.0, 1.0, 1.0, 1.0)):
    """(port outcome, reference outcome) of building each package's
    ControlPlane for ``arch``'s smoke config under ``geometry``."""
    from repro.config import get_config as jget_config
    from repro.config import smoke_variant as jsmoke
    from repro.control import ControlConfig as JControlConfig
    from repro.control.plane import ControlPlane as JPlane
    from repro.core.hetero import iteration_model as jit_model
    from repro.config import ShapeConfig as JShape
    from repro_torch.config import ShapeConfig
    from repro_torch.control import ControlConfig, ControlPlane
    from repro_torch.core.hetero import iteration_model

    out = []
    for pkg in ("port", "ref"):
        if pkg == "port":
            cfg = smoke_variant(get_config(arch))
            geo_lib, cc, plane_cls = tgeom, ControlConfig, ControlPlane
            itm = iteration_model(cfg, ShapeConfig("t", 8, 4, "decode"),
                                  tp, peak_flops=5e9, mfu=1.0)
            kw = {"device": "cpu"}
        else:
            cfg = jsmoke(jget_config(arch))
            geo_lib, cc, plane_cls = jgeom, JControlConfig, JPlane
            itm = jit_model(cfg, JShape("t", 8, 4, "decode"), tp,
                            peak_flops=5e9, mfu=1.0)
            kw = {"mesh": None}
        if pad and geometry and len(set(geometry)) > 1 \
                and geo_lib.geometry_unsupported_reason(cfg) is None:
            cfg = dataclasses.replace(
                cfg, d_ff=tp * max(geometry) * block)
        wc = cc(mode=mode, block_size=block,
                hetero_kind="static").to_workload()
        out.append(_outcome(
            plane_cls, cfg, wc, tp=tp, builder=lambda st: (None, 1, None),
            it_model=itm, sim_ranks=sim_ranks, controller_blocks="local",
            clamp_sheds=True, hetero_kind="static", chi=chi[0],
            geometry=geometry, **kw))
    return out


@pytest.mark.parametrize("case", [
    dict(arch="yi-6b", tp=4, geometry=(20, 12, 16)),
    dict(arch="yi-6b", tp=4, geometry=(20, 12, 16, 16), sim_ranks=8),
    dict(arch="yi-6b", tp=4, geometry=(20, 12, 16, 16), pad=False),
    dict(arch="falcon-mamba-7b", tp=2, geometry=(3, 1)),
], ids=["rank_count", "sim_ranks", "unpadded_cfg", "exempt_scope"])
def test_plane_geometry_validations_raise_as_reference(case):
    port, ref = _planes(**case)
    assert port[0] == ref[0] == "ValueError", (port, ref)
    assert port[1] == ref[1]


def test_plane_geometry_mode_matches_reference():
    geo = (20, 12, 16, 16)
    (tp_ok, port), (rf_ok, ref) = _planes("yi-6b", 4, geo)
    assert tp_ok == rf_ok == "ok"
    assert port.geometry == ref.geometry == geo
    assert port.static.signature_str() == ref.static.signature_str()
    np.testing.assert_array_equal(port.controller.workloads,
                                  ref.controller.workloads)
    for k in ref.identity_pri:
        np.testing.assert_array_equal(port.identity_pri[k].numpy(),
                                      np.asarray(ref.identity_pri[k]))
    for chis in ([2.0, 1.0, 1.0, 1.0], [4.0, 1.0, 1.0, 1.0],
                 [1.0, 3.0, 1.0, 1.5]):
        t_port = port.controller_times(np.asarray(chis))
        t_ref = ref.controller_times(np.asarray(chis))
        np.testing.assert_array_equal(t_port, t_ref)
        pp, rp_ = port.decide(t_port), ref.decide(t_ref)
        assert pp[0].static.signature_str() == rp_[0].static.signature_str()
        _, arrays, proj = port.dispatch(pp[0])
        _, rarrays, rproj = ref.dispatch(rp_[0])
        assert (proj.mig_srcs, proj.mig_sheds, proj.folded) \
            == (rproj.mig_srcs, rproj.mig_sheds, rproj.folded)
        np.testing.assert_array_equal(proj.bucket_by_rank,
                                      rproj.bucket_by_rank)
        np.testing.assert_array_equal(arrays["mig_src"],
                                      np.asarray(rarrays["mig_src"]))
        np.testing.assert_array_equal(arrays["bucket_by_rank"].numpy(),
                                      np.asarray(rarrays["bucket_by_rank"]))
        assert all(m < min(geo) for m in proj.mig_sheds)
    # an all-equal geometry normalizes away
    (ok, eq), _ = _planes("yi-6b", 4, (16, 16, 16, 16))
    assert ok == "ok" and eq.geometry == () and eq.static.geometry == ()


# ---------------------------------------------------------------------------
# the ragged controlled_ffn against the reference's
# ---------------------------------------------------------------------------

BUCKETS = (0.0, 0.25, 0.5)
# name -> (sizes, gated, {plan: (sheds, bucket by rank, sources)}); the
# migrating plans resize other ranks too, and are the gradient plans
CASES = {
    "gated_3classes": ((2, 6, 4, 4), True, {
        "neutral": ((), [0, 0, 0, 0], []),
        "migrate": ((1, 1), [0, 1, 0, 2], [0, 2])}),
    "ungated_2classes": ((6, 3, 6, 3), False, {
        "neutral": ((), [0, 0, 0, 0], []),
        "migrate": ((2,), [1, 2, 2, 0], [3])}),
}

REFERENCE = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.control.scopes import per_rank_pri
from repro.core import geometry as geom
from repro.core.workload import PlanStatic
from repro.layers.tp_linear import ControlContext, controlled_ffn

out, cases, buckets = sys.argv[1], json.loads(sys.argv[2]), tuple(
    json.loads(sys.argv[3]))
e, B, S, d, block = 4, 2, 5, 16, 8
mesh = Mesh(np.array(jax.devices()[:e]).reshape(1, e), ("data", "model"))
res = {}
for ci, (name, (sizes, gated, plans)) in enumerate(sorted(cases.items())):
    geo = geom.ShardGeometry(sizes=tuple(sizes), block=block)
    H, nb = geo.width, geo.max_blocks
    rng = np.random.default_rng(ci)
    a = {"x": rng.standard_normal((B, S, d)),
         "wu": rng.standard_normal((d, H)) * d ** -0.5,
         "wg": rng.standard_normal((d, H)) * d ** -0.5,
         "wd": rng.standard_normal((H, d)) * H ** -0.5}
    a = {k: v.astype(np.float32) for k, v in a.items()}
    if not gated:
        del a["wg"]
    pp = geom.expand_ffn_params(
        {"w_up": a["wu"], "w_down": a["wd"],
         **({"w_gate": a["wg"]} if gated else {})}, geo)
    act = jax.nn.silu if gated else jax.nn.gelu
    pri = jnp.asarray(per_rank_pri(np.arange(geo.total_blocks), e, nb,
                                   geometry=geo.sizes))
    wup, wdp = jnp.asarray(pp["w_up"]), jnp.asarray(pp["w_down"])
    wgp = jnp.asarray(pp["w_gate"]) if gated else None
    x = jnp.asarray(a["x"])
    for k, v in a.items():
        res[f"{name}/{k}"] = v
    for plan, (sheds, bvec, srcs) in plans.items():
        st = PlanStatic(buckets=buckets, block_size=block, tp_size=e,
                        mig_shed=tuple(sheds), geometry=geo.sizes)
        ctx = ControlContext(mesh=mesh, axis="model", static=st,
            bucket_by_rank=jnp.asarray(bvec, jnp.int32),
            mig_src=jnp.asarray(srcs if srcs else -1, jnp.int32),
            pri={"ffn": pri})

        def f(wu_, wd_, wg_, ctx=ctx):
            return controlled_ffn(x, wu_, wd_, ctx, "ffn", act, w_gate=wg_)
        y = jax.jit(f)(wup, wdp, wgp)
        res[f"{name}/{plan}/y"] = np.asarray(y)
        if plan == "migrate":
            grads = jax.jit(jax.grad(lambda *w: jnp.sum(f(*w) ** 2),
                                     (0, 1, 2) if gated else (0, 1)))(
                wup, wdp, wgp)
            tree = {"w_up": np.asarray(grads[0]),
                    "w_down": np.asarray(grads[1])}
            if gated:
                tree["w_gate"] = np.asarray(grads[2])
            for k, v in tree.items():
                res[f"{name}/{plan}/padded_d{k}"] = v
            for k, v in geom.restrict_ffn_params(tree, geo).items():
                res[f"{name}/{plan}/d{k}"] = v
np.savez(out + "/ffn.npz", **res)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_geometry_ffn"))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), out,
         json.dumps(CASES), json.dumps(BUCKETS)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(os.path.join(out, "ffn.npz")) as z:
        return dict(z)


def _port_ffn(ref, name, plan, use_kernel, grad=False):
    sizes, gated, plans = CASES[name]
    sheds, bvec, srcs = plans[plan]
    geo = tgeom.ShardGeometry(sizes, 8)
    canon = {"w_up": ref[f"{name}/wu"], "w_down": ref[f"{name}/wd"]}
    if gated:
        canon["w_gate"] = ref[f"{name}/wg"]
    pp = {k: torch.from_numpy(v).requires_grad_(grad)
          for k, v in tgeom.expand_ffn_params(canon, geo).items()}
    from repro_torch.control.scopes import per_rank_pri
    pri = torch.from_numpy(per_rank_pri(np.arange(geo.total_blocks), 4,
                                        geo.max_blocks, geometry=sizes))
    st = PlanStatic(buckets=BUCKETS, block_size=8, tp_size=4,
                    mig_shed=tuple(sheds), geometry=sizes)
    ctx = ControlContext(static=st, bucket_by_rank=bvec, pri={"ffn": pri},
                         use_kernel=use_kernel, mig_src=srcs)
    act = tops.silu if gated else tops.gelu
    y = controlled_ffn(torch.from_numpy(ref[f"{name}/x"]), pp["w_up"],
                       pp["w_down"], ctx, "ffn", act,
                       w_gate=pp.get("w_gate"))
    return y, pp, geo


def _rel(got, ref):
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_controlled_ffn_matches_jax(reference, name, use_kernel):
    for plan in CASES[name][2]:
        y, _, _ = _port_ffn(reference, name, plan, use_kernel)
        rel = _rel(y.detach().numpy(), reference[f"{name}/{plan}/y"])
        assert rel <= FWD_REL, (plan, rel)
    # gradients of the migrating plan, restricted to canonical space
    y, pp, geo = _port_ffn(reference, name, "migrate", use_kernel, grad=True)
    (y ** 2).sum().backward()
    tree = {k: v.grad.numpy() for k, v in pp.items()}
    canon = tgeom.restrict_ffn_params(tree, geo)
    pad = np.ones(geo.padded_blocks, bool)
    for r, L in enumerate(geo.sizes):
        pad[r * geo.max_blocks:r * geo.max_blocks + L] = False
    pad = np.repeat(pad, geo.block)
    for k, g in canon.items():
        rel = _rel(g, reference[f"{name}/migrate/d{k}"])
        assert rel <= GRAD_REL, (k, rel)
        # the padded lanes' gradients are exactly 0 in both packages
        for t in (tree[k], reference[f"{name}/migrate/padded_d{k}"]):
            lanes = t[pad] if k == "w_down" else t[:, pad]
            assert not lanes.any(), k


def test_ragged_ffn_checks_raise():
    sizes = (2, 6, 4, 4)
    geo = tgeom.ShardGeometry(sizes, 8)
    x = torch.zeros(3, 16)
    wu = torch.zeros(16, geo.padded_width)
    wd = torch.zeros(geo.padded_width, 16)
    pri = torch.zeros(4, geo.max_blocks, dtype=torch.int32)
    for geometry, sheds, srcs, match in (
            ((2, 5, 4, 4), (), [], "must equal the padded local"),
            (sizes, (2,), [0], "smallest-geometry")):
        st = PlanStatic(buckets=BUCKETS, block_size=8, tp_size=4,
                        mig_shed=sheds, geometry=geometry)
        ctx = ControlContext(static=st, bucket_by_rank=[0] * 4,
                             pri={"ffn": pri}, mig_src=srcs)
        with pytest.raises(ValueError, match=match):
            controlled_ffn(x, wu, wd, ctx, "ffn", tops.gelu)



def test_train_cli_geometry_on_cpu(tmp_path):
    # two threads, as this test process takes: other test files may run
    # beside it
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    out = tmp_path / "hist.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "2", "--tp", "4", "--control", "semi", "--hetero",
         "static", "--chi", "2", "--mig-blocks", "2", "--geometry", "chi",
         "--use-kernel", "--out", str(out)], capture_output=True, text=True,
        env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    hist = json.loads(out.read_text())
    assert hist["geometry"] == [9, 19, 18, 18]
    assert np.isfinite(hist["loss"]).all()
    assert hist["signatures"] == ["tp4b8shed[]geo[9,19,18,18]"] * 2


def test_equal_geometry_ffn_is_the_geometry_free_ffn():
    """geometry=(L,)*4 runs the geometry-free path: outputs and gradients
    bit-identical (as the reference's TestEqualGeometryBitMatch)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32))
          for s in ((16, 256), (256, 16), (16, 256))]
    pri = torch.from_numpy(np.stack([rng.permutation(8) for _ in range(4)])
                           .astype(np.int32))
    outs = []
    for geometry in ((8, 8, 8, 8), ()):
        st = PlanStatic(buckets=BUCKETS, block_size=8, tp_size=4,
                        mig_shed=(2,), geometry=geometry)
        ctx = ControlContext(static=st, bucket_by_rank=[0, 2, 0, 1],
                             pri={"ffn": pri}, mig_src=[1])
        w = [t.clone().requires_grad_(True) for t in ws]
        y = controlled_ffn(x, w[0], w[1], ctx, "ffn", tops.silu, w_gate=w[2])
        (y ** 2).sum().backward()
        outs.append([y.detach()] + [t.grad for t in w])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
