"""The port's ServeEngine at tp > 1 under the migration modes, against the
JAX package's, on the CPU.

One subprocess (four host devices, the ``run_py`` pattern of
``tests/test_multi_straggler.py``) runs every reference engine: the
scenario of ``tests/test_serve_engine.py``'s serve SEMI e2e (Yi-6B
smoke, tp 4, SEMI under contention χ 4, p 0.2, ``sim_ranks`` 4,
``max_sources`` 3, seed 3), the same with 8 simulated ranks folded onto
the 4 real ones, ZERO-resizing at tp 2, and DeepSeek-V2-Lite smoke (MLA +
MoE) at tp 2 under SEMI. It saves each model's parameters with the
reference's checkpoint store; the port's engines load them through
``ckpt_dir`` (the warm load), so both packages serve the same weights.
The same subprocess runs two layers alone on inputs drawn with numpy: an
FFN layer wider than its scope's priority lists (DeepSeek-V2's dense
first layer beside its shared experts) at tp 1 under ZERO and at tp 2
under migration, and Mixtral's TP-local experts at tp 2.

What must hold, exactly (f32 on both sides; the partial sums are added
in rank order):

* greedy tokens per request, and per step the EXECUTED migration
  (``mig_srcs`` / ``mig_shed``), the controller's intent
  (``planned_mig_srcs``), ``max_bucket`` and ``stragglers``, identical to
  the JAX engine's;
* under SEMI with the lossless β-policy (tp 4 over 4 simulated ranks;
  DeepSeek at tp 2): at least one step migrates, no step resizes, and
  the tokens equal the port's uncontended tp-1 dense run;
* ``psum_chunks`` 2 and the paged pool (page 8) give the slot-cache,
  one-sum tokens; the kernel switches give the same tokens (their plain
  versions run here);
* at tp 1 with 8 simulated ranks the controller plans migration and the
  engine executes none;
* ``trace_counts()`` has the reference's keys but its jit trace-cache
  size (an eager step is never traced), and the new analysis case
  (``serve_decode_step/controlled_tp4_semi``) passes R1-R5;
* the two layers alone agree with the reference's within 1e-5·max|ref|
  (f32).
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

from repro_torch.config import get_config, smoke_variant
from repro_torch.control import ControlConfig
from repro_torch.core.workload import PlanStatic
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.layers.tp_linear import ControlContext, controlled_ffn

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEMI = dict(mode="semi", hetero_kind="contention", chi=4.0,
            contention_p=0.2, sim_ranks=4, max_sources=3, seed=3)
SPECS = [(5, 6, 0), (5, 6, 2), (5, 6, 4)]
DS_SPECS = [(4, 5, 0), (6, 4, 1), (3, 5, 3)]
# name -> (arch, tp, control, request specs); LOSSLESS names the runs
# whose plans migrate and never resize (8 simulated ranks folded onto 4
# real ones keep one real helper, so the folded plan resizes too)
RUNS = {
    "semi_tp4": ("yi-6b", 4, SEMI, SPECS),
    "semi_fold8_tp4": ("yi-6b", 4, dict(SEMI, sim_ranks=8), SPECS),
    "zero_tp2": ("yi-6b", 2, dict(mode="zero", hetero_kind="contention",
                                  chi=4.0, contention_p=0.2, sim_ranks=8,
                                  seed=3), SPECS),
    "ds_semi_tp2": ("deepseek-v2-lite-16b", 2,
                    dict(SEMI, sim_ranks=2, max_sources=1), DS_SPECS),
}
LOSSLESS = ("semi_tp4", "ds_semi_tp2")
HIST_KEYS = ("mig_srcs", "mig_shed", "planned_mig_srcs", "max_bucket",
             "stragglers")
# an FFN layer of 12 blocks a rank under a 4-block "ffn" list:
# name -> (tp, bucket by rank, sheds, sources)
WIDE = {"zero_tp1": (1, [3], [], []),
        "mig_tp2": (2, [0, 0], [2], [0]),
        "mig_tp2_resized": (2, [2, 1], [2], [1])}

REFERENCE = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.checkpoint import store
from repro.control import ControlConfig
from repro.launch.serve import Request, ServeEngine

out, runs, keys = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
wide = json.loads(sys.argv[4])

def mk(vocab, specs):
    rng = np.random.default_rng(0)
    return [Request(uid=i,
                    prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                    max_new_tokens=g, arrival_step=a)
            for i, (p, g, a) in enumerate(specs)]

res, saved = {}, set()
for name, (arch, tp, ctl, specs) in runs.items():
    eng = ServeEngine(arch, num_slots=2, max_len=16, seed=0, tp=tp,
                      control=ControlConfig(**ctl))
    comps = eng.run(mk(eng.cfg.vocab_size, specs))
    eng.close()
    res[name] = {
        "tokens": {str(c.uid): c.tokens.tolist() for c in comps},
        "history": [[h.get(k) for k in keys] for h in eng.history],
        "trace_counts": sorted(eng.trace_counts())}
    if arch not in saved:
        store.save(out + "/" + arch, 0, jax.tree.map(np.asarray, eng.params))
        saved.add(arch)
with open(out + "/serve.json", "w") as f:
    json.dump(res, f)

# the two layers alone, on inputs drawn with numpy
from repro import sharding as jsh
from repro.config import get_config, smoke_variant
from repro.core.workload import PlanStatic
from repro.launch import steps as steps_lib
from repro.launch.mesh import make_small_mesh
from repro.layers import moe as jmoe
from repro.layers import tp_linear as jtp
rng = np.random.default_rng(11)
d, blk, nl = 32, 8, 4
layers = {}
for name, (tp, buckets, sheds, srcs) in wide.items():
    H = tp * 3 * nl * blk
    a = {"x": rng.standard_normal((3, d)),
         "wu": rng.standard_normal((d, H)) * d ** -0.5,
         "wg": rng.standard_normal((d, H)) * d ** -0.5,
         "wd": rng.standard_normal((H, d)) * H ** -0.5}
    a = {k: v.astype(np.float32) for k, v in a.items()}
    a["pri"] = np.stack([rng.permutation(nl) for _ in range(tp)]).astype(
        np.int32)
    mesh = make_small_mesh(1, tp)
    ctx = steps_lib.make_ctx(
        mesh, PlanStatic(block_size=blk, tp_size=tp, mig_shed=tuple(sheds)),
        {"bucket_by_rank": jnp.asarray(buckets, jnp.int32),
         "mig_src": jnp.asarray(srcs if srcs else -1, jnp.int32),
         "pri": {"ffn": jnp.asarray(a["pri"])}})
    with jsh.use_mesh(mesh):
        a["y"] = np.asarray(jax.jit(
            lambda x, wu, wd, wg: jtp.controlled_ffn(
                x, wu, wd, ctx, "ffn", jax.nn.silu, w_gate=wg))(
            *(jnp.asarray(a[k]) for k in ("x", "wu", "wd", "wg"))))
    layers.update({name + "/" + k: v for k, v in a.items()})
mo = smoke_variant(get_config("mixtral-8x7b"))
E, f, dm = mo.moe.num_experts, mo.moe.d_expert, mo.d_model
a = {"x": rng.standard_normal((2, 5, dm)),
     "router": rng.standard_normal((dm, E)),
     "w_up": rng.standard_normal((E, dm, f)) * dm ** -0.5,
     "w_gate": rng.standard_normal((E, dm, f)) * dm ** -0.5,
     "w_down": rng.standard_normal((E, f, dm)) * f ** -0.5}
a = {k: v.astype(np.float32) for k, v in a.items()}
mesh = make_small_mesh(1, 2)
with jsh.use_mesh(mesh):
    y, _ = jax.jit(lambda x, p: jmoe.moe_ffn(
        x, p, mo.moe, jax.nn.silu, mesh=mesh,
        expert_sharding=mo.moe.expert_sharding))(
        jnp.asarray(a["x"]),
        {k: jnp.asarray(v) for k, v in a.items() if k != "x"})
a["y"] = np.asarray(y)
layers.update({"moe_tp2/" + k: v for k, v in a.items()})
np.savez(out + "/layers.npz", **layers)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_serve_tp"))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), out,
         json.dumps(RUNS), json.dumps(HIST_KEYS), json.dumps(WIDE)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(out, "serve.json")) as f:
        res = json.load(f)
    with np.load(os.path.join(out, "layers.npz")) as z:
        res["layers"] = dict(z)
    res["ckpt"] = {arch: os.path.join(out, arch)
                   for arch in ("yi-6b", "deepseek-v2-lite-16b")}
    return res


def _requests(vocab, specs):
    rng = np.random.default_rng(0)
    return [Request(uid=i,
                    prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                    max_new_tokens=g, arrival_step=a)
            for i, (p, g, a) in enumerate(specs)]


def _serve(arch, tp, control, specs, ckpt_dir=None, **kw):
    eng = ServeEngine(arch, num_slots=2, max_len=16, seed=0, tp=tp,
                      control=ControlConfig(**control) if control else None,
                      ckpt_dir=ckpt_dir, device="cpu", **kw)
    comps = eng.run(_requests(eng.cfg.vocab_size, specs))
    eng.close()
    return eng, {str(c.uid): c.tokens.tolist() for c in comps}


def _history(eng):
    return [[h.get(k) for k in HIST_KEYS] for h in eng.history]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_engine_matches_jax(reference, name):
    arch, tp, ctl, specs = RUNS[name]
    eng, tokens = _serve(arch, tp, ctl, specs,
                         ckpt_dir=reference["ckpt"][arch])
    ref = reference[name]
    assert tokens == ref["tokens"]
    # JSON turns the reference's tuples into lists
    assert json.loads(json.dumps(_history(eng))) == ref["history"]
    assert sorted(eng.trace_counts()) == [
        k for k in ref["trace_counts"] if k != "base_step_traces"]
    if name in LOSSLESS:
        assert any(h.get("mig_srcs") for h in eng.history), \
            "no step migrated — the scenario lost its point"
        assert not any(h.get("max_bucket", 0) > 0 for h in eng.history), \
            "a step resized — the semi plan was not lossless"
        # lossless: the uncontended dense tp-1 run's tokens
        _, dense = _serve(arch, 1, None, specs,
                          ckpt_dir=reference["ckpt"][arch])
        assert tokens == dense
    if ctl["mode"] == "zero":
        assert any(h.get("max_bucket", 0) > 0 for h in eng.history)


@pytest.mark.parametrize("variant", [
    dict(control=dict(SEMI, psum_chunks=2)),
    dict(page_size=8),
    dict(control=dict(SEMI, use_kernel=True, fused_attention=True)),
    dict(control=dict(SEMI, mode="mig")),
], ids=["psum_chunks2", "paged8", "kernel_switches", "mig_mode"])
def test_semi_tp4_variants_keep_the_tokens(reference, variant):
    """What does not change a lossless SEMI plan's value keeps its tokens:
    a chunked psum, the paged pool, the kernel wrappers' paths, the
    migration-only mode."""
    ckpt = reference["ckpt"]["yi-6b"]
    _, base = _serve("yi-6b", 4, SEMI, SPECS, ckpt_dir=ckpt)
    ctl = variant.get("control", SEMI)
    kw = {k: v for k, v in variant.items() if k != "control"}
    eng, tokens = _serve("yi-6b", 4, ctl, SPECS, ckpt_dir=ckpt, **kw)
    assert tokens == base
    assert any(h.get("mig_srcs") for h in eng.history)


def test_semi_tp1_plans_migration_and_executes_none():
    """One rank has no helper: the projection folds the sim-scale
    migration plan away and the engine completes every request
    (``tests/test_serve_engine.py``'s tp-1 case)."""
    ctl = dict(mode="semi", hetero_kind="contention", chi=4.0,
               contention_p=0.15, sim_ranks=8, seed=3)
    eng = ServeEngine("yi-6b", num_slots=2, max_len=12, seed=0, device="cpu",
                      control=ControlConfig(**ctl))
    comps = eng.run(_requests(eng.cfg.vocab_size, [(4, 4, 0), (4, 4, 2)]))
    assert len(comps) == 2
    assert any(h.get("planned_mig_srcs") for h in eng.history)
    assert not any(h.get("mig_srcs") for h in eng.history)
    assert eng.trace_counts()["plan_compiles"] == 1


def test_warm_load_serves_the_saved_params(tmp_path):
    """``ckpt_dir``: a port engine serves what another port engine saved
    (params only, through the port's store), cast to bf16; an empty
    directory keeps the seed's weights."""
    from repro_torch import bridge
    from repro_torch.checkpoint import store
    src = ServeEngine("yi-6b", num_slots=2, max_len=16, seed=5,
                      device="cpu")
    _, want = _serve("yi-6b", 1, None, SPECS)      # seed 0's weights
    store.save(str(tmp_path / "ck"), 3, bridge.params_to_numpy(src.params))
    src_tokens = {str(c.uid): c.tokens.tolist()
                  for c in src.run(_requests(src.cfg.vocab_size, SPECS))}
    _, got = _serve("yi-6b", 1, None, SPECS, ckpt_dir=str(tmp_path / "ck"))
    assert got == src_tokens != want
    _, empty = _serve("yi-6b", 1, None, SPECS,
                      ckpt_dir=str(tmp_path / "none"))
    assert empty == want
    eng = ServeEngine("yi-6b", num_slots=2, max_len=16, device="cpu",
                      param_dtype="bfloat16", ckpt_dir=str(tmp_path / "ck"))
    assert eng.params.embed.dtype == torch.bfloat16
    torch.testing.assert_close(eng.params.embed.float(),
                               src.params.embed.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


def test_serve_cli_tp4_semi(capsys, tmp_path):
    from repro_torch.launch import serve as tserve
    tserve.main(["--device", "cpu", "--tp", "4", "--control", "semi",
                 "--hetero", "contention", "--sim-ranks", "8",
                 "--max-sources", "3", "--beta-policy", "lossless",
                 "--psum-chunks", "2", "--requests", "2", "--prompt-len",
                 "3", "--gen-len", "4", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "2 requests, 8 tokens" in out
    assert "trace counts: {'plan_compiles'" in out


def test_tp4_semi_analysis_case_is_clean():
    """The analyzer's SEMI case at tp 4 (a migrating plan, one grouped
    broadcast per FFN layer) passes R1-R5 on the CPU."""
    from repro_torch.analysis import engine as an_engine
    from repro_torch.analysis.registry import CaseEnv
    violations, artifacts = an_engine.run_check(
        CaseEnv(device="cpu"), None, ["serve_decode_step"])
    labels = [a.case.label for a in artifacts]
    assert "serve_decode_step/controlled_tp4_semi" in labels, labels
    assert "serve_decode_step/controlled_tp1" in labels
    assert [str(v) for v in violations] == []


@pytest.mark.parametrize("name", sorted(WIDE))
def test_ffn_layer_wider_than_its_list_matches_jax(reference, name):
    """DeepSeek-V2's dense first layer shares the "ffn" scope with the
    shared experts, whose width sizes the scope's priority lists: at full
    width 171 blocks a rank against a 44-block list. The reference keeps
    the kept prefix's list ids of such a layer, and a source exports the
    list's ids from a start its dynamic slice clamps into the list. Here
    12 blocks a rank under a 4-block list, at tp 1 resized and at tp 2
    with a source: the port computes the reference's function."""
    tp, buckets, sheds, srcs = WIDE[name]
    a = {k: torch.from_numpy(v) for k, v in reference["layers"].items()
         if k.startswith(name + "/")}
    a = {k.split("/", 1)[1]: v for k, v in a.items()}
    ctx = ControlContext(
        static=PlanStatic(block_size=8, tp_size=tp, mig_shed=tuple(sheds)),
        bucket_by_rank=buckets, pri={"ffn": a["pri"]}, mig_src=srcs)
    silu = torch.nn.functional.silu
    got = controlled_ffn(a["x"], a["wu"], a["wd"], ctx, "ffn", silu,
                         w_gate=a["wg"]).numpy()
    ref = a["y"].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    dense = ((silu(a["x"] @ a["wg"]) * (a["x"] @ a["wu"])) @ a["wd"]).numpy()
    assert np.abs(ref - dense).max() > 1e-2 * np.abs(dense).max(), \
        "the plan left the layer dense — the case lost its point"


def test_moe_tp_local_matches_jax(reference):
    """Mixtral's experts (``expert_sharding="tp"``) at tp 2 run TP-local as
    the reference's ``_moe_tp_local``; DeepSeek-V2's (``"expert"``) keep
    the single-group function at any tp, bit for bit."""
    from repro_torch.layers import moe as tmoe
    from repro_torch.parallel import TPGroup
    a = {k.split("/", 1)[1]: torch.from_numpy(v)
         for k, v in reference["layers"].items() if k.startswith("moe_tp2/")}
    params = {k: a[k] for k in ("router", "w_up", "w_gate", "w_down")}
    silu = torch.nn.functional.silu
    mix = smoke_variant(get_config("mixtral-8x7b")).moe
    y, _ = tmoe.moe_ffn(a["x"], params, mix, silu, group=TPGroup(2))
    ref = a["y"].numpy()
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    ds = dataclasses.replace(mix, expert_sharding="expert")
    y2, _ = tmoe.moe_ffn(a["x"], params, ds, silu, group=TPGroup(2))
    y1, _ = tmoe.moe_ffn(a["x"], params, ds, silu)
    torch.testing.assert_close(y2, y1, rtol=0, atol=0)
