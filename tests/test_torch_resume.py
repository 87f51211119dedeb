"""The port's trainer checkpoint / resume (``run_training``'s ``ckpt_dir``,
``ckpt_every`` and ``resume``), on the CPU.

* Port alone: ViT smoke at tp 4 under SEMI (static χ 4 straggler,
  ``times="measured"``, the kernel wrappers on, whose plain versions run
  here). 8 steps uninterrupted against 4 steps, a "crash", and a fresh
  ``run_training(..., resume=True)`` up to 8: loss, ``signatures``,
  ``buckets``, ``mig_shed`` and the estimator's ``chi_hat`` are identical
  (``==``), as ``tests/test_system.py`` demands of the reference; so is
  every parameter after step 8. A legacy params-only checkpoint resumes
  with a fresh optimizer; state the resumed run cannot host warns. The
  CLI takes ``--ckpt-dir``, ``--ckpt-every`` and ``--resume``.
* Across packages, in one 4-device JAX subprocess: the reference trainer
  runs the same configuration for 8 steps and checkpoints at step 4; the
  port resumes from that step-4 checkpoint and its steps 5-8 match the
  JAX run (``signatures``, ``buckets``, ``mig_shed`` identical; loss rtol
  1e-3, PERF.md's bound). The reference's ``store.restore`` loads the
  port's step-4 checkpoint into the reference's own parameter and
  ``AdamWState`` trees.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.launch.train import run_training

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(tp=4, control_mode="semi", hetero_kind="static", chi=4.0,
           mig_blocks=2, times="measured", batch=8, seed=0)
STEPS, CUT = 8, 4
LOSS_RTOL = 1e-3
KEYS = ("loss", "signatures", "buckets", "mig_shed")

REFERENCE = r"""
import json, sys
from repro.launch.train import run_training
out, run, steps, cut = sys.argv[1], json.loads(sys.argv[2]), \
    int(sys.argv[3]), int(sys.argv[4])
h = run_training("vit-1b", steps=steps, quiet=True, ckpt_dir=out + "/ck",
                 ckpt_every=cut, **run)
with open(out + "/hist.json", "w") as f:
    json.dump({k: h[k] for k in ("loss", "signatures", "buckets",
                                 "mig_shed", "chi_hat")}, f)
"""


def _train(steps, **kw):
    return run_training("vit-1b", steps=steps, quiet=True, device="cpu",
                        **{**RUN, **kw})


def test_resume_is_bit_identical(tmp_path):
    d = str(tmp_path / "ck")
    full = _train(STEPS, use_kernel=True, ckpt_dir=str(tmp_path / "full"))
    first = _train(CUT, use_kernel=True, ckpt_dir=d)
    assert store.latest_step(d) == CUT
    resumed = _train(STEPS, use_kernel=True, ckpt_dir=d, resume=True)
    assert len(resumed["loss"]) == STEPS - CUT
    for k in KEYS:
        assert first[k] + resumed[k] == full[k], k
    assert resumed["chi_hat"] == full["chi_hat"]
    # the run is one that resizes and migrates
    assert any(max(b) > 0 for b in full["buckets"])
    assert any(srcs for srcs, _ in full["mig_shed"])
    # every parameter and moment after the last step: the two runs' final
    # checkpoints hold the same bits
    a = store.load_arrays(str(tmp_path / "full"), STEPS)
    b = store.load_arrays(d, STEPS)

    def flat(t, p=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flat(v, f"{p}/{k}")
        else:
            yield p, t
    fa, fb = dict(flat(a)), dict(flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and \
            fa[k].tobytes() == fb[k].tobytes(), k
    man = store.read_manifest(d, STEPS)["extra"]
    assert man["layout"] == store.TRAIN_STATE_LAYOUT
    assert (man["train_step"], man["data_batches"], man["tp"]) == \
        (STEPS, STEPS, 4)


def test_mid_run_checkpoints_follow_ckpt_every(tmp_path):
    d = str(tmp_path / "ck")
    _train(5, ckpt_dir=d, ckpt_every=2)
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [
        "ckpt_00000002.npz", "ckpt_00000004.npz", "ckpt_00000005.npz"]


def test_legacy_params_only_checkpoint_resumes(tmp_path):
    """A params-only checkpoint (no layout tag): the params load, the
    optimizer starts fresh, the run continues from that step."""
    d = str(tmp_path / "ck")
    _train(3, ckpt_dir=d)
    params = store.load_arrays(d, 3, prefix="params")
    store.save(d, 3, params)
    assert "layout" not in store.read_manifest(d, 3)["extra"]
    h = _train(5, ckpt_dir=d, resume=True)
    assert len(h["loss"]) == 2
    assert np.isfinite(h["loss"]).all()


def test_state_the_run_cannot_host_warns(tmp_path):
    """A measured-mode checkpoint resumed without ``times="measured"``
    carries estimator state the run cannot host: it warns, as the
    reference does, instead of dropping it in silence."""
    d = str(tmp_path / "ck")
    _train(2, ckpt_dir=d)
    with pytest.warns(UserWarning, match="estimator state"):
        h = _train(3, ckpt_dir=d, resume=True, times="modeled")
    assert len(h["loss"]) == 1


def test_train_cli_checkpoint_flags(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ck = str(tmp_path / "ck")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--tp", "4", "--control", "semi", "--hetero", "static",
            "--chi", "4", "--mig-blocks", "2", "--ckpt-dir", ck,
            "--ckpt-every", "1"]
    for steps, extra in ((2, []), (3, ["--resume"])):
        out = tmp_path / f"hist{steps}.json"
        proc = subprocess.run(base + ["--steps", str(steps), "--out",
                                      str(out)] + extra,
                              capture_output=True, text=True, env=env,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    assert store.latest_step(ck) == 3
    assert len(json.loads(out.read_text())["loss"]) == 1


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_resume"))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), out,
         json.dumps(RUN), str(STEPS), str(CUT)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(out, "hist.json")) as f:
        return {"hist": json.load(f), "ck": os.path.join(out, "ck")}


def test_port_resumes_a_jax_checkpoint(reference, tmp_path):
    ref = reference["hist"]
    assert any(srcs for srcs, _ in ref["mig_shed"][CUT:])
    d = str(tmp_path / "ck")
    os.makedirs(d)
    for ext in ("npz", "json"):        # the JAX run's step-4 checkpoint
        shutil.copy(os.path.join(reference["ck"], f"ckpt_{CUT:08d}.{ext}"),
                    d)
    got = _train(STEPS, ckpt_dir=d, resume=True)
    for k in ("signatures", "buckets", "mig_shed"):
        assert got[k] == ref[k][CUT:], k
    gap = np.max(np.abs(np.asarray(got["loss"]) - ref["loss"][CUT:])
                 / np.abs(ref["loss"][CUT:]))
    print(f"largest relative loss gap over steps {CUT + 1}-{STEPS}: "
          f"{gap:.2e}")
    assert gap <= LOSS_RTOL


def test_jax_store_restores_a_port_checkpoint(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import store as jstore
    from repro.config import get_config, smoke_variant
    from repro.models import get_api
    from repro.optim import adamw as jadamw
    d = str(tmp_path / "ck")
    _train(CUT, ckpt_dir=d)
    cfg = smoke_variant(get_config("vit-1b"))
    params, _ = get_api(cfg).init(jax.random.PRNGKey(1), cfg, jnp.float32)
    opt = jadamw.init(params)
    man = jstore.read_manifest(d, CUT)
    assert man["extra"]["layout"] == jstore.TRAIN_STATE_LAYOUT
    p = jstore.load_params(d, CUT, params)
    o = jstore.restore(d, CUT, opt, prefix="opt")
    assert int(o.step) == CUT
    port = store.load_arrays(d, CUT)
    np.testing.assert_array_equal(np.asarray(p["cls"]),
                                  port["params"]["cls"])
    np.testing.assert_array_equal(
        np.asarray(o.nu["stack"]["scan"][0]["ffn"]["w_down"]),
        port["opt"]["nu"]["stack"]["scan"]["0"]["ffn"]["w_down"])
    # measured mode: the estimator's window (the SEMI controller keeps no
    # T_avg, and its priority statistics start at step 10)
    plane = jstore.load_arrays(d, CUT, "plane")
    assert set(plane) == {"estimator"}
    np.testing.assert_array_equal(plane["estimator"]["buf"],
                                  port["plane"]["estimator"]["buf"])
