"""The port's ServeEngine under a ragged static shard geometry, against the
JAX package's, on the CPU.

Configuration: the reference's ``TestServeTokenExact``
(``tests/test_geometry.py``): Yi-6B smoke at tp 2, ``geometry=(40, 24)``
(512 = 64 blocks of 8, padded to 2 x 40 x 8 = 640), a static χ 3
straggler, ``mode`` off and semi (the lossless β-policy), 2 slots, 3
requests. One subprocess with two host devices runs the reference
engines and saves the CANONICAL parameters with the reference's
checkpoint store; the port's engines load them through ``ckpt_dir`` and
expand them into the padded layout, as the reference's engine does.

What must hold, exactly (f32 on both sides):

* greedy tokens per request, and per step the executed and planned
  migration (``mig_srcs`` / ``mig_shed`` / ``planned_mig_srcs``),
  ``max_bucket`` and ``stragglers``, identical to the JAX engine's;
* under SEMI at least one step migrates (every shed below the smallest
  rank's 24 blocks), and the tokens equal the ``mode="off"`` run;
* the padded lanes of every FFN weight are exactly 0 after the load;
* a MoE model under a ragged geometry raises the reference's
  ``ValueError``; ``--geometry`` runs once through the port's CLI.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.control import ControlConfig
from repro_torch.launch.serve import Request, ServeEngine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = (40, 24)
CONTROL = dict(hetero_kind="static", chi=3.0, geometry=GEOMETRY)
MODES = ("off", "semi")
HIST_KEYS = ("mig_srcs", "mig_shed", "planned_mig_srcs", "max_bucket",
             "stragglers")
MOE_GEOMETRY = (3, 1)

REFERENCE = r"""
import json, sys
import numpy as np
import jax
from repro.checkpoint import store
from repro.control import ControlConfig
from repro.core import geometry as geom
from repro.launch.serve import Request, ServeEngine

out, control, modes = sys.argv[1], json.loads(sys.argv[2]), json.loads(
    sys.argv[3])
keys, moe_geo = json.loads(sys.argv[4]), tuple(json.loads(sys.argv[5]))

def mk(vocab):
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, vocab, (4,)).astype(
        np.int32), max_new_tokens=5, arrival_step=i * 2) for i in range(3)]

res = {}
for mode in modes:
    eng = ServeEngine("yi-6b", num_slots=2, max_len=10, tp=2,
                      control=ControlConfig(mode=mode, **control))
    comps = eng.run(mk(eng.cfg.vocab_size))
    eng.close()
    res[mode] = {"tokens": {str(c.uid): c.tokens.tolist() for c in comps},
                 "history": [[h.get(k) for k in keys] for h in eng.history]}
    if mode == "off":
        canon = geom.restrict_ffn_params(
            jax.tree.map(np.asarray, eng.params), eng.geometry)
        store.save(out + "/ck", 0, canon)
try:
    ServeEngine("deepseek-v2-lite-16b", num_slots=2, max_len=10, tp=2,
                control=ControlConfig(mode="semi", geometry=moe_geo))
    res["moe"] = None
except ValueError as e:
    res["moe"] = str(e)
with open(out + "/serve.json", "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_geometry_serve"))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), out,
         json.dumps(CONTROL), json.dumps(MODES), json.dumps(HIST_KEYS),
         json.dumps(MOE_GEOMETRY)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(out, "serve.json")) as f:
        res = json.load(f)
    res["ckpt"] = os.path.join(out, "ck")
    return res


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, vocab, (4,)).astype(
        np.int32), max_new_tokens=5, arrival_step=i * 2) for i in range(3)]


def _as_json(v):
    return json.loads(json.dumps(v, default=lambda o: np.asarray(o).tolist()))


def _port_run(reference, mode):
    eng = ServeEngine("yi-6b", num_slots=2, max_len=10, tp=2,
                      ckpt_dir=reference["ckpt"], device="cpu",
                      control=ControlConfig(mode=mode, **CONTROL))
    comps = eng.run(_requests(eng.cfg.vocab_size))
    eng.close()
    return eng, {str(c.uid): c.tokens.tolist() for c in comps}


@pytest.mark.parametrize("mode", MODES)
def test_geometry_engine_matches_jax(reference, mode):
    eng, tokens = _port_run(reference, mode)
    ref = reference[mode]
    assert tokens == ref["tokens"]
    hist = [[h.get(k) for k in HIST_KEYS] for h in eng.history]
    assert _as_json(hist) == ref["history"]
    assert eng.geometry.sizes == GEOMETRY
    assert eng.cfg.d_ff == 2 * max(GEOMETRY) * 8
    # the padding of every FFN weight stays exactly zero
    pad = np.ones(2 * 40, bool)
    pad[:40] = False
    pad[40:40 + 24] = False
    pad = torch.from_numpy(np.repeat(pad, 8))
    for blk in eng.params.layers:
        for w, lanes in ((blk.ffn.w_up, lambda t: t[:, pad]),
                         (blk.ffn.w_gate, lambda t: t[:, pad]),
                         (blk.ffn.w_down, lambda t: t[pad])):
            assert not lanes(w).any()
    if mode == "semi":
        migrating = [h for h in eng.history if h.get("mig_srcs")]
        assert migrating
        assert all(max(h["mig_shed"]) < min(GEOMETRY) for h in migrating)
        assert tokens == reference["off"]["tokens"]


def test_moe_geometry_raises_as_jax(reference):
    with pytest.raises(ValueError) as err:
        ServeEngine("deepseek-v2-lite-16b", num_slots=2, max_len=10, tp=2,
                    device="cpu", control=ControlConfig(
                        mode="semi", geometry=MOE_GEOMETRY))
    assert reference["moe"] is not None and str(err.value) == reference["moe"]


def test_serve_cli_geometry_on_cpu():
    # two threads, as this test process takes: other test files may run
    # beside it
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--tp", "2", "--control", "semi", "--hetero", "static", "--chi",
         "3", "--geometry", "40,24", "--requests", "2", "--gen-len", "3"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("trace counts:")
    assert int(last.split("migrating steps")[1].split(";")[0]) > 0
