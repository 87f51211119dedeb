"""The port's ServeEngine against the JAX package's, on the CPU.

Configuration: Yi-6B smoke under ZERO-resizing with a contended simulated
8-rank group, fused decode attention and the pruned-kernel paths on (the
control config of ``tests/test_decode_attn.py``'s engine test plus
``use_kernel``), at ``prefill_chunk`` 1 and 3. The port serves the JAX
engine's weights (through ``params_from_jax``); greedy tokens per uid and
the per-step ``max_bucket`` / ``stragglers`` of the controller must be
identical.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.control import ControlConfig as JControlConfig
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_jax
from repro_torch.config import get_config, smoke_variant
from repro_torch.control import ControlConfig
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Request, ServeEngine

torch.set_num_threads(1)

CONTROL = dict(mode="zero", hetero_kind="contention", chi=4.0,
               contention_p=0.15, sim_ranks=8, fused_attention=True,
               psum_chunks=2, seed=0, use_kernel=True)
SRC = str(Path(__file__).resolve().parents[1] / "src")


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(uid=i,
                prompt=rng.integers(0, vocab, (4,)).astype(np.int32),
                max_new_tokens=4, arrival_step=2 * i)
            for i in range(3)]


def _plan_trace(history):
    return [(h.get("max_bucket"), h.get("stragglers")) for h in history]


@pytest.mark.parametrize("prefill_chunk", [1, 3])
def test_engine_token_exact_against_jax(prefill_chunk):
    jeng = JServeEngine("yi-6b", num_slots=2, max_len=16, seed=0,
                        control=JControlConfig(**CONTROL),
                        prefill_chunk=prefill_chunk)
    jcomps = jeng.run(_requests(JRequest, jeng.cfg.vocab_size))
    jeng.close()

    tops.reset_launch_counts()
    teng = ServeEngine("yi-6b", num_slots=2, max_len=16, seed=0,
                       control=ControlConfig(**CONTROL),
                       prefill_chunk=prefill_chunk, device="cpu")
    teng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                  teng.cfg, device="cpu")
    tcomps = teng.run(_requests(Request, teng.cfg.vocab_size))
    teng.close()

    assert {c.uid: c.tokens.tolist() for c in tcomps} == \
        {c.uid: c.tokens.tolist() for c in jcomps}
    assert _plan_trace(teng.history) == _plan_trace(jeng.history)
    # the contended rank really resized: both kernel paths ran pruned
    assert max(h["max_bucket"] for h in teng.history) > 0
    # modeled clocks follow the same plans
    np.testing.assert_allclose([h["latency_s"] for h in teng.history],
                               [h["latency_s"] for h in jeng.history],
                               rtol=1e-12)
    assert teng.plane.counts() == jeng.plane.counts()
    # on the CPU the wrappers ran their plain versions, never a kernel
    assert set(tops.launch_counts().values()) == {0}


def test_engine_api_on_cpu():
    eng = ServeEngine("yi-6b", num_slots=2, max_len=12, device="cpu",
                      control=ControlConfig(mode="zero",
                                            hetero_kind="contention",
                                            sim_ranks=8, use_kernel=True,
                                            fused_attention=True),
                      prefill_chunk=2, max_queue=1)
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(0, 512, (3,)).astype(np.int32),
                    max_new_tokens=2) for i in range(2)]
    assert eng.try_submit(reqs[0])
    assert not eng.try_submit(reqs[1])            # bounded queue
    assert not eng.try_submit(Request(uid=9, prompt=np.zeros(11, np.int32),
                                      max_new_tokens=2))   # never fits
    assert eng.request_cost_steps(3, 2) == 4
    snap = eng.load_snapshot()
    assert snap.queue_depth == 1 and snap.free_slots == 2
    assert snap.backlog_steps == 4
    while not eng.idle:
        eng.tick()
    assert [c.uid for c in eng.completions] == [0]
    assert len(eng.completions[0].tokens) == 2
    idle = eng.tick()
    assert idle["idle"] and eng.active_requests() == []
    assert eng.evict_queue() == []
    stats = tserve.latency_percentiles(eng.completions)
    assert stats["tokens"] == 2
    assert tserve.latency_percentiles([]) == tserve.EMPTY_LATENCY_STATS
    eng.close()


@pytest.mark.parametrize("kwargs", [
    dict(model_cfg=smoke_variant(get_config("falcon-mamba-7b"))),
    dict(model_cfg=smoke_variant(get_config("recurrentgemma-2b"))),
    dict(model_cfg=smoke_variant(get_config("qwen2-vl-7b"))),
    dict(tp=4, control=ControlConfig(mode="semi", selection="priority_diff")),
    dict(control=ControlConfig(selection="priority_diff")),
])
def test_unsupported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="slice"):
        ServeEngine("yi-6b", num_slots=2, max_len=8, device="cpu", **kwargs)


def _outcome(make, act):
    """("ok", act(engine)) or (exception type name, message)."""
    try:
        eng = make()
        try:
            return "ok", act(eng)
        finally:
            eng.close()
    except (ValueError, RuntimeError, NotImplementedError) as e:
        return type(e).__name__, str(e)


def _never_fits_the_pool(eng):
    # fits max_len 16, but needs 4 pages of a 2-page pool: refused, and
    # nothing is queued
    ok = eng.try_submit(Request(uid=0, prompt=np.ones(6, np.int32),
                                max_new_tokens=8))
    return ok, len(eng.queue)


def _past_max_len(eng):
    eng.submit(Request(uid=0, prompt=np.ones(12, np.int32),
                       max_new_tokens=8))


@pytest.mark.parametrize("case", [
    "kv_int8_without_pages", "kv_int8_with_fused_kernel",
    "fused_page_size_not_multiple_of_8", "pool_over_capacity",
    "past_max_len_on_paged_engine"])
def test_paged_options_follow_the_reference(case):
    """The paging options raise (or refuse) as the reference's engine
    does, given the same arguments."""
    fused = dict(fused_attention=True)
    kw, act = {
        "kv_int8_without_pages": (dict(kv_int8=True), None),
        "kv_int8_with_fused_kernel": (
            dict(page_size=8, kv_int8=True, control=fused), None),
        "fused_page_size_not_multiple_of_8": (
            dict(page_size=4, control=fused), None),
        "pool_over_capacity": (dict(page_size=4, num_pages=2),
                               _never_fits_the_pool),
        "past_max_len_on_paged_engine": (dict(page_size=4), _past_max_len),
    }[case]
    ctl = kw.pop("control", None)

    def make(engine_cls, control_cls, **extra):
        return lambda: engine_cls(
            "yi-6b", num_slots=2, max_len=16, seed=0,
            control=None if ctl is None else control_cls(**ctl), **kw,
            **extra)

    act = act or (lambda eng: None)
    ref = _outcome(make(JServeEngine, JControlConfig), act)
    got = _outcome(make(ServeEngine, ControlConfig, device="cpu"), act)
    assert got == ref
    if case == "pool_over_capacity":
        assert ref == ("ok", (False, 0))
    else:
        assert ref[0] == "ValueError"


def test_cuda_request_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the engine would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine("yi-6b", num_slots=2, max_len=8)


def test_cli_runs_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--control", "zero", "--hetero",
                 "contention", "--sim-ranks", "8", "--use-kernel",
                 "--fused-attn", "--requests", "2", "--prompt-len", "3",
                 "--gen-len", "2", "--prefill-chunk", "2"])
    out = capsys.readouterr().out
    assert "2 requests, 4 tokens" in out


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, json\n"
            "import repro_torch.launch.serve, repro_torch.bridge\n"
            "import repro_torch.launch.train, repro_torch.models.vit\n"
            "import repro_torch.parallel, repro_torch.kernels.ops\n"
            "import repro_torch.layers.moe\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_analysis_imports_neither_jax_nor_repro():
    # the analyzer package, its engine and rules, and every provider it
    # loads (the port's train and serve drivers, the micro probes)
    code = ("import sys, json\n"
            "import repro_torch.analysis as an\n"
            "from repro_torch.analysis import engine, rules, smem, mutants\n"
            "names = an.load_providers()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(json.dumps([bad, names]))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": SRC})
    bad, names = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    assert {"train_step", "serve_decode_step", "serve_engine_step",
            "micro_collective", "micro_kernel"} <= set(names)
