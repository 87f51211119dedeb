"""End-to-end training driver with the SEMI-migration control loop (port
of ``repro.launch.train``).

Runs a ViT on one device with its tensor-parallel group emulated in one
process: data pipeline → train step (the workload-control plan as a
runtime input) → host-side controller (straggler detection / Eq. 1-3).
Heterogeneity is simulated as in the paper (Sec. V-A): a χ-schedule
feeds the iteration-time model, whose per-rank times drive the
controller; the bulk-synchronous step time is modeled as the max over
ranks (``modeled_step_s``), and the host wall of the real step is
reported beside it (``wall_s``).

Plan assembly, the signature-keyed build cache, mitigation dispatch and
telemetry live in :class:`repro_torch.control.ControlPlane`, with the
trainer's conventions (``controller_blocks="global"``, unclamped sheds,
``beta_policy="eq2"``).

Checkpoints carry the COMPLETE train state in the reference's layout —
params and AdamW moments + step (through :mod:`repro_torch.bridge`, in
the JAX tree's keys), controller/estimator state and the data-pipeline
position — so a run resumed with ``--resume`` is bit-identical to an
uninterrupted one, and a checkpoint of either package resumes in the
other.

``geometry`` (``--geometry``) gives the FFN a ragged static shard
geometry (:mod:`repro_torch.core.geometry`): ``"chi"`` sizes each rank's
blocks from the hetero schedule's step-0 speed ratios, ``"a,b,..."``
names them. The model then trains the padded config (rank r's slice: its
real blocks first, zero padding after, inert forward, backward and under
AdamW), initialized canonically and expanded; the iteration model prices
the canonical config; checkpoints carry the padded state and its
geometry, and a resume across geometries raises. Not in this slice:
``dp > 1``, per-layer plans (``selection="priority_diff"``) and
language-model training raise ``NotImplementedError`` naming the slice
that brings them.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 12 --tp 4 --control semi --hetero round_robin --chi 4 \\
        --mig-blocks 2 --ckpt-dir /tmp/ck --ckpt-every 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 8 --tp 4 --control semi --hetero static --chi 2 \\
        --mig-blocks 2 --geometry chi
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.config import (ModelConfig, ShapeConfig, TrainConfig,
                                get_config, smoke_variant)
from repro_torch.control import ControlConfig, ControlPlane
from repro_torch.control.plane import make_schedule
from repro_torch.core import geometry as geom_lib
from repro_torch.core import hetero as hetero_lib
from repro_torch.core.workload import WorkloadPlan
from repro_torch.data.pipeline import (PatternImageStream, eval_accuracy,
                                       patchify, skip_batches)
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.serve import resolve_device
from repro_torch.layers.blocks import LM_TRAIN_SLICE
from repro_torch.models import vit as vit_lib
from repro_torch.optim import adamw
from repro_torch.parallel import TPGroup, ragged_local_width

# batches eval_accuracy consumes per eval event (the reference's)
EVAL_BATCHES = 4

# FFN pruning granularity the trainer plans at (control_block_size adapts
# it down when d_ff/tp is small); the ragged geometry quantizes to the
# same grid so geometry block counts and plan block counts line up
TRAIN_BLOCK = 8

DP_SLICE = "the data-parallel slice (ROADMAP.md, queue A: dp > 1)"


def _scope_stats(model: vit_lib.ViT, scopes) -> Dict[str, np.ndarray]:
    """Mean-over-layers weight matrices per controlled scope: ffn ->
    w_down [d_ff, d]; qkv -> wq [d, H*hd]; attn_out -> wo [H*hd, d]
    (contraction dim first in every case), taken on the host in numpy as
    the reference takes them."""
    pick = {"ffn": lambda b: b.ffn.w_down, "qkv": lambda b: b.attn.wq,
            "attn_out": lambda b: b.attn.wo}
    out = {}
    for name, get in pick.items():
        if name in scopes:
            out[name] = np.stack([get(b).detach().float().cpu().numpy()
                                  for b in model.layers]).mean(axis=0)
    return out


def _resolve_geometry(spec: Optional[str], cfg, tp: int, *, hetero_kind: str,
                      chi: float, period: int, seed: int,
                      trace_in: Optional[str]):
    """Parse ``--geometry`` into a ShardGeometry (None = classic split).

    ``"chi"`` seeds the static split from the hetero schedule's step-0
    speed ratios (core/geometry.py geometry_from_chi — the steady-state
    χ of a static/persistent schedule); ``"a,b,..."`` gives explicit
    per-rank block counts summing to d_ff/TRAIN_BLOCK. Equal splits
    collapse to None so the geometry-free path stays bit-identical.
    """
    if spec is None or not str(spec).strip() \
            or str(spec).strip().lower() == "none":
        return None
    reason = geom_lib.geometry_unsupported_reason(cfg)
    if reason:
        raise ValueError(f"--geometry unsupported for {cfg.name}: {reason}")
    if cfg.d_ff % TRAIN_BLOCK:
        raise ValueError(
            f"--geometry needs d_ff divisible by {TRAIN_BLOCK} "
            f"(got {cfg.d_ff})")
    nb_total = cfg.d_ff // TRAIN_BLOCK
    if str(spec).strip().lower() == "chi":
        sched = make_schedule(hetero_kind, tp, chi=chi, period=period,
                              seed=seed, trace_in=trace_in)
        if sched is None:
            raise ValueError("--geometry chi needs a hetero schedule "
                             "(--hetero != none)")
        geo = geom_lib.geometry_from_schedule(sched, nb_total, TRAIN_BLOCK)
    else:
        sizes = geom_lib.parse_geometry_arg(str(spec), tp)
        geo = geom_lib.geometry_for_cfg(cfg, sizes, TRAIN_BLOCK)
    return None if geo.is_equal else geo


def run_training(arch: str, *, steps: int = 50, tp: int = 1, dp: int = 1,
                 control_mode: str = "off", hetero_kind: str = "none",
                 chi: float = 2.0, lr: float = 3e-3, batch: int = 8,
                 seq: int = 64, seed: int = 0, log_every: int = 10,
                 ckpt_dir: Optional[str] = None, resume: bool = False,
                 imputation: str = "zero", selection: str = "priority",
                 hetero_period: int = 10, mig_blocks: int = 0,
                 max_sources: int = 3,
                 eval_every: int = 0, quiet: bool = False,
                 force_gamma: Optional[float] = None,
                 data_noise: float = 0.35,
                 use_kernel: bool = False,
                 psum_chunks: int = 1,
                 times: str = "modeled",
                 trace_in: Optional[str] = None,
                 trace_out: Optional[str] = None,
                 measure_noise: float = 0.0,
                 ckpt_every: int = 50,
                 geometry: Optional[str] = None,
                 device="cuda",
                 model_cfg: Optional[ModelConfig] = None,
                 init_params: Optional[Dict[str, Any]] = None) -> Dict:
    """Train and return the history dict (the reference's keys: ``loss``,
    ``acc``, ``modeled_step_s``, ``gammas``, ``mig``, ``mig_shed``,
    ``buckets``, ``signatures``, ``wall_s``, ``plan_compiles``,
    ``plan_cache_hits``, ...).

    Beyond the reference's arguments:

    device:      where the model trains (``"cuda"`` by default; the tests
                 pass ``"cpu"``). A CUDA request without a GPU raises.
    model_cfg:   the model configuration to train, in place of the
                 reference's ``smoke_variant(get_config(arch))`` (as
                 ``ServeEngine(model_cfg=...)``), e.g. full-width ViT-1B.
    init_params: initial parameters as a numpy tree in the JAX layout
                 (``jax.tree.map(np.asarray, params)`` of the reference's
                 ViT), carried over by :mod:`repro_torch.bridge`; else the
                 weights are drawn from ``seed`` on ``device``. Under a
                 ragged ``geometry`` the tree is CANONICAL (the model's
                 true ``d_ff``, as the reference initializes it): it is
                 expanded into the padded layout here.
    """
    if dp != 1:
        raise NotImplementedError(f"dp={dp} comes with {DP_SLICE}")
    if selection == "priority_diff":
        raise NotImplementedError(
            f"per-layer plans (selection='priority_diff') come with "
            f"{LM_TRAIN_SLICE}")
    cfg = model_cfg if model_cfg is not None \
        else smoke_variant(get_config(arch))
    if not cfg.num_classes:
        raise NotImplementedError(
            f"{cfg.name}: training a language model comes with a later "
            "slice of the port (ROADMAP.md, queue A)")
    dev = resolve_device(device)
    cfg_canonical = cfg
    geo = _resolve_geometry(geometry, cfg, tp, hetero_kind=hetero_kind,
                            chi=chi, period=hetero_period, seed=seed,
                            trace_in=trace_in)
    if geo is not None:
        # static uneven sharding, realized as a zero-padded equal split:
        # the model config carries the padded d_ff; params are
        # initialized canonically and expanded below
        cfg = geom_lib.apply_geometry_cfg(cfg, geo)
        ragged_local_width(geo.padded_width, TPGroup(tp))
    train_cfg = TrainConfig(learning_rate=lr, steps=steps)
    shape = ShapeConfig("trainer", seq, batch, "train")

    control_cfg = ControlConfig(
        mode=control_mode, hetero_kind=hetero_kind, chi=chi,
        period=hetero_period, block_size=TRAIN_BLOCK,
        max_sources=max_sources, shed_cap=mig_blocks,
        # training default: Eq.(2) balances migration vs. resize cost
        beta_policy="eq2",
        imputation=imputation, selection=selection,
        use_kernel=use_kernel, psum_chunks=psum_chunks,
        seed=seed, times=times,
        trace_in=trace_in, trace_out=trace_out,
        measure_noise=measure_noise,
        geometry=geo.sizes if geo is not None else None,
    ).to_workload(
        enabled=control_mode != "off" or force_gamma is not None,
        # --mig-blocks 0 disables migration entirely; otherwise it caps
        # the per-source shed count
        migration_sources=max_sources if mig_blocks > 0 else 0)

    def _build_step(static):
        return steps_lib.build_train_step(
            cfg, train_cfg, static, total_steps=steps,
            use_kernel=control_cfg.use_kernel,
            psum_chunks=control_cfg.psum_chunks)

    # the latency model prices the CANONICAL workload — under a ragged
    # geometry the padded lanes are inert zeros, not extra FLOPs
    it_model = hetero_lib.iteration_model(cfg_canonical, shape, max(tp, 1),
                                          peak_flops=5e9, mfu=1.0)
    plane = ControlPlane(
        cfg, control_cfg, tp=tp, builder=_build_step, it_model=it_model,
        device=dev, controller_blocks="global", clamp_sheds=False,
        hetero_kind=hetero_kind, chi=chi, period=hetero_period, seed=seed,
        trace_in=trace_in, trace_out=trace_out,
        trace_meta={"arch": arch, "hetero": hetero_kind,
                    "control": control_mode, "seed": seed},
        measure_noise=measure_noise,
        geometry=geo.sizes if geo is not None else None)
    base_step = plane.base
    controller = plane.controller

    # geometry runs initialize CANONICAL params (the same draws as the
    # equal-split run) and expand them into the padded ragged layout
    if init_params is not None:
        model = bridge.vit_params_from_jax(init_params, cfg_canonical, dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = vit_lib.init(gen, cfg_canonical, torch.float32, dev)
    if geo is not None:
        bridge.expand_ffn_modules(model, geo)
    opt = adamw.init(dict(model.named_parameters()))

    # -- resume: restore the FULL train state (params + optimizer
    # moments/step + control-plane state + data position), so the resumed
    # run is equivalent to never having stopped. Legacy params-only
    # checkpoints restore what they have.
    start_step = 0
    batches_drawn = 0
    if ckpt_dir and resume:
        last = ckpt_store.latest_step(ckpt_dir)
        if last is not None:
            extra = ckpt_store.read_manifest(ckpt_dir, last).get("extra", {})
            # the checkpointed param layout is geometry-dependent —
            # resuming across geometries would silently misassign blocks
            # to ranks, so mismatches fail loudly (legacy checkpoints
            # carry no key == equal split)
            ck_geo = extra.get("geometry")
            cur_geo = list(geo.sizes) if geo is not None else None
            if (ck_geo or cur_geo) and list(ck_geo or []) != \
                    list(cur_geo or []):
                raise ValueError(
                    f"checkpoint shard geometry {ck_geo} does not "
                    f"match this run's geometry {cur_geo}; resuming "
                    "across geometries is not supported")
            full = extra.get("layout") == ckpt_store.TRAIN_STATE_LAYOUT
            bridge.load_vit_params(model, ckpt_store.restore(
                ckpt_dir, last, bridge.vit_params_to_numpy(model),
                prefix="params" if full else None))
            if full:
                opt = bridge.adamw_state_from_jax(ckpt_store.restore(
                    ckpt_dir, last, bridge.adamw_state_to_numpy(opt, cfg),
                    prefix="opt"), cfg, dev)
                plane.load_state(
                    ckpt_store.load_arrays(ckpt_dir, last, "plane"),
                    extra.get("plane"))
                start_step = int(extra.get("train_step", last))
                batches_drawn = int(extra.get("data_batches", start_step))
            else:
                start_step = batches_drawn = last

    def save_ckpt(step_now: int) -> None:
        tree = {"params": bridge.vit_params_to_numpy(model),
                "opt": bridge.adamw_state_to_numpy(opt, cfg)}
        plane_arrays = plane.state_arrays()
        if plane_arrays:
            tree["plane"] = plane_arrays
        ckpt_store.save(ckpt_dir, step_now, tree, extra={
            "layout": ckpt_store.TRAIN_STATE_LAYOUT,
            "train_step": step_now,
            "data_batches": batches_drawn,
            "plane": plane.state_meta(),
            "geometry": list(geo.sizes) if geo is not None else None,
            "arch": arch, "tp": tp, "dp": dp, "seed": seed})

    stream = iter(PatternImageStream(batch_size=batch, seed=seed,
                                     noise=data_noise))
    eval_stream = iter(PatternImageStream(batch_size=batch, seed=seed + 777,
                                          noise=data_noise))
    if batches_drawn:
        # re-align the synthetic streams with the checkpointed position
        skip_batches(stream, batches_drawn)
        if eval_every:
            skip_batches(eval_stream,
                         EVAL_BATCHES * (start_step // eval_every))

    def to_device(images, labels):
        return {"patches": torch.from_numpy(patchify(images)).to(dev),
                "labels": torch.from_numpy(np.asarray(labels)).to(dev)}

    work_frac = np.ones((tp,))
    history = {"loss": [], "acc": [], "modeled_step_s": [],
               "gammas": [], "mig": [], "mig_shed": [],
               "buckets": [], "signatures": [], "wall_s": []}

    for it in range(start_step, steps):
        chis = plane.chis(it)
        plan_arrays = None
        report = None
        plan = None
        step_fn = base_step
        if controller is not None:
            if force_gamma is not None:
                # Figs. 5/6: force a uniform γ on EVERY rank
                from repro_torch.core.workload import (PlanDynamic,
                                                       bucket_for_gamma)
                b = bucket_for_gamma(force_gamma, control_cfg.gamma_buckets)
                plan = WorkloadPlan(
                    plane.static,
                    PlanDynamic(bucket_by_rank=np.full((tp,), b, np.int32),
                                mig_src=np.array(-1, np.int32),
                                pri_lists=controller.pri_lists()))
            else:
                # the controller consumes FULL-workload-equivalent times
                plan, report = plane.decide(plane.controller_times(chis))
            step_fn, plan_arrays, _ = plane.dispatch(plan)
            work_frac = plane.work_frac(plan)

        raw = next(stream)
        batches_drawn += 1
        b = to_device(raw["images"], raw["labels"])
        plane.timer.start()
        opt, metrics = step_fn(model, opt, b, plan_arrays)
        wall = plane.timer.stop(metrics["loss"])
        loss = float(metrics["loss"])

        # modeled bulk-synchronous step time (the paper's RT metric)
        modeled = it_model.step_time(chis, work_frac)
        plane.capture(chis, work_frac, step=it, plan=plan, wall=wall)

        history["loss"].append(loss)
        history["modeled_step_s"].append(modeled)
        history["wall_s"].append(wall)
        if report is not None:
            history["gammas"].append(
                {int(k): float(v) for k, v in report.gammas.items()})
            history["mig"].append(int(report.mig_src))
            history["mig_shed"].append(
                [list(map(int, report.mig_srcs)),
                 list(map(int, report.mig_shed))])
            history["buckets"].append(
                [int(x) for x in report.bucket_by_rank])
            history["signatures"].append(plan.static.signature_str())

        if controller is not None and (it + 1) % 10 == 0:
            stats = _scope_stats(model, plane.scopes)
            if stats:
                controller.observe_weights(stats, control_cfg.block_size)

        if eval_every and (it + 1) % eval_every == 0:
            def predict(bb):
                with torch.inference_mode():
                    x = torch.from_numpy(patchify(bb["images"])).to(dev)
                    return vit_lib.forward(model, cfg, x).float().cpu()
            acc = eval_accuracy(predict, eval_stream, EVAL_BATCHES)
            history["acc"].append(acc)
            if not quiet:
                print(f"  step {it+1}: eval acc {acc:.3f}")

        if not quiet and (it + 1) % log_every == 0:
            print(f"step {it+1:4d} loss={loss:.4f} "
                  f"wall={wall*1e3:.0f}ms modeled={modeled*1e3:.1f}ms")

        if ckpt_dir and (it + 1) % max(ckpt_every, 1) == 0 \
                and (it + 1) < steps:
            save_ckpt(it + 1)

    if ckpt_dir:
        save_ckpt(steps)
    plane.close()
    history["final_loss"] = history["loss"][-1] if history["loss"] else None
    history["mean_modeled_step_s"] = float(
        np.mean(history["modeled_step_s"])) if history["modeled_step_s"] \
        else 0
    # build-cache telemetry: distinct plan signatures built vs reused
    history["plan_compiles"] = plane.cache.compile_count
    history["plan_cache_hits"] = plane.cache.hit_count
    history["times_mode"] = (control_cfg.times if control_cfg.enabled
                             else "modeled")
    if geo is not None:
        history["geometry"] = list(geo.sizes)
    if plane.estimator is not None:
        history["chi_hat"] = [float(c) for c in plane.estimator.chi_hat]
        history["estimator_rejected"] = plane.estimator.rejected_total
        history["rank_gathers"] = plane.timer.gather_count
    if plane.writer is not None:
        history["trace_out"] = trace_out
    return history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vit-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--control", default="off",
                    choices=["off", "zero", "mig", "semi"])
    ap.add_argument("--hetero", default="none",
                    choices=["none", "static", "round_robin", "contention",
                             "trace"])
    ap.add_argument("--chi", type=float, default=2.0)
    ap.add_argument("--times", default="modeled",
                    choices=["modeled", "measured"])
    ap.add_argument("--trace-in", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--measure-noise", type=float, default=0.0)
    ap.add_argument("--mig-blocks", type=int, default=0,
                    help="per-source migration shed cap; 0 disables migration")
    ap.add_argument("--geometry", default=None,
                    help="static ragged TP shard geometry: 'chi' seeds "
                         "per-rank FFN block counts from the hetero "
                         "schedule's speed ratios; 'a,b,...' gives them "
                         "explicitly (DESIGN_SHARDING.md)")
    ap.add_argument("--max-sources", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--imputation", default="zero",
                    choices=["zero", "average", "same"])
    ap.add_argument("--selection", default="priority",
                    choices=["random", "priority"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between mid-run full-state checkpoints")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="route the controlled products through the CUDA "
                         "pruned-kernel family (forward and backward)")
    ap.add_argument("--psum-chunks", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write history JSON here")
    args = ap.parse_args()

    hist = run_training(
        args.arch, steps=args.steps, tp=args.tp,
        control_mode=args.control, hetero_kind=args.hetero, chi=args.chi,
        lr=args.lr, batch=args.batch, seq=args.seq, seed=args.seed,
        ckpt_dir=args.ckpt_dir, resume=args.resume,
        imputation=args.imputation, selection=args.selection,
        mig_blocks=args.mig_blocks, max_sources=args.max_sources,
        eval_every=args.eval_every, use_kernel=args.use_kernel,
        psum_chunks=args.psum_chunks, times=args.times,
        trace_in=args.trace_in, trace_out=args.trace_out,
        measure_noise=args.measure_noise, ckpt_every=args.ckpt_every,
        geometry=args.geometry, device=args.device)
    print(f"final loss: {hist['final_loss']:.4f}  "
          f"mean modeled step: {hist['mean_modeled_step_s']*1e3:.2f} ms")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(hist, f, indent=1)


if __name__ == "__main__":
    main()
