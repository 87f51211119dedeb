"""Train step (port of ``repro.launch.steps.build_train_step``).

``build_train_step`` returns a callable that runs one optimizer step on
a model's parameters, in place: the forward under the plan (a
:class:`ControlContext` over the emulated TP group when a plan skeleton
is given), ``loss.backward()``, then the port's AdamW. The plan's
per-iteration part — each rank's bucket, the migration sources and the
priority lists — arrives as the ``plan`` dict, so the controller can
retarget stragglers every step; the static part (the signature) picks
which built step runs, through the control plane's
:class:`PlanCompileCache`, so the build counts keep the reference's
meaning.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.control import scopes as scopes_lib
from repro_torch.core.workload import PlanStatic
from repro_torch.layers.tp_linear import ControlContext
from repro_torch.models import vit as vit_lib
from repro_torch.optim import adamw


def make_ctx(static: PlanStatic, plan: Dict[str, Any], *,
             use_kernel: bool = False,
             psum_chunks: int = 1) -> ControlContext:
    return ControlContext(
        static=static, bucket_by_rank=plan["bucket_by_rank"],
        pri=plan.get("pri", {}), use_kernel=use_kernel,
        mig_src=plan.get("mig_src", ()), psum_chunks=psum_chunks)


def build_train_step(cfg: ModelConfig, train: TrainConfig = TrainConfig(),
                     control_static: Optional[PlanStatic] = None, *,
                     total_steps: int = 0, use_kernel: bool = False,
                     psum_chunks: int = 1):
    """Returns ``train_step(model, opt_state, batch, plan=None) ->
    (opt_state, metrics)``; the model's parameters and the optimizer
    moments are updated in place. ``metrics`` holds device scalars
    (``loss``, ``grad_norm``) and the host ``lr``."""
    if not cfg.num_classes:
        raise NotImplementedError(
            f"{cfg.name}: training a language model comes with a later "
            "slice of the port (ROADMAP.md, queue A); this slice trains "
            "the ViT classifier")
    if max(train.microbatch, 1) > 1 or train.remat != "none":
        raise NotImplementedError(
            "gradient accumulation and rematerialization are not ported")
    scopes = (scopes_lib.control_scopes(cfg, control_static)
              if control_static else {})
    if control_static and scopes:
        control_static = dataclasses.replace(
            control_static,
            scope_blocks=scopes_lib.scope_block_table(cfg, control_static))
    else:
        control_static = None

    def train_step(model, opt_state: adamw.AdamWState, batch, plan=None):
        ctx = (make_ctx(control_static, plan, use_kernel=use_kernel,
                        psum_chunks=psum_chunks)
               if control_static is not None else None)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, _ = vit_lib.loss_fn(model, cfg, batch, ctx=ctx)
        loss.backward()
        opt_state, om = adamw.apply(
            params, {n: p.grad for n, p in params.items()}, opt_state,
            train, total_steps)
        for p in params.values():
            p.grad = None
        return opt_state, {"loss": loss.detach(),
                           "grad_norm": om["grad_norm"], "lr": om["lr"]}

    return train_step


# ---------------------------------------------------------------------------
# static-analysis registration (repro_torch.analysis)
# ---------------------------------------------------------------------------

from repro_torch.analysis import registry as _analysis  # noqa: E402


def _an_control_static(e: int, spelling: str) -> PlanStatic:
    """Two spellings of the SAME canonical plan (mig_shed vs the legacy
    mig_blocks scalar) — R1 proves they build the same program, which is
    what makes the build cache's canonical-signature keying sound."""
    kw = dict(buckets=(0.0, 0.25, 0.5), block_size=8, tp_size=e)
    if spelling == "mig_shed":
        return PlanStatic(mig_shed=(2,), **kw)
    return PlanStatic(mig_blocks=2, **kw)


def _an_train_cases(env):
    import numpy as np
    import torch

    from repro_torch.config import get_config, smoke_variant
    from repro_torch.data.pipeline import PatternImageStream, patchify

    cfg = smoke_variant(get_config("vit-1b"))
    dev = torch.device(env.device)
    train = TrainConfig()
    model = vit_lib.init(torch.Generator(device=dev).manual_seed(0), cfg,
                         torch.float32, dev)
    opt = adamw.init(dict(model.named_parameters()))
    raw = next(iter(PatternImageStream(batch_size=4, seed=0)))
    batch = {"patches": torch.from_numpy(patchify(raw["images"])).to(dev),
             "labels": torch.from_numpy(np.asarray(raw["labels"])).to(dev)}
    cases = [_analysis.TraceCase(
        step="train_step", name="dense_tp1",
        fn=build_train_step(cfg, train, None, total_steps=4),
        args=(model, opt, batch, None), signature="dense_tp1")]

    # tp 4: rank 0 resized (bucket 1) and the source of a 2-block shed,
    # through the kernel wrappers; built from both spellings of the plan
    e = 4

    def build(spelling):
        st = _an_control_static(e, spelling)
        return st, build_train_step(cfg, train, st, total_steps=4,
                                    use_kernel=True)

    st_a, fn_a = build("mig_shed")
    _, fn_b = build("mig_blocks")
    plan = {"bucket_by_rank": np.asarray([1, 0, 0, 0], np.int32),
            "mig_src": np.asarray([0], np.int32),
            "pri": scopes_lib.plan_pri_arrays(
                scopes_lib.control_scopes(cfg, st_a), {}, e, device=dev)}
    args = (model, opt, batch, plan)
    cases.append(_analysis.TraceCase(
        step="train_step", name=f"controlled_tp{e}", fn=fn_a, args=args,
        signature=st_a.canonical().signature_str(),
        retrace=(("mig_blocks-spelling", fn_b, args),)))
    return cases


_analysis.register("train_step", _an_train_cases)
