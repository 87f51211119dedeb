"""AdamW with warmup-cosine schedule and global-norm clipping (port of
``repro.optim.adamw``).

The port's own update, not ``torch.optim.AdamW``: it repeats the
reference's arithmetic step for step — clipping by the global f32 norm
with ``+1e-9``, ``lr_at(state.step)`` (linear warmup, then cosine), bias
corrections at ``step + 1``, ``eps`` outside the square root, f32
moments. The state mirrors the parameters by name, so the moments of a
global TP weight are one global tensor, as in the reference.

Unlike the reference's pure ``apply``, this one updates the parameters,
the moments and the gradients IN PLACE (``torch._foreach_*`` over groups
of tensors): a step holds no second copy of the parameters or moments,
and its temporaries (the bias-corrected moments) exist for one group of
``GROUP`` tensors at a time, not for the whole model.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.config import TrainConfig

# tensors updated per foreach group: bounds the update's temporaries
GROUP = 16


class AdamWState(NamedTuple):
    step: int                        # updates applied so far (host int)
    mu: Dict[str, torch.Tensor]      # first moments, f32, keyed by name
    nu: Dict[str, torch.Tensor]      # second moments, f32


def init(params: Dict[str, torch.Tensor]) -> AdamWState:
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    return AdamWState(step=0, mu=zeros,
                      nu={n: z.clone() for n, z in zeros.items()})


def lr_at(step: int, cfg: TrainConfig, total_steps: int = 0) -> float:
    """Learning rate before update ``step`` (0-based), in f32 as the
    reference computes it."""
    f32 = np.float32
    warm = min(f32(1.0), f32(step + 1) / f32(max(cfg.warmup_steps, 1)))
    if total_steps > cfg.warmup_steps:
        prog = f32(step - cfg.warmup_steps) / f32(
            max(total_steps - cfg.warmup_steps, 1))
        prog = min(max(prog, f32(0.0)), f32(1.0))
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * prog,
                                             dtype=f32))
    else:
        cos = f32(1.0)
    return float(f32(cfg.learning_rate) * f32(warm) * f32(cos))


def apply(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          state: AdamWState, cfg: TrainConfig, total_steps: int = 0):
    """One AdamW update, in place (the gradients are scaled in place
    too). ``grads`` is keyed like ``params`` (a missing gradient counts
    as zeros). Returns (new_state, metrics) with ``grad_norm`` (device
    scalar) and ``lr``."""
    names = list(params)
    g_all = [grads[n].float() if grads.get(n) is not None
             else torch.zeros_like(params[n], dtype=torch.float32)
             for n in names]
    if cfg.grad_clip > 0:
        # the global f32 norm (a device scalar: reading it would sync)
        gnorm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(g_all, 2)))
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    else:       # no clipping: the reference reports a norm of 0
        gnorm, scale = torch.zeros((), device=g_all[0].device), None
    step = state.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    lr = lr_at(state.step, cfg, total_steps)
    f32 = np.float32
    c1 = float(f32(1.0) - f32(b1) ** f32(step))
    c2 = float(f32(1.0) - f32(b2) ** f32(step))
    with torch.no_grad():
        for lo in range(0, len(names), GROUP):
            group = names[lo:lo + GROUP]
            p_list = [params[n] for n in group]
            g_list = g_all[lo:lo + GROUP]
            m_list = [state.mu[n] for n in group]
            v_list = [state.nu[n] for n in group]
            if scale is not None:
                torch._foreach_mul_(g_list, scale)
            torch._foreach_mul_(m_list, b1)
            torch._foreach_add_(m_list, g_list, alpha=1 - b1)
            torch._foreach_mul_(v_list, b2)
            torch._foreach_addcmul_(v_list, g_list, g_list, value=1 - b2)
            # delta = (m / c1) / (sqrt(v / c2) + eps)
            denom = torch._foreach_div(v_list, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, cfg.eps)
            delta = torch._foreach_div(m_list, c1)
            torch._foreach_div_(delta, denom)
            del denom
            if cfg.weight_decay:
                torch._foreach_add_(delta, [p.float() for p in p_list],
                                    alpha=cfg.weight_decay)
            for p, d in zip(p_list, delta):
                if p.dtype == torch.float32:
                    p.sub_(d, alpha=lr)
                else:
                    p.copy_((p.float() - lr * d).to(p.dtype))
    return (AdamWState(step, state.mu, state.nu),
            {"grad_norm": gnorm, "lr": lr})
