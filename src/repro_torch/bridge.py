"""Parameters between the JAX package's pytrees and this port's modules.

The JAX models keep their layers stacked: every leaf under
``params["stack"]["scan"][0]`` has a leading ``[L, ...]`` layer axis.
:func:`params_from_jax` (the LM) and :func:`vit_params_from_jax` (ViT)
take such a tree as numpy arrays (for example
``jax.tree.map(np.asarray, params)``) and unstack it into the port's
per-layer modules; :func:`params_to_numpy` / :func:`vit_params_to_numpy`
go the other way. Norm scales stay float32, as in the reference; every
other weight takes ``dtype``. The AdamW moments mirror the parameter
tree, so :func:`adamw_state_from_jax` / :func:`adamw_state_to_numpy`
carry them the same way.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import lm as lm_lib
from repro_torch.models import vit as vit_lib
from repro_torch.optim import adamw as adamw_lib

_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_FFN = ("w_up", "w_down", "w_gate")


def _set(param: torch.nn.Parameter, value: np.ndarray, what: str) -> None:
    value = np.asarray(value)
    if tuple(param.shape) != value.shape:
        raise ValueError(f"{what}: expected shape {tuple(param.shape)}, got "
                         f"{value.shape}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(value, dtype=np.float32))
                    .to(param.dtype))


def _load_stack(layers, stack: Dict[str, Any]) -> None:
    if set(stack) != {"scan"} or len(stack["scan"]) != 1:
        raise ValueError("the bridge covers one scanned layer pattern; got "
                         f"stack keys {sorted(stack)}")
    scan = stack["scan"][0]
    for i, blk in enumerate(layers):
        _set(blk.norm1, scan["norm1"][i], f"layer {i} norm1")
        _set(blk.norm2, scan["norm2"][i], f"layer {i} norm2")
        for name in _ATTN:
            if name in scan["attn"]:
                _set(getattr(blk.attn, name), scan["attn"][name][i],
                     f"layer {i} attn.{name}")
        for name in _FFN:
            if name in scan["ffn"]:
                _set(getattr(blk.ffn, name), scan["ffn"][name][i],
                     f"layer {i} ffn.{name}")


def _arr(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _dump_stack(layers) -> Dict[str, Any]:
    def stacked(get):
        return np.stack([_arr(get(b)) for b in layers])

    attn = {name: stacked(lambda b, n=name: getattr(b.attn, n))
            for name in _ATTN if hasattr(layers[0].attn, name)}
    ffn = {name: stacked(lambda b, n=name: getattr(b.ffn, n))
           for name in _FFN if getattr(layers[0].ffn, name) is not None}
    return {"scan": ({"norm1": stacked(lambda b: b.norm1),
                      "norm2": stacked(lambda b: b.norm2),
                      "attn": attn, "ffn": ffn},)}


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda", dtype=torch.float32) -> lm_lib.LM:
    """JAX LM parameters (numpy leaves) -> the port's LM on ``device``."""
    p = lm_lib.LM(cfg, dtype, device)
    _set(p.embed, np_tree["embed"], "embed")
    _set(p.norm_f, np_tree["norm_f"], "norm_f")
    if p.head is not None:
        _set(p.head, np_tree["head"], "head")
    _load_stack(p.layers, np_tree["stack"])
    return p


def params_to_numpy(p: lm_lib.LM) -> Dict[str, Any]:
    """The port's LM -> the JAX tree layout, as float32 numpy arrays
    (layer leaves stacked on a leading [L] axis)."""
    out = {"embed": _arr(p.embed), "norm_f": _arr(p.norm_f),
           "stack": _dump_stack(p.layers)}
    if p.head is not None:
        out["head"] = _arr(p.head)
    return out


_VIT_TOP = ("patch_proj", "cls", "pos", "norm_f", "head")


def vit_params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                        device="cuda", dtype=torch.float32) -> vit_lib.ViT:
    """JAX ViT parameters (numpy leaves) -> the port's ViT on ``device``."""
    p = vit_lib.init(None, cfg, dtype, device)
    for name in _VIT_TOP:
        _set(getattr(p, name), np_tree[name], name)
    _load_stack(p.layers, np_tree["stack"])
    return p


def vit_params_to_numpy(p: vit_lib.ViT) -> Dict[str, Any]:
    """The port's ViT -> the JAX tree layout, as float32 numpy arrays."""
    out = {name: _arr(getattr(p, name)) for name in _VIT_TOP}
    out["stack"] = _dump_stack(p.layers)
    return out


def adamw_state_from_jax(np_state, cfg: ModelConfig,
                         device="cuda") -> adamw_lib.AdamWState:
    """The reference's ``AdamWState(step, mu, nu)`` of a ViT (numpy
    leaves; mu / nu mirror the parameter tree) -> the port's state, keyed
    by the ViT's parameter names, f32."""
    step, mu, nu = np_state

    def named(tree):
        m = vit_params_from_jax(tree, cfg, device, torch.float32)
        return {n: t.detach().clone() for n, t in m.named_parameters()}
    return adamw_lib.AdamWState(step=int(np.asarray(step)), mu=named(mu),
                                nu=named(nu))


def adamw_state_to_numpy(state: adamw_lib.AdamWState, cfg: ModelConfig):
    """The port's AdamW state of a ViT -> ``(step, mu, nu)`` in the
    reference's tree layout, as numpy arrays."""
    def tree(moments):
        m = vit_lib.init(None, cfg, torch.float32, "cpu")
        with torch.no_grad():
            for n, t in m.named_parameters():
                t.copy_(moments[n].detach().cpu())
        return vit_params_to_numpy(m)
    return (np.asarray(state.step, np.int32), tree(state.mu),
            tree(state.nu))
