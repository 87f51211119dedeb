"""Parameters between the JAX package's pytrees and this port's modules.

The JAX models keep their layers stacked: every leaf under
``params["stack"]["scan"][0]`` has a leading ``[repeat, ...]`` layer
axis, after an unstacked ``"prefix"`` list of dense first layers where
the model has one (DeepSeek-V2's). Attention leaves are GQA's (``wq``,
``wk``, ``wv``, ``wo``, biases) or MLA's (``wq``, ``w_dkv``, ``w_kr``,
``w_uk``, ``w_uv``, ``wo``); an FFN is ``ffn`` or ``moe`` (``router``,
``w_up`` / ``w_gate`` / ``w_down`` [E, ...], ``shared.*``).
:func:`params_from_jax` (the LM) and :func:`vit_params_from_jax` (ViT)
take such a tree as numpy arrays (for example
``jax.tree.map(np.asarray, params)``) and unstack it into the port's
per-layer modules; :func:`params_to_numpy` / :func:`vit_params_to_numpy`
go the other way. Norm scales stay float32, as in the reference; every
other weight takes ``dtype``. The AdamW moments mirror the parameter
tree, so :func:`adamw_state_from_jax` / :func:`adamw_state_to_numpy`
carry them the same way.

Under a ragged shard geometry the FFN pairs change layout:
:func:`expand_ffn_modules` moves a canonical model's FFN weights into the
zero-padded ragged layout in place, on their device, with the block map
of :func:`repro_torch.core.geometry.expand_ffn_params` (which does the
same to numpy trees, and whose ``restrict_ffn_params`` undoes it).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.geometry import ShardGeometry
from repro_torch.models import lm as lm_lib
from repro_torch.models import vit as vit_lib
from repro_torch.optim import adamw as adamw_lib

def _set(param: torch.nn.Parameter, value: np.ndarray, what: str) -> None:
    value = np.asarray(value)
    if tuple(param.shape) != value.shape:
        raise ValueError(f"{what}: expected shape {tuple(param.shape)}, got "
                         f"{value.shape}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(value, dtype=np.float32))
                    .to(param.dtype))


def _leaf_paths(tree, prefix=()):
    """Dotted paths of a nested dict's leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield ".".join(prefix)


def _at(tree, path: str):
    for part in path.split("."):
        tree = tree[part]
    return tree


def _load_block(blk, tree, i: int) -> None:
    """One block's parameters from its nested dict (``attn.wq``,
    ``moe.shared.w_up``, ...); the dict must hold exactly the block's
    parameters."""
    names = dict(blk.named_parameters())
    if set(names) != set(_leaf_paths(tree)):
        raise ValueError(
            f"layer {i}: the JAX tree holds {sorted(_leaf_paths(tree))}, the "
            f"port's block {sorted(names)}")
    for name, param in names.items():
        _set(param, _at(tree, name), f"layer {i} {name}")


def _load_stack(layers, stack: Dict[str, Any]) -> None:
    """The reference's ``{"prefix": [...], "scan": (group,)}`` stack (one
    repeated block per group, leaves with a leading [repeat] axis) into
    the port's per-layer blocks, in layer order."""
    prefix = list(stack.get("prefix", []))
    if set(stack) - {"prefix", "scan"} or len(stack["scan"]) != 1:
        raise ValueError("the bridge covers a dense prefix and one scanned "
                         f"layer pattern; got stack keys {sorted(stack)}")
    scan = stack["scan"][0]
    for i, blk in enumerate(layers):
        if i < len(prefix):
            tree = prefix[i]
        else:
            j = i - len(prefix)
            tree = _unstack(scan, j)
        _load_block(blk, tree, i)


def _unstack(tree, j: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]


def _arr(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _shape_of(t: torch.Tensor) -> np.ndarray:
    """A float32 array of ``t``'s shape that holds no memory (a template
    leaf: only its shape and dtype are read)."""
    return np.broadcast_to(np.float32(0), tuple(t.shape))


def _block_tree(blk, leaf=_arr) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, param in blk.named_parameters():
        *path, last = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf(param)
    return out


def _stacked(trees, stack=np.stack):
    if isinstance(trees[0], dict):
        return {k: _stacked([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)


def _stack_shapes(leaves):
    return np.broadcast_to(np.float32(0), (len(leaves),) + leaves[0].shape)


def _dump_stack(layers, num_prefix: int = 0, leaf=_arr,
                stack=np.stack) -> Dict[str, Any]:
    trees = [_block_tree(b, leaf) for b in layers]
    out: Dict[str, Any] = {"scan": (_stacked(trees[num_prefix:], stack),)}
    if num_prefix:
        out["prefix"] = trees[:num_prefix]
    return out


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda", dtype=torch.float32) -> lm_lib.LM:
    """JAX LM parameters (numpy leaves) -> the port's LM on ``device``."""
    return load_params(lm_lib.LM(cfg, dtype, device), np_tree)


def load_params(p: lm_lib.LM, np_tree: Dict[str, Any]) -> lm_lib.LM:
    """Copy JAX-layout LM parameters (numpy leaves) into ``p`` in place,
    cast to ``p``'s dtype."""
    _set(p.embed, np_tree["embed"], "embed")
    _set(p.norm_f, np_tree["norm_f"], "norm_f")
    if p.head is not None:
        _set(p.head, np_tree["head"], "head")
    _load_stack(p.layers, np_tree["stack"])
    return p


def params_to_numpy(p: lm_lib.LM) -> Dict[str, Any]:
    """The port's LM -> the JAX tree layout, as float32 numpy arrays
    (the dense prefix as a list, the repeated layers' leaves stacked on a
    leading axis)."""
    return _lm_tree(p, _arr, np.stack)


def params_template(p: lm_lib.LM) -> Dict[str, Any]:
    """:func:`params_to_numpy`'s tree with float32 leaves that hold no
    memory: the ``like`` of a checkpoint restore."""
    return _lm_tree(p, _shape_of, _stack_shapes)


def _lm_tree(p: lm_lib.LM, leaf, stack) -> Dict[str, Any]:
    out = {"embed": leaf(p.embed), "norm_f": leaf(p.norm_f),
           "stack": _dump_stack(p.layers, p.num_prefix_layers, leaf, stack)}
    if p.head is not None:
        out["head"] = leaf(p.head)
    return out


_VIT_TOP = ("patch_proj", "cls", "pos", "norm_f", "head")


def vit_params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                        device="cuda", dtype=torch.float32) -> vit_lib.ViT:
    """JAX ViT parameters (numpy leaves) -> the port's ViT on ``device``."""
    return load_vit_params(vit_lib.init(None, cfg, dtype, device), np_tree)


def load_vit_params(p: vit_lib.ViT, np_tree: Dict[str, Any]) -> vit_lib.ViT:
    """Copy JAX-layout ViT parameters (numpy leaves) into ``p`` in place."""
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


class AdamWArrays(NamedTuple):
    """The reference's ``AdamWState`` fields as numpy trees: a named tuple
    of the same field names, so a checkpoint keys it ``opt/step``,
    ``opt/mu/...``, ``opt/nu/...`` as the reference's store does."""
    step: np.ndarray
    mu: Dict[str, Any]
    nu: Dict[str, Any]


def adamw_state_to_numpy(state: adamw_lib.AdamWState,
                         cfg: ModelConfig) -> AdamWArrays:
    """The port's AdamW state of a ViT -> ``(step, mu, nu)`` in the
    reference's tree layout, as numpy arrays."""
    def tree(moments):
        m = vit_lib.init(None, cfg, torch.float32, "cpu")
        with torch.no_grad():
            for n, t in m.named_parameters():
                t.copy_(moments[n].detach().cpu())
        return vit_params_to_numpy(m)
    return AdamWArrays(np.asarray(state.step, np.int32), tree(state.mu),
                       tree(state.nu))


# ---------------------------------------------------------------------------
# Ragged shard geometry: the padded FFN layout of a torch model
# ---------------------------------------------------------------------------


def _expand_ffn_tensor(w: torch.Tensor, geo: ShardGeometry,
                       axis: int) -> torch.Tensor:
    """``w``'s ``axis`` from the canonical width to the padded layout:
    rank r's ``sizes[r]`` canonical blocks first in its slice, zero
    blocks after (``core.geometry._expand_axis`` on a torch tensor)."""
    b = geo.block
    parts = []
    for off, L in zip(geo.offsets, geo.sizes):
        parts.append(w.narrow(axis, off * b, L * b))
        if L < geo.max_blocks:
            shape = list(w.shape)
            shape[axis] = (geo.max_blocks - L) * b
            parts.append(w.new_zeros(shape))
    return torch.cat(parts, dim=axis)


def expand_ffn_modules(model, geo: ShardGeometry):
    """A canonical model's FFN pairs (its blocks' ``ffn`` of the
    geometry's width) -> the padded ragged layout, in place (an equal
    geometry changes nothing); returns ``model``."""
    if geo.is_equal:
        return model
    found = 0
    for blk in model.layers:
        ffn = getattr(blk, "ffn", None)
        if ffn is None or ffn.w_up.shape[-1] != geo.width \
                or ffn.w_down.shape[0] != geo.width:
            continue
        found += 1
        with torch.no_grad():
            for name, axis in (("w_up", -1), ("w_gate", -1), ("w_down", 0)):
                w = getattr(ffn, name)
                if w is not None:
                    setattr(ffn, name, torch.nn.Parameter(
                        _expand_ffn_tensor(w.detach(), geo, axis),
                        requires_grad=w.requires_grad))
    if not found:
        raise ValueError(
            f"no FFN pair with width {geo.width} found in params")
    return model
