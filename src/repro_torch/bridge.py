"""Parameters between the JAX package's pytrees and this port's modules.

The JAX LM keeps its layers stacked: every leaf under
``params["stack"]["scan"][0]`` has a leading ``[L, ...]`` layer axis.
:func:`params_from_jax` takes that tree as numpy arrays (for example
``jax.tree.map(np.asarray, params)``) and unstacks it into the port's
per-layer :class:`repro_torch.models.lm.LM`; :func:`params_to_numpy`
goes the other way. Norm scales stay float32, as in the reference; every
other weight takes ``dtype``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import lm as lm_lib

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


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda", dtype=torch.float32) -> lm_lib.LM:
    """JAX LM parameters (numpy leaves) -> the port's LM on ``device``."""
    p = lm_lib.LM(cfg, dtype, device)
    _set(p.embed, np_tree["embed"], "embed")
    _set(p.norm_f, np_tree["norm_f"], "norm_f")
    if p.head is not None:
        _set(p.head, np_tree["head"], "head")
    stack = np_tree["stack"]
    if set(stack) != {"scan"} or len(stack["scan"]) != 1:
        raise ValueError("params_from_jax covers the dense LM (one scanned "
                         f"layer pattern); got stack keys {sorted(stack)}")
    scan = stack["scan"][0]
    for i, blk in enumerate(p.layers):
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
    return p


def params_to_numpy(p: lm_lib.LM) -> Dict[str, Any]:
    """The port's LM -> the JAX tree layout, as float32 numpy arrays
    (layer leaves stacked on a leading [L] axis)."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    def stacked(get):
        return np.stack([arr(get(b)) for b in p.layers])

    attn = {name: stacked(lambda b, n=name: getattr(b.attn, n))
            for name in _ATTN if hasattr(p.layers[0].attn, name)}
    ffn = {name: stacked(lambda b, n=name: getattr(b.ffn, n))
           for name in _FFN if getattr(p.layers[0].ffn, name) is not None}
    out = {"embed": arr(p.embed), "norm_f": arr(p.norm_f),
           "stack": {"scan": ({"norm1": stacked(lambda b: b.norm1),
                               "norm2": stacked(lambda b: b.norm2),
                               "attn": attn, "ffn": ffn},)}}
    if p.head is not None:
        out["head"] = arr(p.head)
    return out
