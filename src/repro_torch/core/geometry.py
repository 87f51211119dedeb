"""First-class ragged shard geometry (port of ``repro.core.geometry``,
DESIGN_SHARDING.md; a copy, numpy only, that imports nothing of the
reference).

The paper corrects heterogeneity purely *dynamically* on top of equal TP
shards. Persistent speed ratios (mixed accelerator generations, not
contention spikes) are better absorbed by statically unequal shards sized
from measured throughput — Cephalo / Poplar style — leaving ZERO/SEMI to
handle only the transient residual. This module makes that static shard
split a first-class object:

    ShardGeometry(sizes=(12, 12, 4, 4), block=8)

meaning rank r statically owns ``sizes[r]`` of the FFN's
``sum(sizes)`` controlled blocks (a *redistribution* of the canonical
width — nothing is pruned by the geometry itself).

Physical layout — padded equal split
------------------------------------
Every rank keeps one equal, static buffer shape (the reference's GSPMD
split; here :class:`repro_torch.parallel.TPGroup`'s equal views). A
ragged geometry is realized as a **padded** layout: the FFN hidden width
is padded to

    Hp = tp · max(sizes) · block

and equal-split as usual; rank r's local slice holds its ``sizes[r]``
real blocks *first* and zero blocks after. Zero padding is numerically
inert in both directions and self-sustaining under AdamW-style updates:

* forward: padded w_up/w_gate columns are zero ⇒ h_pad = 0; padded
  w_down rows are zero ⇒ they contribute nothing to y;
* backward: dL/dh_pad = dy @ w_down[pad,:]^T = 0 ⇒ w_up/w_gate padding
  gradients are 0; h_pad = 0 ⇒ w_down padding gradients are 0;
* update: lr·(0 + weight_decay·0) = 0 — padding stays exactly zero.

An *equal* geometry therefore has zero padding and is byte-identical to
the implicit ``H // tp`` split — callers normalize it away (see
``PlanStatic.canonical``) so equal-geometry runs reproduce the pinned
equal-shard trajectories bit-for-bit.

The controlled path (layers/tp_linear.py) executes only the ``sizes[r]``
real blocks per rank (per-size-class branch tables), so an uneven
geometry is a genuine static FLOP rebalance, not just masking.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardGeometry:
    """Static per-rank FFN block counts for a ragged TP split.

    sizes: per-rank counts of *controlled blocks* (``block`` lanes each);
      ``sum(sizes)`` is the model's canonical total (d_ff // block).
    block: lanes per controlled block (= the control-plane block size for
      the "ffn" scope).
    """

    sizes: Tuple[int, ...]
    block: int

    def __post_init__(self):
        sizes = tuple(int(s) for s in self.sizes)
        object.__setattr__(self, "sizes", sizes)
        if not sizes:
            raise ValueError("ShardGeometry needs at least one rank")
        if any(s < 1 for s in sizes):
            raise ValueError(
                f"every rank needs >= 1 block, got sizes={sizes}")
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")

    # -- shape arithmetic ---------------------------------------------------
    @property
    def tp(self) -> int:
        return len(self.sizes)

    @property
    def total_blocks(self) -> int:
        """Canonical (unpadded) block count: d_ff // block."""
        return sum(self.sizes)

    @property
    def max_blocks(self) -> int:
        """Per-rank padded local block count (every rank's buffer size)."""
        return max(self.sizes)

    @property
    def min_blocks(self) -> int:
        return min(self.sizes)

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Start of each rank's slice in canonical (global) block ids."""
        out, acc = [], 0
        for s in self.sizes:
            out.append(acc)
            acc += s
        return tuple(out)

    @property
    def padded_blocks(self) -> int:
        """Global block count of the padded layout: tp · max_blocks."""
        return self.tp * self.max_blocks

    @property
    def padded_width(self) -> int:
        """Padded FFN hidden width Hp (what cfg.d_ff becomes)."""
        return self.padded_blocks * self.block

    @property
    def width(self) -> int:
        """Canonical FFN hidden width (the model's true d_ff)."""
        return self.total_blocks * self.block

    @property
    def is_equal(self) -> bool:
        return len(set(self.sizes)) == 1

    def rank_of_block(self, g: int) -> int:
        """Owning rank of canonical global block id ``g``."""
        if not 0 <= g < self.total_blocks:
            raise ValueError(f"block {g} outside [0, {self.total_blocks})")
        for r, (off, s) in enumerate(zip(self.offsets, self.sizes)):
            if off <= g < off + s:
                return r
        raise AssertionError("unreachable")

    def describe(self) -> str:
        return (f"geometry tp={self.tp} sizes={list(self.sizes)} "
                f"block={self.block} width={self.width} "
                f"padded={self.padded_width}")


def equal_geometry(total_blocks: int, tp: int, block: int) -> ShardGeometry:
    """The canonical equal split as a ShardGeometry (zero padding)."""
    if total_blocks % tp:
        raise ValueError(f"{total_blocks} blocks do not equal-split over "
                         f"tp={tp}")
    return ShardGeometry(sizes=(total_blocks // tp,) * tp, block=block)


def geometry_from_chi(chis: Sequence[float], total_blocks: int, block: int,
                      *, chi_quantum: float = 0.25,
                      min_blocks: int = 1) -> ShardGeometry:
    """Size static shards inversely to steady-state slowdown χ̂.

    Rank r's matmul runs χ_r× slower than nominal, so give it ∝ 1/χ_r of
    the blocks: per-rank matmul time M·(L_r/L_eq)·χ_r equalizes across
    ranks. Two stability measures keep ``PlanCompileCache`` signatures
    from churning on estimator noise:

    * χ̂ is first snapped to a coarse grid (``chi_quantum``) — small χ̂
      drift maps to the same geometry;
    * block counts are integerized by largest-remainder apportionment so
      they sum *exactly* to ``total_blocks`` (the geometry redistributes,
      never prunes).
    """
    x = np.asarray(chis, np.float64)
    if x.ndim != 1 or x.size < 1:
        raise ValueError("chis must be a non-empty 1-D sequence")
    if np.any(~np.isfinite(x)) or np.any(x <= 0):
        raise ValueError(f"chis must be positive and finite, got {chis}")
    tp = int(x.size)
    if total_blocks < tp * min_blocks:
        raise ValueError(
            f"{total_blocks} blocks cannot give {tp} ranks "
            f">= {min_blocks} each")
    q = max(float(chi_quantum), 1e-6)
    # snap to the grid, never below nominal speed
    xq = np.maximum(np.round(x / q) * q, 1.0)
    share = (1.0 / xq) / (1.0 / xq).sum()
    ideal = share * total_blocks
    sizes = np.maximum(np.floor(ideal).astype(np.int64), min_blocks)
    # largest-remainder: hand out the residual blocks to the largest
    # fractional parts (ties broken by rank id — deterministic)
    rem = int(total_blocks - sizes.sum())
    if rem > 0:
        frac = ideal - np.floor(ideal)
        order = np.lexsort((np.arange(tp), -frac))
        for k in range(rem):
            sizes[order[k % tp]] += 1
    elif rem < 0:
        # min_blocks clamping overshot: take blocks back from the largest
        order = np.argsort(-sizes, kind="stable")
        i = 0
        while rem < 0:
            r = order[i % tp]
            if sizes[r] > min_blocks:
                sizes[r] -= 1
                rem += 1
            i += 1
    return ShardGeometry(sizes=tuple(int(s) for s in sizes), block=block)


# ---------------------------------------------------------------------------
# Config plumbing: canonical cfg -> padded cfg
# ---------------------------------------------------------------------------


def geometry_unsupported_reason(model_cfg) -> Optional[str]:
    """Why a ragged geometry cannot apply to this architecture (or None).

    The geometry redistributes the dense-FFN controlled scope; MoE expert
    widths and SSM inner widths have their own sharding stories and stay
    equal-split.
    """
    if getattr(model_cfg, "family", None) == "ssm":
        return "ssm family has no dense FFN controlled scope"
    if getattr(model_cfg, "moe", None) is not None:
        return "MoE expert widths stay equal-split (no ragged geometry)"
    return None


def geometry_for_cfg(model_cfg, sizes: Sequence[int],
                     block: int) -> ShardGeometry:
    """Validate per-rank block counts against a model config's d_ff."""
    reason = geometry_unsupported_reason(model_cfg)
    if reason is not None:
        raise ValueError(f"{model_cfg.name}: {reason}")
    geo = ShardGeometry(sizes=tuple(sizes), block=block)
    if geo.width != model_cfg.d_ff:
        raise ValueError(
            f"geometry covers width {geo.width} "
            f"({geo.total_blocks} x {block}) but {model_cfg.name} has "
            f"d_ff={model_cfg.d_ff}")
    return geo


def apply_geometry_cfg(model_cfg, geo: ShardGeometry):
    """Return the padded model config the ragged run actually compiles.

    Only ``d_ff`` changes (canonical width -> padded width); every other
    field — and therefore every non-FFN parameter shape — is untouched.
    Equal geometries pad nothing and return the config unchanged, so the
    equal case stays on the exact baseline code path.
    """
    reason = geometry_unsupported_reason(model_cfg)
    if reason is not None:
        raise ValueError(f"{model_cfg.name}: {reason}")
    if geo.width != model_cfg.d_ff:
        raise ValueError(
            f"geometry width {geo.width} != d_ff {model_cfg.d_ff}")
    if geo.is_equal:
        return model_cfg
    return dataclasses.replace(model_cfg, d_ff=geo.padded_width)


# ---------------------------------------------------------------------------
# Parameter layout transforms: canonical <-> padded
# ---------------------------------------------------------------------------


def _is_ffn_pair(d: dict, width: int) -> bool:
    wu = d.get("w_up")
    wd = d.get("w_down")
    return (hasattr(wu, "shape") and hasattr(wd, "shape")
            and wu.shape[-1] == width and wd.shape[-2] == width)


def _expand_axis(w, geo: ShardGeometry, axis: int):
    """Reorder+pad one array axis from canonical to padded layout.

    Canonical blocks [off_r, off_r + sizes[r]) land at rank r's local
    slots [0, sizes[r]); slots [sizes[r], max_blocks) are zero padding.
    Runs in numpy — this is a host-side load/save transform (the launchers
    move torch modules with the same block map,
    :func:`repro_torch.bridge.expand_ffn_modules`).
    """
    w = np.asarray(w)
    axis = axis % w.ndim
    shp = w.shape
    nb, b = geo.total_blocks, geo.block
    if shp[axis] != nb * b:
        raise ValueError(f"axis {axis} has {shp[axis]} lanes, geometry "
                         f"covers {nb * b}")
    blocks = np.reshape(w, shp[:axis] + (nb, b) + shp[axis + 1:])
    parts = []
    for off, L in zip(geo.offsets, geo.sizes):
        mine = np.take(blocks, np.arange(off, off + L), axis=axis)
        pad = geo.max_blocks - L
        if pad:
            pshape = list(mine.shape)
            pshape[axis] = pad
            mine = np.concatenate(
                [mine, np.zeros(pshape, w.dtype)], axis=axis)
        parts.append(mine)
    out = np.concatenate(parts, axis=axis)
    return np.reshape(out, shp[:axis] + (geo.padded_width,) + shp[axis + 1:])


def _restrict_axis(w, geo: ShardGeometry, axis: int):
    """Inverse of :func:`_expand_axis`: drop padding, restore canonical order."""
    w = np.asarray(w)
    axis = axis % w.ndim
    shp = w.shape
    if shp[axis] != geo.padded_width:
        raise ValueError(f"axis {axis} has {shp[axis]} lanes, padded layout "
                         f"has {geo.padded_width}")
    blocks = np.reshape(
        w, shp[:axis] + (geo.padded_blocks, geo.block) + shp[axis + 1:])
    ids = []
    for r, (off, L) in enumerate(zip(geo.offsets, geo.sizes)):
        ids.extend(range(r * geo.max_blocks, r * geo.max_blocks + L))
    out = np.take(blocks, np.asarray(ids), axis=axis)
    return np.reshape(out, shp[:axis] + (geo.width,) + shp[axis + 1:])


def _map_ffn_params(params, width: int, fn_up, fn_down):
    """Apply (fn_up, fn_down) to every FFN pair dict in a param pytree.

    Matches dicts holding ``w_up``/``w_down`` whose widths equal ``width``
    on the last / second-to-last axis (leading scan-layer dims pass
    through untouched). Returns (new_params, pairs_found).
    """
    found = 0

    def walk(node):
        nonlocal found
        if isinstance(node, dict):
            if _is_ffn_pair(node, width):
                found += 1
                out = dict(node)
                out["w_up"] = fn_up(node["w_up"])
                out["w_down"] = fn_down(node["w_down"])
                if node.get("w_gate") is not None:
                    out["w_gate"] = fn_up(node["w_gate"])
                for k, v in node.items():
                    if k not in ("w_up", "w_down", "w_gate"):
                        out[k] = walk(v)
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params), found


def expand_ffn_params(params, geo: ShardGeometry):
    """Canonical param tree -> padded ragged-layout tree.

    Initialize under the *canonical* config, then expand: the uneven run
    trains exactly the canonical parameters (plus inert zero padding), so
    it corresponds 1:1 to an equal-shard run of the same model.
    """
    if geo.is_equal:
        return params
    out, found = _map_ffn_params(
        params, geo.width,
        lambda w: _expand_axis(w, geo, -1),
        lambda w: _restrict_or_expand_down(w, geo, expand=True))
    if not found:
        raise ValueError(
            f"no FFN pair with width {geo.width} found in params")
    return out


def restrict_ffn_params(params, geo: ShardGeometry):
    """Padded ragged-layout tree -> canonical tree (for export/eval)."""
    if geo.is_equal:
        return params
    out, found = _map_ffn_params(
        params, geo.padded_width,
        lambda w: _restrict_axis(w, geo, -1),
        lambda w: _restrict_or_expand_down(w, geo, expand=False))
    if not found:
        raise ValueError(
            f"no FFN pair with padded width {geo.padded_width} in params")
    return out


def _restrict_or_expand_down(w, geo: ShardGeometry, *, expand: bool):
    return (_expand_axis(w, geo, -2) if expand
            else _restrict_axis(w, geo, -2))


# ---------------------------------------------------------------------------
# Parsing / seeding helpers for the launchers
# ---------------------------------------------------------------------------


def parse_geometry_arg(spec: str, tp: int) -> Optional[Tuple[int, ...]]:
    """Parse a CLI ``--geometry`` value.

    ``"none"``/empty -> None; ``"12,12,4,4"`` -> explicit per-rank block
    counts (must have ``tp`` entries).
    """
    s = (spec or "").strip().lower()
    if s in ("", "none", "off"):
        return None
    try:
        sizes = tuple(int(v) for v in s.split(","))
    except ValueError as e:
        raise ValueError(f"--geometry {spec!r}: expected comma-separated "
                         f"per-rank block counts") from e
    if len(sizes) != tp:
        raise ValueError(f"--geometry has {len(sizes)} entries, tp={tp}")
    return sizes


def geometry_from_schedule(schedule, total_blocks: int, block: int,
                           *, step: int = 0,
                           chi_quantum: float = 0.25) -> ShardGeometry:
    """Chi-seed a geometry from a HeteroSchedule's steady state.

    The honest closed-loop path seeds from ``StragglerEstimator.chi_hat``
    once its warmup gate opens (see ``geometry_from_chi``); this helper is
    the modeled-times shortcut the launchers use when the persistent speed
    ratio is declared up front (``--hetero static``).
    """
    return geometry_from_chi(schedule.chi(step), total_blocks, block,
                             chi_quantum=chi_quantum)


def blocks_for_width(width: int, block: int) -> int:
    if width % block:
        raise ValueError(f"width {width} not divisible by block {block}")
    return width // block


def validate_even_padding(geo: ShardGeometry, tp: int) -> None:
    """The padded width must equal-split over the mesh TP axis."""
    if geo.tp != tp:
        raise ValueError(f"geometry has {geo.tp} ranks, mesh TP axis {tp}")
    if geo.padded_width % tp:
        raise AssertionError(
            f"padded width {geo.padded_width} not divisible by tp={tp}")


__all__ = [
    "ShardGeometry", "equal_geometry", "geometry_from_chi",
    "geometry_from_schedule", "geometry_for_cfg", "apply_geometry_cfg",
    "geometry_unsupported_reason", "expand_ffn_params",
    "restrict_ffn_params", "parse_geometry_arg", "blocks_for_width",
    "validate_even_padding",
]
